// W8A8 per-tensor-static matmul: int8 x int8 -> int32, f32 epilogue.
//
// Replaces: src/repro/kernels/w8a8_matmul.py `w8a8_matmul` (Pallas
// `_kernel`), reached from core/quantization.py `_int8_matmul` at every
// qlinear site (qkv, o, mlp up/gate, down) and the tied head.
//
//   out[m, n] = (float(acc[m, n]) - z * float(colsum[n])) * (s_x * s_w)
//   acc = x_int @ w_int (int32),  z = z_x + z_shift
//
// Bound on the card: at decode (M = batch = 4) bytes — every weight byte is
// streamed once per step and each byte feeds only M multiply-adds; at
// prefill (M = 4 * 512) operations. Design: one block per (BM x BN) output
// tile; the K loop stages an int8 A tile (row-major) and a B tile transposed
// to n-major in shared memory, so that four consecutive k of one column form
// one 32-bit word, and each thread accumulates a TM x TN sub-tile with
// __dp4a into int32. Small M takes a 16-row tile and narrow columns so the
// weight stream spreads over more blocks; larger M a 64 x 64 tile. Ragged M
// and N are masked at load and store; K must be a multiple of 4 (checked by
// the wrapper). Tensor-core MMA, TMA and split-K are left for later work.
//
// Exactness: the epilogue rounds each step on its own (__fmul_rn, __fsub_rn,
// never a fused multiply-add), in the order above with s_x * s_w formed
// first, matching the plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
w8a8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            const int* __restrict__ colsum, const float* __restrict__ sx,
            const float* __restrict__ zx, const float* __restrict__ sw,
            float z_shift, void* __restrict__ out, int out_bf16, int M, int N,
            int K) {
  constexpr int CT = BN / TN;              // threads along n
  constexpr int RT = BM / TM;              // threads along m
  constexpr int NT = CT * RT;
  constexpr int KW = BK / 4;               // 32-bit words per staged row
  constexpr int LD = KW + 1;               // padded row stride (words)
  __shared__ int As[BM * LD];
  __shared__ int Bs[BN * LD];
  int8_t* bsb = reinterpret_cast<int8_t*>(Bs);

  const int tid = threadIdx.x;
  const int tx = tid % CT, ty = tid / CT;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  const bool n_vec = (N % 4) == 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * KW; i += NT) {
      const int r = i / KW, c = i % KW;
      const int m = m0 + r, k = k0 + 4 * c;
      int v = 0;
      if (m < M && k < K)
        v = *reinterpret_cast<const int*>(x + (size_t)m * K + k);
      As[r * LD + c] = v;
    }
    for (int i = tid; i < BK * (BN / 4); i += NT) {
      const int kr = i / (BN / 4), c4 = i % (BN / 4);
      const int k = k0 + kr, n = n0 + 4 * c4;
      char4 v = make_char4(0, 0, 0, 0);
      if (k < K) {
        const int8_t* src = w + (size_t)k * N + n;
        if (n_vec && n + 3 < N) {
          v = *reinterpret_cast<const char4*>(src);
        } else {
          if (n + 0 < N) v.x = src[0];
          if (n + 1 < N) v.y = src[1];
          if (n + 2 < N) v.z = src[2];
          if (n + 3 < N) v.w = src[3];
        }
      }
      const int nb = 4 * c4;
      bsb[(nb + 0) * LD * 4 + kr] = v.x;
      bsb[(nb + 1) * LD * 4 + kr] = v.y;
      bsb[(nb + 2) * LD * 4 + kr] = v.z;
      bsb[(nb + 3) * LD * 4 + kr] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[(ty + i * RT) * LD + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[(tx + j * CT) * LD + kk];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float sxsw = __fmul_rn(*sx, *sw);
  const float z = __fadd_rn(*zx, z_shift);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * RT;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * CT;
      if (n >= N) continue;
      const float r = __fmul_rn(
          __fsub_rn(__int2float_rn(acc[i][j]),
                    __fmul_rn(z, __int2float_rn(colsum[n]))),
          sxsw);
      if (out_bf16)
        reinterpret_cast<__nv_bfloat16*>(out)[(size_t)m * N + n] =
            __float2bfloat16_rn(r);
      else
        reinterpret_cast<float*>(out)[(size_t)m * N + n] = r;
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
static void launch(const void* x, const void* w, const void* colsum,
                   const void* sx, const void* zx, const void* sw,
                   float z_shift, void* out, int out_bf16, int M, int N, int K,
                   cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  w8a8_kernel<BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, st>>>(
      (const int8_t*)x, (const int8_t*)w, (const int*)colsum,
      (const float*)sx, (const float*)zx, (const float*)sw, z_shift, out,
      out_bf16, M, N, K);
}

extern "C" int w8a8_matmul_launch(const void* x, const void* w,
                                  const void* colsum, const void* sx,
                                  const void* zx, const void* sw,
                                  float z_shift, void* out, int out_bf16,
                                  int M, int N, int K, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 16)
    launch<16, 32, 64, 1, 2>(x, w, colsum, sx, zx, sw, z_shift, out, out_bf16,
                             M, N, K, st);
  else
    launch<64, 64, 32, 4, 4>(x, w, colsum, sx, zx, sw, z_shift, out, out_bf16,
                             M, N, K, st);
  return (int)cudaGetLastError();
}
