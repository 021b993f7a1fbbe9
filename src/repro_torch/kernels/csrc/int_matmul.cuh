// The mainloop that the two int8-activation matmuls share (w8a8_matmul.cu,
// w4a8_matmul.cu).
//
// One block per BM x BN output tile. The K loop stages an int8 A tile
// (row-major) and a B tile transposed to n-major in shared memory, so that
// four consecutive k of one column form one 32-bit word, and each thread
// accumulates a TM x TN sub-tile with __dp4a into int32. The K loop is
// nested in a loop over the weight's groups along K (W8A8: one group of K);
// each staged chunk lies inside one group. Small M takes a 16-row tile and
// narrow columns so the weight stream spreads over more blocks; larger M a
// 64 x 64 tile. Ragged M and N are masked at load and store; K and the group
// must be multiples of 4 (checked by the wrappers). Tensor-core MMA, TMA and
// split-K are left for later work.
//
// PACKED picks the two parts that differ:
//   B tile:   int8 rows (W8A8), or int4 nibble pairs that are sign-extended
//             in registers while the tile is staged (W4A8: byte p of column
//             n holds w[2p, n] low and w[2p+1, n] high);
//   epilogue: W8A8 dequantizes the int32 sum once with scalar scales,
//             (acc - z * colsum) * (s_x * s_w); W4A8 converts each group's
//             exact int32 partial to f32 and adds it, times the group's
//             scale, in group order, then (acc - z * colsum_scaled) * s_x.
// Every f32 step rounds on its own (__fmul_rn, __fadd_rn, __fsub_rn, never
// a fused multiply-add), matching the plain PyTorch versions bit for bit.
// Never built with --use_fast_math.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// sign-extend a 4-bit field held in the low bits of v
static __device__ __forceinline__ int sext4(unsigned v) {
  return (int)((v & 0xFu) ^ 8u) - 8;
}

// W8A8: sw one f32 scalar, colsum int32 (N,). W4A8: sw f32 (K / group, N),
// colsum f32 (N,), the scale-weighted column sums.
template <bool PACKED, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
int_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ sw,
                  const void* __restrict__ colsum,
                  const float* __restrict__ sx, const float* __restrict__ zx,
                  float z_shift, void* __restrict__ out, int out_bf16, int M,
                  int N, int K, int group) {
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
  float facc[TM][TN];                      // W4A8: the finished groups
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0;
      facc[i][j] = 0.0f;
    }

  const bool n_vec = (N % 4) == 0;
  for (int g0 = 0; g0 < K; g0 += group) {
    const int g1 = g0 + group;
    for (int k0 = g0; k0 < g1; k0 += BK) {
      const int kend = min(k0 + BK, g1);
      for (int i = tid; i < BM * KW; i += NT) {
        const int r = i / KW, c = i % KW;
        const int m = m0 + r, k = k0 + 4 * c;
        int v = 0;
        if (m < M && k < kend)
          v = *reinterpret_cast<const int*>(x + (size_t)m * K + k);
        As[r * LD + c] = v;
      }
      if constexpr (PACKED) {
        // packed rows k0/2 .. (k0 + BK)/2, four columns (one word) per item
        for (int i = tid; i < (BK / 2) * (BN / 4); i += NT) {
          const int pr = i / (BN / 4), c4 = i % (BN / 4);
          const int k = k0 + 2 * pr, n = n0 + 4 * c4;
          unsigned word = 0;
          if (k < kend) {
            const int8_t* src = w + (size_t)(k / 2) * N + n;
            if (n_vec && n + 3 < N) {
              word = *reinterpret_cast<const unsigned*>(src);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (n + j < N) word |= (unsigned)(uint8_t)src[j] << (8 * j);
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const unsigned b = word >> (8 * j);
            int8_t* dst = bsb + (4 * c4 + j) * LD * 4 + 2 * pr;
            dst[0] = (int8_t)sext4(b);          // element k: low nibble
            dst[1] = (int8_t)sext4(b >> 4);     // element k + 1: high nibble
          }
        }
      } else {
        for (int i = tid; i < BK * (BN / 4); i += NT) {
          const int kr = i / (BN / 4), c4 = i % (BN / 4);
          const int k = k0 + kr, n = n0 + 4 * c4;
          char4 v = make_char4(0, 0, 0, 0);
          if (k < kend) {
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
          for (int j = 0; j < TN; ++j)
            acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    if constexpr (PACKED) {
      // end of the group: scale its exact partial and add it in order
      const float* srow = sw + (size_t)(g0 / group) * N;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx + j * CT;
        const float s = n < N ? srow[n] : 0.0f;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          facc[i][j] = __fadd_rn(facc[i][j],
                                 __fmul_rn(__int2float_rn(acc[i][j]), s));
          acc[i][j] = 0;
        }
      }
    }
  }

  const float z = __fadd_rn(*zx, z_shift);
  // W8A8 forms s_x * s_w first
  const float scale = PACKED ? *sx : __fmul_rn(*sx, *sw);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * RT;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * CT;
      if (n >= N) continue;
      float r;
      if constexpr (PACKED)
        r = __fmul_rn(__fsub_rn(facc[i][j],
                                __fmul_rn(z, static_cast<const float*>(
                                                 colsum)[n])),
                      scale);
      else
        r = __fmul_rn(
            __fsub_rn(__int2float_rn(acc[i][j]),
                      __fmul_rn(z, __int2float_rn(
                                       static_cast<const int*>(colsum)[n]))),
            scale);
      if (out_bf16)
        reinterpret_cast<__nv_bfloat16*>(out)[(size_t)m * N + n] =
            __float2bfloat16_rn(r);
      else
        reinterpret_cast<float*>(out)[(size_t)m * N + n] = r;
    }
  }
}

template <bool PACKED, int BM, int BN, int BK, int TM, int TN>
static void launch_tile(const void* x, const void* w, const void* sw,
                        const void* colsum, const void* sx, const void* zx,
                        float z_shift, void* out, int out_bf16, int M, int N,
                        int K, int group, cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int_matmul_kernel<PACKED, BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, st>>>(
          (const int8_t*)x, (const int8_t*)w, (const float*)sw, colsum,
          (const float*)sx, (const float*)zx, z_shift, out, out_bf16, M, N,
          K, group);
}

// the tile for M: 16 rows at decode, 64 x 64 at prefill
template <bool PACKED>
static int int_matmul_launch(const void* x, const void* w, const void* sw,
                             const void* colsum, const void* sx,
                             const void* zx, float z_shift, void* out,
                             int out_bf16, int M, int N, int K, int group,
                             cudaStream_t st) {
  if (M <= 16)
    launch_tile<PACKED, 16, 32, 64, 1, 2>(x, w, sw, colsum, sx, zx, z_shift,
                                          out, out_bf16, M, N, K, group, st);
  else
    launch_tile<PACKED, 64, 64, 32, 4, 4>(x, w, sw, colsum, sx, zx, z_shift,
                                          out, out_bf16, M, N, K, group, st);
  return (int)cudaGetLastError();
}
