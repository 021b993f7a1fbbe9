// Activation quantizers: the static per-tensor one of the W8A8 / W4A8
// serving path, and the per-token dynamic one of the ptoken_dynamic path.
// Their arithmetic is in act_quant.cuh.
//
// act_quant_static replaces: src/repro/kernels/act_quant.py
// `act_quant_static` (Pallas `_static_kernel`), which the JAX main path
// computes in jnp inside core/quantization.py `prequantized_int_dot`.
//
//   q = clip(round_half_even(x / s + z), 0, 2^bits - 1) - 128  -> int8
//
// The reference notes that the static quantizer is elementwise and fuses
// into the matmul's producer side. The port does so at decode (M <= 16):
// the int matmuls quantize A while they stage it (int_matmul.cuh), and this
// kernel does not run. It runs at prefill and for chunks (M > 16), where
// fusing would redo the division once per 128-column tile of the
// tensor-core mainloop and double A's L2 traffic.
//
// Bound on the card: bytes. Each element is read once (2 B bf16 or 4 B f32)
// and written once (1 B); the arithmetic is a handful of operations per
// element, one of them an IEEE division — at D = 2560 the codes' ~15
// instructions an element take about as long as the bytes
// (tools/kernel_variants.py). Design: 16-byte loads (ld.global.nc, 8 bf16
// or 4 f32), two of them in flight a thread, the codes of each written by
// one 8- or 4-byte store; the grid covers the whole tensor in one wave
// where it can (a grid-stride loop beyond 1056 blocks). A scalar head takes the elements before x is 16-byte aligned (a
// slice), a scalar tail the last n % 8 (bf16) or n % 4 (f32); where the
// head leaves the codes unaligned for a vector store, they are stored
// byte by byte. The scale and zero point are read from device memory (no
// host sync).
//
// act_quant_ptoken replaces: src/repro/kernels/act_quant.py
// `act_quant_ptoken` (Pallas `_ptoken_kernel`), whose function the JAX model
// path computes in jnp inside core/quantization.py `act_fake_quant` under
// ptoken_dynamic, at every qlinear site and the head.
//
// Per row: mn = min(min(x), 0), mx = max(max(x), 0), then a scale, an
// integer zero point and codes clip(round(x / scale + zero), 0, qmax) - 128.
// The input's dtype sets the arithmetic:
//   f32:  the Pallas kernel's — scale = max((mx - mn) / qmax, 1e-8),
//         zero = round(clip(-mn / scale, 0, qmax)), all in f32;
//   bf16: the JAX model path on a bf16 activation, where every step is a
//         bf16 op — the same f32 operation rounded to bf16 after each step
//         (s = bf(bf(mx - mn) / qmax), z = round(clip(bf(0 - bf(mn /
//         (s == 0 ? 1 : s))), 0, qmax)), s = (s <= 0 ? 1 : s),
//         q = rint(bf(bf(x / s) + z))).
// The scale and zero come out as f32 (from bf16 input they hold bf16
// values).
//
// Bound on the card: bytes — each element read once (2 B bf16 or 4 B f32)
// and its code written once (1 B) — and, as the static kernel, the
// instructions of each code. At decode (M = 4) a call is latency: one read
// of the row, a reduction, the codes. Design: a block per row of 128
// threads, or 256 above 128 vectors a row, so about one 16-byte vector a
// thread (a warp per row, the first design, leaves each lane of the four
// rows at M = 4 with 30-80 IEEE divisions in a row, each ending in a
// branch; tools/kernel_variants.py keeps it as ptoken_warp_per_row, and
// PERF.md has both timed).
// The row is read once with 16-byte
// ld.global.nc loads into shared memory at the same 16-byte alignment as in
// global memory, min and max reduce by warp shuffles and one barrier,
// every thread derives the scale and zero itself from the reduced pair in
// the exact sequence of the plain version, thread 0 stores them, and the
// codes are made from shared memory and written by 8- or 4-byte stores.
// A scalar head and tail take an odd D and a row that is not 16-byte
// aligned.
// min and max are exact in any order, and every division is IEEE
// (__fdiv_rn), never fused.
//
// Two more modes serve tensor parallelism, where a row-parallel site's row
// is cut over the ranks: range-only (mode 1) writes the row's (mn, mx),
// the zero folded in, and no codes; given-range (mode 2) reads a row's
// (mn, mx), the ranks' min and max of those (exact), and writes the codes,
// scale and zero that this kernel makes from a range. The codes of a rank's
// part are then those of the whole row.
#include "act_quant.cuh"

namespace {

constexpr int S_THREADS = 256, S_UNROLL = 2;
constexpr int S_MAX_BLOCKS = 132 * 8;    // one wave of 256-thread blocks

template <typename T>
__global__ void __launch_bounds__(S_THREADS)
act_quant_static_kernel(const T* __restrict__ x,
                        const float* __restrict__ scale,
                        const float* __restrict__ zero,
                        int8_t* __restrict__ out, long long n, int head,
                        long long nvec, int out_vec) {
  constexpr int N = aq::Vec<T>::N;
  const float s = *scale, z = *zero;
  const int tid = threadIdx.x;
  if (blockIdx.x == 0) {
    // the scalar head (before x is 16-byte aligned) and tail (< N each)
    const long long t = head + nvec * N + tid;
    if (tid < head)
      aq::put8(out + tid, aq::code<false>(aq::to_f32(x[tid]), s, z, 255.0f));
    if (t < n)
      aq::put8(out + t, aq::code<false>(aq::to_f32(x[t]), s, z, 255.0f));
  }
  const T* xb = x + head;
  int8_t* ob = out + head;
  const long long stride = (long long)gridDim.x * S_THREADS * S_UNROLL;
  for (long long v0 = (long long)blockIdx.x * S_THREADS * S_UNROLL + tid;
       v0 < nvec; v0 += stride) {
    uint4 u[S_UNROLL];
#pragma unroll
    for (int k = 0; k < S_UNROLL; ++k) {
      const long long v = v0 + (long long)k * S_THREADS;
      u[k] = v < nvec ? aq::ld_nc16(xb + v * N) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < S_UNROLL; ++k) {
      const long long v = v0 + (long long)k * S_THREADS;
      if (v < nvec)
        aq::put_codes<T, false>(ob + v * N, out_vec, u[k], s, z, 255.0f);
    }
  }
}

template <typename T>
int launch_static(const T* x, const float* scale, const float* zero,
                  int8_t* out, long long n, cudaStream_t st) {
  constexpr int N = aq::Vec<T>::N;
  const int head = aq::head_elems<T>(x, n);
  const long long nvec = (n - head) / N;
  const int out_vec = (reinterpret_cast<uintptr_t>(out) + head) % N == 0;
  long long blocks = (nvec + S_THREADS * S_UNROLL - 1) / (S_THREADS * S_UNROLL);
  if (blocks > S_MAX_BLOCKS) blocks = S_MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  act_quant_static_kernel<T><<<(int)blocks, S_THREADS, 0, st>>>(
      x, scale, zero, out, n, head, nvec, out_vec);
  return (int)cudaGetLastError();
}

// The row's scale and zero point from its reduced (mn, mx), in the exact
// sequence of the plain version (see the header comment).
template <bool BF16_ARITH>
__device__ __forceinline__ void row_params(float mn, float mx, float qmax,
                                           float* s_out, float* z_out) {
  float s, z;
  if constexpr (BF16_ARITH) {
    s = aq::bf_round(__fdiv_rn(aq::bf_round(__fsub_rn(mx, mn)), qmax));
    const float sd = s == 0.0f ? 1.0f : s;
    z = aq::bf_round(__fsub_rn(0.0f, aq::bf_round(__fdiv_rn(mn, sd))));
    z = rintf(fminf(fmaxf(z, 0.0f), qmax));
    if (s <= 0.0f) s = 1.0f;
  } else {
    s = fmaxf(__fdiv_rn(__fsub_rn(mx, mn), qmax), 1e-8f);
    z = rintf(fminf(fmaxf(__fdiv_rn(-mn, s), 0.0f), qmax));
  }
  *s_out = s;
  *z_out = z;
}

__device__ __forceinline__ void warp_minmax(float& mn, float& mx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
}

constexpr int P_MAX_THREADS = 256, P_LOADS = 4;

// One block per row: the row staged once in shared memory, at the same
// 16-byte alignment as in global memory, and never re-read from global
// memory; blockDim.x is 128 or 256 (about a vector a thread).
template <typename T>
__global__ void __launch_bounds__(P_MAX_THREADS)
act_quant_ptoken_kernel(const T* __restrict__ x, int8_t* __restrict__ out,
                        float* __restrict__ scale, float* __restrict__ zero,
                        float* __restrict__ lo, float* __restrict__ hi,
                        int mode, int D, float qmax) {
  constexpr int N = aq::Vec<T>::N;
  constexpr bool BF16_ARITH = sizeof(T) == 2;   // bf16 input
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float smn[P_MAX_THREADS / 32], smx[P_MAX_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const T* xr = x + (size_t)blockIdx.x * D;
  int8_t* orow = out + (size_t)blockIdx.x * D;
  const int head = aq::head_elems<T>(xr, D);
  const int nvec = (D - head) / N;
  const int t0 = head + nvec * N;        // the tail: D - t0 < N elements
  // srow[i] holds xr[i]; the aligned vectors land on 16-byte boundaries
  T* srow = reinterpret_cast<T*>(smem) + (N - head) % N;
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  uint4* sv = reinterpret_cast<uint4*>(srow + head);
  // min(., 0) and max(., 0) folded in; P_LOADS loads in flight a thread
  float mn = 0.0f, mx = 0.0f;
  for (int i0 = tid; i0 < nvec; i0 += P_LOADS * nthreads) {
    uint4 u[P_LOADS];
#pragma unroll
    for (int k = 0; k < P_LOADS; ++k) {
      const int i = i0 + k * nthreads;
      u[k] = i < nvec ? aq::ld_nc16(xv + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < P_LOADS; ++k) {
      const int i = i0 + k * nthreads;
      if (i < nvec) {
        sv[i] = u[k];
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float f = aq::elem<T>(u[k], e);
          mn = fminf(mn, f);
          mx = fmaxf(mx, f);
        }
      }
    }
  }
  // the scalar head and tail (< N elements each)
  auto stage1 = [&](int e) {
    const T val = xr[e];
    srow[e] = val;
    mn = fminf(mn, aq::to_f32(val));
    mx = fmaxf(mx, aq::to_f32(val));
  };
  if (tid < head) stage1(tid);
  if (t0 + tid < D) stage1(t0 + tid);
  warp_minmax(mn, mx);
  if (lane == 0) {
    smn[warp] = mn;
    smx[warp] = mx;
  }
  __syncthreads();
  mn = smn[0];
  mx = smx[0];
  for (int w = 1; w < nthreads / 32; ++w) {
    mn = fminf(mn, smn[w]);
    mx = fmaxf(mx, smx[w]);
  }
  if (mode == 1) {                      // range only
    if (tid == 0) {
      lo[blockIdx.x] = mn;
      hi[blockIdx.x] = mx;
    }
    return;
  }
  if (mode == 2) {                      // the given range
    mn = lo[blockIdx.x];
    mx = hi[blockIdx.x];
  }
  float s, z;
  row_params<BF16_ARITH>(mn, mx, qmax, &s, &z);
  if (tid == 0) {
    scale[blockIdx.x] = s;
    zero[blockIdx.x] = z;
  }
  const bool ovec = (reinterpret_cast<uintptr_t>(orow) + head) % N == 0;
  for (int i = tid; i < nvec; i += nthreads)
    aq::put_codes<T, BF16_ARITH>(orow + head + i * N, ovec, sv[i], s, z,
                                 qmax);
  if (tid < head)
    aq::put8(orow + tid,
             aq::code<BF16_ARITH>(aq::to_f32(srow[tid]), s, z, qmax));
  if (t0 + tid < D)
    aq::put8(orow + t0 + tid,
             aq::code<BF16_ARITH>(aq::to_f32(srow[t0 + tid]), s, z, qmax));
}

template <typename T>
int launch_ptoken(const T* x, int8_t* out, float* scale, float* zero,
                  float* lo, float* hi, int mode, int M, int D, float qmax,
                  cudaStream_t st) {
  constexpr int N = aq::Vec<T>::N;
  const int threads = D / N > 128 ? 256 : 128;
  // the row plus up to 15 bytes of alignment, in 16-byte units
  const size_t smem = ((size_t)D * sizeof(T) + 31) / 16 * 16;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        act_quant_ptoken_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  act_quant_ptoken_kernel<T><<<M, threads, smem, st>>>(
      x, out, scale, zero, lo, hi, mode, D, qmax);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int act_quant_static_launch(const void* x, int x_bf16,
                                       const void* scale, const void* zero,
                                       void* out, long long n,
                                       void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    return launch_static((const __nv_bfloat16*)x, (const float*)scale,
                         (const float*)zero, (int8_t*)out, n, st);
  return launch_static((const float*)x, (const float*)scale,
                       (const float*)zero, (int8_t*)out, n, st);
}

// mode: 0 the row's own range; 1 range only: (mn, mx) into lo / hi (M,)
// f32, nothing else written; 2 the range given in lo / hi (M,) f32 (bf16
// input: values a bf16 holds), the codes, scale and zero written
extern "C" int act_quant_ptoken_launch(const void* x, int x_bf16, void* out,
                                       void* scale, void* zero, void* lo,
                                       void* hi, int mode, int M, int D,
                                       float qmax, void* stream) {
  if (M < 1) return 0;
  if (D < 1 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    return launch_ptoken((const __nv_bfloat16*)x, (int8_t*)out,
                         (float*)scale, (float*)zero, (float*)lo, (float*)hi,
                         mode, M, D, qmax, st);
  return launch_ptoken((const float*)x, (int8_t*)out, (float*)scale,
                       (float*)zero, (float*)lo, (float*)hi, mode, M, D,
                       qmax, st);
}
