// Activation quantizers: the static per-tensor one of the W8A8 / W4A8
// serving path, and the per-token dynamic one of the ptoken_dynamic path.
//
// act_quant_static replaces: src/repro/kernels/act_quant.py
// `act_quant_static` (Pallas `_static_kernel`), which the JAX main path
// computes in jnp inside core/quantization.py `prequantized_int_dot`.
//
//   q = clip(round_half_even(x / s + z), 0, 2^bits - 1) - 128  -> int8
//
// Bound on the card: bytes. Each element is read once (2 B bf16 or 4 B f32)
// and written once (1 B); the arithmetic is a handful of operations per
// element. Design: a grid-stride elementwise loop, one element per thread
// per step, neighbouring threads on neighbouring elements so loads coalesce.
// The scale and zero point are read from device memory (no host sync).
//
// Exactness: x/s is an IEEE division and the add a separate rounding
// (__fdiv_rn, __fadd_rn, never fused), and rounding is half to even
// (rintf) — the same f32 arithmetic as the plain PyTorch version and jnp,
// so the codes are bit-identical. Never built with --use_fast_math.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void act_quant_static_kernel(const T* __restrict__ x,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ zero,
                                        int8_t* __restrict__ out,
                                        long long n) {
  const float s = *scale;
  const float z = *zero;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (; i < n; i += stride) {
    float q = rintf(__fadd_rn(__fdiv_rn(to_f32(x[i]), s), z));
    q = fminf(fmaxf(q, 0.0f), 255.0f);
    out[i] = (int8_t)((int)q - 128);
  }
}

extern "C" int act_quant_static_launch(const void* x, int x_bf16,
                                       const void* scale, const void* zero,
                                       void* out, long long n,
                                       void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16) {
    act_quant_static_kernel<__nv_bfloat16><<<(int)blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)x, (const float*)scale, (const float*)zero,
        (int8_t*)out, n);
  } else {
    act_quant_static_kernel<float><<<(int)blocks, threads, 0, st>>>(
        (const float*)x, (const float*)scale, (const float*)zero,
        (int8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

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
// and its code written once (1 B); a row's min/max is a handful of
// operations per element. Design: one block per row (the Pallas grid's
// rows, D <= 8192 in every configuration), a strided loop for the exact
// min/max (order-free), a warp-shuffle then shared-memory reduction, then a
// second strided pass that re-reads the row (L1/L2-resident, <= 32 KB) and
// writes the codes. Every division is IEEE (__fdiv_rn), never fused.
__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void act_quant_ptoken_kernel(const T* __restrict__ x,
                                        int8_t* __restrict__ out,
                                        float* __restrict__ scale,
                                        float* __restrict__ zero, int D,
                                        float qmax) {
  constexpr bool BF16_ARITH = sizeof(T) == 2;   // bf16 input
  __shared__ float smn[32], smx[32];
  __shared__ float s_sz[2];
  const T* xr = x + (size_t)blockIdx.x * D;
  int8_t* orow = out + (size_t)blockIdx.x * D;
  float mn = 0.0f, mx = 0.0f;            // min(., 0) and max(., 0) folded in
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  if (lane == 0) {
    smn[warp] = mn;
    smx[warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < n_warps; ++w) {
      mn = fminf(mn, smn[w]);
      mx = fmaxf(mx, smx[w]);
    }
    float s, z;
    if constexpr (BF16_ARITH) {
      s = bf_round(__fdiv_rn(bf_round(__fsub_rn(mx, mn)), qmax));
      const float sd = s == 0.0f ? 1.0f : s;
      z = bf_round(__fsub_rn(0.0f, bf_round(__fdiv_rn(mn, sd))));
      z = rintf(fminf(fmaxf(z, 0.0f), qmax));
      if (s <= 0.0f) s = 1.0f;
    } else {
      s = fmaxf(__fdiv_rn(__fsub_rn(mx, mn), qmax), 1e-8f);
      z = rintf(fminf(fmaxf(__fdiv_rn(-mn, s), 0.0f), qmax));
    }
    s_sz[0] = s;
    s_sz[1] = z;
    scale[blockIdx.x] = s;
    zero[blockIdx.x] = z;
  }
  __syncthreads();
  const float s = s_sz[0], z = s_sz[1];
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    float q;
    if constexpr (BF16_ARITH)
      q = rintf(bf_round(__fadd_rn(bf_round(__fdiv_rn(v, s)), z)));
    else
      q = rintf(__fadd_rn(__fdiv_rn(v, s), z));
    q = fminf(fmaxf(q, 0.0f), qmax);
    orow[i] = (int8_t)((int)q - 128);
  }
}

extern "C" int act_quant_ptoken_launch(const void* x, int x_bf16, void* out,
                                       void* scale, void* zero, int M, int D,
                                       float qmax, void* stream) {
  const int threads = 256;
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1) return 0;
  if (x_bf16)
    act_quant_ptoken_kernel<__nv_bfloat16><<<M, threads, 0, st>>>(
        (const __nv_bfloat16*)x, (int8_t*)out, (float*)scale, (float*)zero,
        D, qmax);
  else
    act_quant_ptoken_kernel<float><<<M, threads, 0, st>>>(
        (const float*)x, (int8_t*)out, (float*)scale, (float*)zero, D, qmax);
  return (int)cudaGetLastError();
}
