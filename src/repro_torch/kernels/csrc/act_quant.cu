// Static per-tensor activation quantizer for the W8A8 serving path.
//
// Replaces: src/repro/kernels/act_quant.py `act_quant_static` (Pallas
// `_static_kernel`), which the JAX main path computes in jnp inside
// core/quantization.py `prequantized_int_dot`.
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
