// The activation quantizers' arithmetic, shared by act_quant.cu (the
// standalone static and per-token kernels) and int_matmul.cuh (the int
// matmuls' decode staging, which quantizes an f32 / bf16 activation while
// it stages A).
//
//   code = clip(round_half_even(x / s + z), 0, qmax) - 128   (one byte)
//
// x / s is an IEEE division and the add a separate rounding (__fdiv_rn,
// __fadd_rn, never fused, never a reciprocal multiply), rounding is half to
// even: the f32 arithmetic of the plain PyTorch versions and of jnp, so the
// codes are bit-identical. The per-token kernel on bf16 input rounds each
// step to bf16 as JAX's model path does. Never built with --use_fast_math.
//
// The codes are instruction-bound before they are byte-bound (the IEEE
// division alone is several instructions and a branch), so the rest is
// kept short: clip first, then round by adding 1.5 * 2^23, whose sum's
// last mantissa byte is the rounded value (clip and round commute, the
// bounds being integers), and four codes packed by three byte permutes and
// one xor for the -128.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace aq {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// x / s of every code (tools/kernel_variants.py swaps it for a multiply)
__device__ __forceinline__ float code_div(float v, float s) {
  return __fdiv_rn(v, s);
}

// A code before its -128, in the last byte of an f32's bits:
// clip(x / s + z, 0, qmax) + 1.5 * 2^23 (the sum's ulp is 1, so it rounds
// half to even, and qmax <= 255 leaves the rest of the mantissa alone).
// BF16_ARITH: every step rounded to bf16 (the per-token kernel on bf16
// input); else all in f32 (the static quantizer on f32 and bf16 input
// alike, the per-token kernel on f32 input).
template <bool BF16_ARITH>
__device__ __forceinline__ uint32_t code_bits(float v, float s, float z,
                                              float qmax) {
  float q;
  if constexpr (BF16_ARITH)
    q = bf_round(__fadd_rn(bf_round(code_div(v, s)), z));
  else
    q = __fadd_rn(code_div(v, s), z);
  q = fminf(fmaxf(q, 0.0f), qmax);
  return __float_as_uint(__fadd_rn(q, 12582912.0f));
}

// four codes from code_bits, offset by -128, as one word (byte j: c_j)
__device__ __forceinline__ uint32_t pack4(uint32_t c0, uint32_t c1,
                                          uint32_t c2, uint32_t c3) {
  return __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040),
                     0x5410) ^ 0x80808080u;
}

// one code, offset by -128, in the low byte
template <bool BF16_ARITH>
__device__ __forceinline__ uint32_t code(float v, float s, float z,
                                         float qmax) {
  return (code_bits<BF16_ARITH>(v, s, z, qmax) & 0xFFu) ^ 0x80u;
}

// 16 bytes of T: 4 f32 or 8 bf16
template <typename T>
struct Vec {
  static constexpr int N = 16 / (int)sizeof(T);
};

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// element j of a 16-byte vector of T, as f32 (exact)
template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int j) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(u, j));
  } else {
    const uint32_t w = word(u, j / 2);
    return __uint_as_float((j & 1) ? (w & 0xFFFF0000u) : (w << 16));
  }
}

__device__ __forceinline__ uint4 ld_nc16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// every code leaves through one of these (tools/kernel_variants.py drops
// the stores)
__device__ __forceinline__ void put8(int8_t* p, uint32_t v) {
  *p = (int8_t)v;
}
__device__ __forceinline__ void put32(int8_t* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}
__device__ __forceinline__ void put64(int8_t* p, uint32_t lo, uint32_t hi) {
  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
}

// The codes of one 16-byte vector (4 or 8 elements) to p: one 4- or 8-byte
// store where p is aligned to it, else byte by byte.
template <typename T, bool BF16_ARITH>
__device__ __forceinline__ void put_codes(int8_t* p, bool vec, const uint4& u,
                                          float s, float z, float qmax) {
  constexpr int N = Vec<T>::N;
  uint32_t b[N], c[2];
#pragma unroll
  for (int j = 0; j < N; ++j)
    b[j] = code_bits<BF16_ARITH>(elem<T>(u, j), s, z, qmax);
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    c[i] = pack4(b[4 * i], b[4 * i + 1], b[4 * i + 2], b[4 * i + 3]);
  if (vec) {
    if constexpr (N == 8) put64(p, c[0], c[1]);
    else put32(p, c[0]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) put8(p + j, c[j / 4] >> (8 * (j % 4)));
  }
}

// Elements before a row or span starting at p is 16-byte aligned (0 when
// it is), at most n.
template <typename T>
__device__ __host__ __forceinline__ int head_elems(const void* p, long long n) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(p) % 16) / (int)sizeof(T);
  const int h = (Vec<T>::N - mis) % Vec<T>::N;
  return n < h ? (int)n : h;
}

}  // namespace aq
