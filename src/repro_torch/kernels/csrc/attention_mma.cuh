// Tensor-core helpers shared by the bf16 attention kernels
// (flash_attention.cu's forward and flash_attention_bwd.cu's backward):
// 16-byte `cp.async` staging, `ldmatrix` fragment loads, `mma.sync.m16n8k16`
// (bf16 in, f32 accumulate), base-2 exponentials and the split of an f32
// value into bf16 terms.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy; a false predicate fills the 16 bytes with
// zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (MUFU, relative error below 2^-22; results below 2^-126 flush to
// 0, which no sum of p of at least 1 can see)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x, y) as three packed bf16 pairs: p1 = bf16(p), p2 = bf16(p - p1),
// p3 = bf16(p - p1 - p2), together exact to f32's 24 bits (each
// subtraction is exact: a term is the nearest bf16 of what is left)
__device__ __forceinline__ void split3(float x, float y, uint32_t& a1,
                                       uint32_t& a2, uint32_t& a3) {
  a1 = pack_rn(x, y);
  const float rx = __fsub_rn(x, bf16_lo(a1)), ry = __fsub_rn(y, bf16_hi(a1));
  a2 = pack_rn(rx, ry);
  a3 = pack_rn(__fsub_rn(rx, bf16_lo(a2)), __fsub_rn(ry, bf16_hi(a2)));
}

// (x, y) as the first N packed bf16 pairs of split3's sequence: term t is
// the nearest bf16 of what terms 0..t-1 leave, so N terms carry ~8N bits
template <int N>
__device__ __forceinline__ void split_terms(float x, float y,
                                            uint32_t (&a)[N]) {
#pragma unroll
  for (int t = 0; t < N; ++t) {
    a[t] = pack_rn(x, y);
    x = __fsub_rn(x, bf16_lo(a[t]));
    y = __fsub_rn(y, bf16_hi(a[t]));
  }
}
