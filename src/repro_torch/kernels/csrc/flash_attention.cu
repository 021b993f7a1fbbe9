// Prefill attention with a fully visible CushionCache prefix, GQA, f32
// online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py `flash_attention` (Pallas
// `_kernel`). The JAX prefill computes the same function with
// models/common.py `_sdpa_dense` / `flash_attention_jnp`; the port runs this
// kernel in `attention_full` on the card.
//
//   q (B, H, S, hd), k/v (B, Kh, T, hd), T = prefix_len + S, G = H / Kh
//   key j is visible to query i  iff  j < T and (j < prefix_len or
//   j <= i + prefix_len); masked scores are -1e30 (not -inf), and the
//   output is acc / max(l, 1e-30).
//
// Bound on the card: operations (S x T x hd multiply-adds per head, twice),
// which at S = 512 is well above the bytes of q, k, v and out. Design: one
// block per (b, h, 64-query tile), one thread per query holding its q row,
// its f32 accumulator and its running max / sum in registers; 32-key K and
// V tiles are staged in shared memory as f32 and read by every thread as a
// broadcast. The kv-head is h / G, read in place (no repeat in memory), and
// key tiles past the tile's last visible key are skipped. Strides are
// passed in, so q and out may be (B, S, H, hd) tensors viewed as
// (B, H, S, hd). CUDA cores only: tensor-core MMA is left for later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

template <typename T>
__device__ __forceinline__ float ld(const T* p);
template <>
__device__ __forceinline__ float ld<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename T>
__device__ __forceinline__ void st(T* p, float v);
template <>
__device__ __forceinline__ void st<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void st<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int BQ = 64;
constexpr int BKV = 32;

template <typename T, int HD>
__global__ void __launch_bounds__(BQ)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int G, int S, int T_, int P, long long qsb,
                       long long qsh, long long qss, long long ksb,
                       long long ksh, long long kst, long long vsb,
                       long long vsh, long long vst, long long osb,
                       long long osh, long long oss, float scale) {
  __shared__ float Ks[BKV][HD];
  __shared__ float Vs[BKV][HD];
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kh = h / G;
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + threadIdx.x;
  const bool live = qi < S;

  float qr[HD], acc[HD];
  const T* qp = q + b * qsb + h * qsh + (long long)(live ? qi : 0) * qss;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = live ? ld(qp + d) : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;
  // last key any query of this tile can see is (q0 + BQ - 1) + P
  int t_end = q0 + BQ + P;
  if (t_end > T_) t_end = T_;
  for (int t0 = 0; t0 < t_end; t0 += BKV) {
    for (int i = threadIdx.x; i < BKV * HD; i += BQ) {
      const int j = i / HD, d = i % HD, t = t0 + j;
      Ks[j][d] = t < T_ ? ld(kb + (long long)t * kst + d) : 0.f;
      Vs[j][d] = t < T_ ? ld(vb + (long long)t * vst + d) : 0.f;
    }
    __syncthreads();
    float s[BKV];
    float mx = m;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot += qr[d] * Ks[j][d];
      const int kj = t0 + j;
      const bool valid = kj < T_ && (kj < P || kj <= qi + P);
      s[j] = valid ? dot * scale : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = expf(m - mx);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const int kj = t0 + j;
      const bool valid = kj < T_ && (kj < P || kj <= qi + P);
      s[j] = valid ? expf(s[j] - mx) : 0.f;
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      float a = acc[d] * alpha;
#pragma unroll
      for (int j = 0; j < BKV; ++j) a += s[j] * Vs[j][d];
      acc[d] = a;
    }
    m = mx;
    __syncthreads();
  }
  if (live) {
    const float inv_l = 1.f / fmaxf(l, 1e-30f);
    T* op = out + b * osb + h * osh + (long long)qi * oss;
#pragma unroll
    for (int d = 0; d < HD; ++d) st(op + d, acc[d] * inv_l);
  }
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* out,
                    int B, int H, int Kh, int S, int T_, int hd, int P,
                    const long long* str, cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, B * H);
  const int G = H / Kh;
  const float scale = 1.0f / sqrtf((float)hd);
#define FA_ARGS                                                             \
  (const T*)q, (const T*)k, (const T*)v, (T*)out, H, G, S, T_, P, str[0],   \
      str[1], str[2], str[3], str[4], str[5], str[6], str[7], str[8],        \
      str[9], str[10], str[11], scale
  switch (hd) {
    case 16: flash_attention_kernel<T, 16><<<grid, BQ, 0, stream>>>(FA_ARGS); break;
    case 32: flash_attention_kernel<T, 32><<<grid, BQ, 0, stream>>>(FA_ARGS); break;
    case 64: flash_attention_kernel<T, 64><<<grid, BQ, 0, stream>>>(FA_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_ARGS
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int bf16, int B,
    int H, int Kh, int S, int T_, int hd, int prefix_len, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst, long long osb, long long osh,
    long long oss, void* stream) {
  const long long str[12] = {qsb, qsh, qss, ksb, ksh, kst,
                             vsb, vsh, vst, osb, osh, oss};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, H, Kh, S, T_, hd,
                                   prefix_len, str, st);
  return dispatch<float>(q, k, v, out, B, H, Kh, S, T_, hd, prefix_len, str,
                         st);
}
