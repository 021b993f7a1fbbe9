// The f32 instantiation of flash_attention.cu's function: the CUDA-core
// kernel of the first port, one thread per query row, f32 FMAs (no card
// path runs an f32 prefill, and TF32 tensor cores would change the
// function; it was not redesigned). A translation unit of its own, so that
// nvcc builds it beside the bf16 kernels. See flash_attention.cu for the
// function, the mask and the strides.
#include <cuda_runtime.h>

#define NEG_INF (-1e30f)

template <typename T>
__device__ __forceinline__ float ld(const T* p) { return *p; }
template <typename T>
__device__ __forceinline__ void st(T* p, float v) { *p = v; }

constexpr int BQ = 64;
constexpr int BKV = 32;

template <typename T, int HD>
__global__ void __launch_bounds__(BQ)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int H, int G, int S, int T_,
                       int P, int LV, int R, long long qsb,
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
  // last key any query of this tile can see is (q0 + BQ - 1) + R
  int t_end = q0 + BQ + R;
  if (t_end > T_) t_end = T_;
  for (int t0 = 0; t0 < t_end; t0 += BKV) {
    // a tile wholly in the dead rows [LV, P) is seen by no query
    if (t0 >= LV && t0 + BKV <= P) continue;
    for (int i = threadIdx.x; i < BKV * HD; i += BQ) {
      const int j = i / HD, d = i % HD, t = t0 + j;
      Ks[j][d] = t < T_ ? ld(kb + (long long)t * kst + d) : 0.f;
      Vs[j][d] = t < T_ ? ld(vb + (long long)t * vst + d) : 0.f;
    }
    __syncthreads();
    float s[BKV];
    float mx = m;
    // the key loop rolled (and the output loop below): fully unrolled
    // twice over, the nests took nvcc ~50 s at head_dim 80; the sums are
    // the same, in the same order
#pragma unroll 1
    for (int j = 0; j < BKV; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot += qr[d] * Ks[j][d];
      const int kj = t0 + j;
      const bool valid = kj < T_ && (kj < LV || (kj >= P && kj <= qi + R));
      s[j] = valid ? dot * scale : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = expf(m - mx);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const int kj = t0 + j;
      const bool valid = kj < T_ && (kj < LV || (kj >= P && kj <= qi + R));
      s[j] = valid ? expf(s[j] - mx) : 0.f;
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll 1
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
    if (lse) lse[(long long)bh * S + qi] = m + logf(fmaxf(l, 1e-30f));
  }
}

#define FA_ARGS(T)                                                          \
  (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, H, G, S, T_, P, LV,  \
      R,                                                                     \
      str[0], str[1], str[2], str[3], str[4], str[5], str[6], str[7],        \
      str[8], str[9], str[10], str[11], scale

int flash_attention_dispatch_f32(const void* q, const void* k, const void* v,
                                 void* out, float* lse, int B, int H, int Kh,
                                 int S, int T_, int hd, int P, int LV, int R,
                                 const long long* str, cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, B * H);
  const int G = H / Kh;
  const float scale = 1.0f / sqrtf((float)hd);
  switch (hd) {
    case 16: flash_attention_kernel<float, 16><<<grid, BQ, 0, stream>>>(FA_ARGS(float)); break;
    case 32: flash_attention_kernel<float, 32><<<grid, BQ, 0, stream>>>(FA_ARGS(float)); break;
    case 64: flash_attention_kernel<float, 64><<<grid, BQ, 0, stream>>>(FA_ARGS(float)); break;
    case 80: flash_attention_kernel<float, 80><<<grid, BQ, 0, stream>>>(FA_ARGS(float)); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#undef FA_ARGS
