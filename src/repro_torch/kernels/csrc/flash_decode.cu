// Single-query decode attention over a contiguous KV cache or a paged KV
// pool (fp, or int8 with per-kv-head dequant scales and an fp CushionCache
// block).
//
// Replaces: src/repro/kernels/flash_decode.py `flash_decode` (Pallas
// `_kernel`) and `flash_decode_paged` (the same body through a
// scalar-prefetched page table), called from models/common.py
// `attention_decode_kv` on every decode step of every layer.
//
//   q (B, H, hd); contiguous k/v (B, Smax, K, hd), or paged k/v
//   (n_pages, ps, K, hd) with page_table (B, P), Smax = P * ps, logical
//   position t of row b at physical page page_table[b, t / ps], offset
//   t % ps (page 0 is scratch: unmapped positions are never read);
//   fp or int8; k_scale/v_scale (K,) shared or (B, K) per row;
//   kc/vc (m, K, hd) fp cushion covering positions [0, m) (contiguous: int8
//   mode only, an fp cache holds the cushion in-cache; paged: fp and int8);
//   pos () or (B,) int32. Row b attends positions [m, pos[b]] plus the whole
//   cushion block; pos < 0 retires a row (no cushion: zeros; with a
//   cushion: the cushion only). Output is acc / max(l, 1e-30).
//
// Bound on the card: bytes. Each step reads the live part of the cache once
// (int8: 1 byte per element, half of bf16) and does 2 multiply-adds per
// element read for each of the G query heads that share a kv-head. Design:
// one block per (b, kv-head) holding its G query heads, so GQA reads each
// kv row once and never repeats heads in memory; eight warps split the
// positions round-robin, each lane owns hd/32 dims of q, k, v and the
// accumulator, the score is a warp shuffle reduction, and every warp keeps
// its own f32 online softmax (max, sum, acc) in registers, merged through
// shared memory at the end. The int8 dequant multiplies by the head's scale
// in registers. Positions past pos are never read. With B * K = 20 blocks
// on 132 SMs the card is mostly idle at smollm's decode shape; splitting
// positions across blocks (split-KV with a combine pass) is left for later.
//
// Both layouts run one kernel body; a template parameter maps (b, t) to the
// row's address (`Contig`, `Paged`), so the paged kernel on a pool adds the
// same terms in the same order as the contiguous kernel on the gathered
// cache and the two agree bit for bit. The paged variant reads one int32 of
// the page table per position (cached in L1: a row's table is P ints).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define NEG_INF (-1e30f)
constexpr int NW = 8;      // warps per block
constexpr int GMAX = 8;    // most query heads per kv-head

template <typename T>
__device__ __forceinline__ float ld(const T* p);
template <>
__device__ __forceinline__ float ld<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ld(const int8_t* p) { return (float)(*p); }

template <typename T>
__device__ __forceinline__ void st(T* p, float v);
template <>
__device__ __forceinline__ void st<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void st<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// element offset of position t of row b, kv-head kh, dim 0
struct Contig {
  int Smax;
  __device__ __forceinline__ long long row(int b, int t, int K, int kh,
                                           int hd) const {
    return (((long long)b * Smax + t) * K + kh) * hd;
  }
};
struct Paged {
  const int* __restrict__ pt;   // (B, P) physical page of each logical page
  int P, ps;
  __device__ __forceinline__ long long row(int b, int t, int K, int kh,
                                           int hd) const {
    const long long page = pt[(long long)b * P + t / ps];
    return ((page * ps + t % ps) * K + kh) * hd;
  }
};

template <typename T, typename C, int HD, typename Addr>
__global__ void __launch_bounds__(NW * 32)
flash_decode_kernel(const T* __restrict__ q, const C* __restrict__ k,
                    const C* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, int scale_per_row,
                    const T* __restrict__ kc, const T* __restrict__ vc,
                    const int* __restrict__ pos, int pos_per_row,
                    T* __restrict__ out, int H, int K, int Smax, int mc,
                    float scale, Addr addr) {
  constexpr int DPL = (HD + 31) / 32;     // dims per lane
  __shared__ float sm_m[NW][GMAX];
  __shared__ float sm_l[NW][GMAX];
  __shared__ float sm_acc[NW][GMAX][HD];

  const int b = blockIdx.x / K, kh = blockIdx.x % K;
  const int G = H / K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int si = scale_per_row ? b * K + kh : kh;
  const float ksc = ks ? ks[si] : 1.f;
  const float vsc = vs ? vs[si] : 1.f;

  float qv[GMAX][DPL], acc[GMAX][DPL], m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane * DPL + e;
      qv[g][e] = (g < G && d < HD)
                     ? ld(q + ((long long)b * H + kh * G + g) * HD + d)
                     : 0.f;
      acc[g][e] = 0.f;
    }
  }

  const int p = pos_per_row ? pos[b] : pos[0];
  int last = p < Smax - 1 ? p : Smax - 1;      // cache positions <= pos
  // positions [0, mc) from the fp cushion, then cache rows [mc, last]
  for (int t = warp; t <= (last > mc - 1 ? last : mc - 1); t += NW) {
    float kr[DPL], vr[DPL];
    if (t < mc) {
      const long long base = ((long long)t * K + kh) * HD;
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane * DPL + e;
        kr[e] = d < HD ? ld(kc + base + d) : 0.f;
        vr[e] = d < HD ? ld(vc + base + d) : 0.f;
      }
    } else {
      const long long base = addr.row(b, t, K, kh, HD);
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane * DPL + e;
        kr[e] = d < HD ? ld(k + base + d) * ksc : 0.f;
        vr[e] = d < HD ? ld(v + base + d) * vsc : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) part += qv[g][e] * kr[e];
      const float s = warp_sum(part) * scale;
      const float mn = fmaxf(m[g], s);
      const float alpha = expf(m[g] - mn);
      const float pr = expf(s - mn);
      l[g] = l[g] * alpha + pr;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] = acc[g][e] * alpha + pr * vr[e];
      m[g] = mn;
    }
  }

#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane * DPL + e;
      if (d < HD) sm_acc[warp][g][d] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += NW * 32) {
    const int g = i / HD, d = i % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(sm_m[w][g] - M);
      L += sm_l[w][g] * c;
      A += sm_acc[w][g][d] * c;
    }
    st(out + ((long long)b * H + kh * G + g) * HD + d, A / fmaxf(L, 1e-30f));
  }
}

template <typename T, typename C, typename Addr>
static int dispatch(const void* q, const void* k, const void* v,
                    const void* ks, const void* vs, int scale_per_row,
                    const void* kc, const void* vc, const void* pos,
                    int per_row, void* out, int B, int H, int K, int Smax,
                    int hd, int mc, Addr addr, cudaStream_t stream) {
  if (H % K != 0 || H / K > GMAX) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)hd);
#define FD_ARGS                                                            \
  (const T*)q, (const C*)k, (const C*)v, (const float*)ks,                 \
      (const float*)vs, scale_per_row, (const T*)kc, (const T*)vc,         \
      (const int*)pos, per_row, (T*)out, H, K, Smax, mc, scale, addr
  switch (hd) {
    case 16: flash_decode_kernel<T, C, 16, Addr><<<B * K, NW * 32, 0, stream>>>(FD_ARGS); break;
    case 32: flash_decode_kernel<T, C, 32, Addr><<<B * K, NW * 32, 0, stream>>>(FD_ARGS); break;
    case 64: flash_decode_kernel<T, C, 64, Addr><<<B * K, NW * 32, 0, stream>>>(FD_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef FD_ARGS
  return (int)cudaGetLastError();
}

template <typename Addr>
static int launch(const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, int scale_per_row, const void* kc,
                  const void* vc, const void* pos, int pos_per_row, void* out,
                  int bf16, int cache_int8, int B, int H, int K, int Smax,
                  int hd, int mc, Addr addr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define FD_CALL(T, C)                                                       \
  dispatch<T, C, Addr>(q, k, v, ks, vs, scale_per_row, kc, vc, pos,         \
                       pos_per_row, out, B, H, K, Smax, hd, mc, addr, st)
  if (bf16) {
    if (cache_int8) return FD_CALL(__nv_bfloat16, int8_t);
    return FD_CALL(__nv_bfloat16, __nv_bfloat16);
  }
  if (cache_int8) return FD_CALL(float, int8_t);
  return FD_CALL(float, float);
#undef FD_CALL
}

// contiguous cache: k/v (B, Smax, K, hd)
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* ks,
                                   const void* vs, int scale_per_row,
                                   const void* kc, const void* vc,
                                   const void* pos, int pos_per_row,
                                   void* out, int bf16, int cache_int8, int B,
                                   int H, int K, int Smax, int hd, int mc,
                                   void* stream) {
  return launch(q, k, v, ks, vs, scale_per_row, kc, vc, pos, pos_per_row, out,
                bf16, cache_int8, B, H, K, Smax, hd, mc, Contig{Smax},
                stream);
}

// paged pool: k/v (n_pages, ps, K, hd), page_table (B, P) int32
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* ks, const void* vs, int scale_per_row, const void* kc,
    const void* vc, const void* pos, int pos_per_row, void* out, int bf16,
    int cache_int8, int B, int H, int K, int P, int ps, int hd, int mc,
    void* stream) {
  return launch(q, k, v, ks, vs, scale_per_row, kc, vc, pos, pos_per_row, out,
                bf16, cache_int8, B, H, K, P * ps, hd, mc,
                Paged{(const int*)page_table, P, ps}, stream);
}
