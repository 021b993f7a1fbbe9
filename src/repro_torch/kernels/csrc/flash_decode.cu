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
// A window of the KV heads: the cache, its scales and the cushion hold
// Kmem heads, and the launch reads heads
// [kv0, kv0 + K) of them for its H = G * K query heads. A tensor-parallel
// rank whose query heads are cut while the KV heads are whole reads its
// group's head of the whole cache so, in place (models/common.py
// `kv_window`); every other launch reads all of them (kv0 = 0, Kmem = K).
//
// Bound on the card: bytes. Each step reads the live part of the cache once
// (int8: 1 byte per element, half of bf16) and does 2 multiply-adds per
// element read for each of the G query heads that share a kv-head, far too
// little work for a tensor core (G <= 8 rows). At smollm's B * K = 20
// (b, kv-head) pairs the first port lost to latency, not bytes: one block
// per pair walked its positions one dependent load at a time. Now what
// bounds a call is a chain of memory round trips (pos, the chunk's rows,
// the ticket, the partials) and the launch, not the bytes.
//
// Design (split-KV): each row's positions are cut into fixed chunks of
// CH = 64, and the grid is (ceil(Smax / CH), B * K): 200 blocks at a
// 640-position cache. A block stages its chunk's K and V rows in shared
// memory as f32 with 16-byte vector loads, all in flight at once (int8
// dequantized with the head's scale as it is read; positions below m come
// from the cushion), computes the chunk's CH x G scores in parallel, one
// max and one sum per query head, and P V with a thread per (g, d). Its
// partial (m, l, acc[G][hd]) goes to a workspace. A chunk that starts past
// the row's last position (max(pos[b], m - 1), pos clamped to Smax - 1)
// reads nothing and writes no partial. All arithmetic is f32 but the
// scores' dot products, which are f64: with int8 KV the scores reach about
// 15 and pass through exp, so their f32 rounding is what moves outputs
// near zero by a few 1e-6 at long lengths, the size of the 1e-6 floor of
// the one-bf16-ulp check the kernel is held to (and of the plain version's
// own f32 error). f64 there costs about 1 us a call; f64 in the other sums
// bought no margin and cost 8 us at 4096 positions
// (tools/kernel_variants.py). Head dims 16, 32, 64 and 128 (olmoe's):
// the chunk's f32 K and V rows and the queries take dynamic shared memory,
// 72 KB at 128.
//
// The merge is deterministic: every block of a (b, kv-head) takes a ticket
// with atomicAdd after a __threadfence(); the last one reads the partials
// of the row's live chunks in chunk order 0..n-1, writes the output and
// resets the counter to 0 for the next launch. The result depends neither
// on which block merges nor on block timing, on B or on the address map:
// the chunks, the order of every sum and the merge order are fixed by the
// positions alone. The counters are an int32 buffer that the wrapper keeps
// for each (device, stream), zeroed once: launches on one stream run in
// order, so no two kernels share them at once. One launch per call: the
// decode path is host-bound and a second (combine) launch would cost host
// time on every layer of every step.
//
// Both layouts run one kernel body; a template parameter maps (b, t) to the
// row's address (`Contig`, `Paged`), so the paged kernel on a pool adds the
// same terms in the same order as the contiguous kernel on the gathered
// cache and the two agree bit for bit. K/V rows are read as 16-byte vectors
// (the wrapper checks the alignment).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define NEG_INF (-1e30f)
constexpr int CH = 64;       // positions per chunk
constexpr int NT = 256;      // threads per block
constexpr int GMAX = 8;      // most query heads per kv-head
typedef double dot_t;        // the scores' dot products (see above)
typedef float acc_t;         // every other sum

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

// a 16-byte vector of cache elements -> f32 in shared memory (int8 scaled
// by the head's dequant scale)
template <typename C>
struct Vec;
template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void put(float* dst, uint4 raw,
                                             float sc) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(dst + 4 * i) = make_float4(
          (float)(int8_t)(w[i] & 0xff) * sc,
          (float)(int8_t)((w[i] >> 8) & 0xff) * sc,
          (float)(int8_t)((w[i] >> 16) & 0xff) * sc,
          (float)(int8_t)(w[i] >> 24) * sc);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ float lo(uint32_t w) {
    return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w & 0xffff)));
  }
  static __device__ __forceinline__ float hi(uint32_t w) {
    return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w >> 16)));
  }
  static __device__ __forceinline__ void put(float* dst, uint4 raw, float) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(lo(raw.x), hi(raw.x), lo(raw.y), hi(raw.y));
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(lo(raw.z), hi(raw.z), lo(raw.w), hi(raw.w));
  }
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void put(float* dst, uint4 raw, float) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                    __uint_as_float(raw.z), __uint_as_float(raw.w));
  }
};

// element offset of position t of row b, kv-head kh (of K in memory), dim 0
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

__device__ __forceinline__ acc_t warp_sum(acc_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ acc_t warp_max(acc_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the chunk's K and V rows (padded) and the group's queries, f32, in
// dynamic shared memory (past the 48 KB of a static allocation at head_dim
// 128, olmoe's)
template <int HD>
constexpr int fd_smem_bytes() { return (2 * CH * (HD + 4) + GMAX * HD) * 4; }
// the kernel's static shared memory (Ps, Ls, Mrun, Resc, s_last): with it
// the dynamic bytes pass 48 KB at head_dim 80 (stablelm-3b) as well
constexpr int FD_STATIC_BYTES = (2 * GMAX * CH + 2 * GMAX) * 4 + 4;

template <typename T, typename C, int HD, typename Addr>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const T* __restrict__ q, const C* __restrict__ k,
                    const C* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, int scale_per_row,
                    const T* __restrict__ kc, const T* __restrict__ vc,
                    const int* __restrict__ pos, int pos_per_row,
                    T* __restrict__ out, int H, int K, int Smax, int mc,
                    int kv0, int Kmem, acc_t scale, Addr addr,
                    acc_t* __restrict__ ws, int* __restrict__ tickets) {
  constexpr int LDS = HD + 4;              // float4 reads conflict-free
  constexpr int VN = Vec<C>::N;            // elements per 16-byte vector
  constexpr int VPR = HD / VN;             // vectors per row
  constexpr int ITER = (CH * VPR + NT - 1) / NT;
  extern __shared__ __align__(16) float fd_smem[];
  float* const Ks = fd_smem;                 // [CH * LDS]
  float* const Vs = Ks + CH * LDS;           // [CH * LDS]
  float* const Qs = Vs + CH * LDS;           // [GMAX * HD]
  __shared__ acc_t Ps[GMAX][CH];          // scores, then p; merge weights
  __shared__ acc_t Ls[GMAX][CH];          // merge: l_c * w_c
  __shared__ int s_last;

  const int c = blockIdx.x, nch = gridDim.x;
  const int bk = blockIdx.y, b = bk / K, kh = bk % K;
  const int km = kv0 + kh;                  // the head's index in memory
  const int G = H / K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int si = scale_per_row ? b * Kmem + km : km;
  const float ksc = ks ? ks[si] : 1.f;
  const float vsc = vs ? vs[si] : 1.f;
  const int p = pos_per_row ? pos[b] : pos[0];
  int last = p < Smax - 1 ? p : Smax - 1;   // cache positions <= pos
  if (last < mc - 1) last = mc - 1;         // the cushion stays visible
  const int t0 = c * CH;
  const int nv = min(CH, last - t0 + 1);    // this chunk's positions
  // workspace (f32): acc (B*K, nch, G, HD), then (m, l) (B*K, nch, G, 2)
  acc_t* acc_bk = ws + (long long)bk * nch * G * HD;
  acc_t* ml_bk = ws + (long long)gridDim.y * nch * G * HD
                  + (long long)bk * nch * G * 2;

  if (nv > 0) {
    // cache rows [max(t0, mc), t0 + nv): every vector load in flight first
    uint4 kr[ITER], vr[ITER];
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int idx = tid + it * NT, r = idx / VPR, cv = idx % VPR;
      if (idx < CH * VPR && r < nv && t0 + r >= mc) {
        const long long off = addr.row(b, t0 + r, Kmem, km, HD) + cv * VN;
        kr[it] = *reinterpret_cast<const uint4*>(k + off);
        vr[it] = *reinterpret_cast<const uint4*>(v + off);
      }
    }
    for (int i = tid; i < G * HD; i += NT)
      Qs[i] = ld(q + ((long long)b * H + kh * G) * HD + i);
    // cushion rows [t0, min(t0 + nv, mc))
    const int ncu = min(nv, mc - t0);
    for (int i = tid; i < ncu * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      const long long off = ((long long)(t0 + r) * Kmem + km) * HD + d;
      Ks[r * LDS + d] = ld(kc + off);
      Vs[r * LDS + d] = ld(vc + off);
    }
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int idx = tid + it * NT, r = idx / VPR, cv = idx % VPR;
      if (idx < CH * VPR && r < nv && t0 + r >= mc) {
        Vec<C>::put(&Ks[r * LDS + cv * VN], kr[it], ksc);
        Vec<C>::put(&Vs[r * LDS + cv * VN], vr[it], vsc);
      }
    }
    __syncthreads();

    // scores: thread (t, g) for g = gq, gq + 4 (NT / CH = 4 quarters)
    {
      const int t = tid % CH, gq = tid / CH;
      if (t < nv) {
        // four partial sums (dims d mod 4) per head: short f64 chains
        dot_t acc[GMAX / 4][4] = {};
#pragma unroll 4
        for (int d = 0; d < HD; d += 4) {
          const float4 kv4 = *reinterpret_cast<const float4*>(&Ks[t * LDS + d]);
#pragma unroll
          for (int j = 0; j < GMAX / 4; ++j) {
            const int g = gq + 4 * j;
            if (g < G) {
              const float4 q4 =
                  *reinterpret_cast<const float4*>(&Qs[g * HD + d]);
              acc[j][0] = fma((dot_t)q4.x, (dot_t)kv4.x, acc[j][0]);
              acc[j][1] = fma((dot_t)q4.y, (dot_t)kv4.y, acc[j][1]);
              acc[j][2] = fma((dot_t)q4.z, (dot_t)kv4.z, acc[j][2]);
              acc[j][3] = fma((dot_t)q4.w, (dot_t)kv4.w, acc[j][3]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < GMAX / 4; ++j)
          if (gq + 4 * j < G)
            Ps[gq + 4 * j][t] = acc_t(
                ((acc[j][0] + acc[j][1]) + (acc[j][2] + acc[j][3])) * scale);
      }
    }
    __syncthreads();

    // one max and one sum per query head: warp g
    if (warp < G) {
      const acc_t s0 = lane < nv ? Ps[warp][lane] : NEG_INF;
      const acc_t s1 = lane + 32 < nv ? Ps[warp][lane + 32] : NEG_INF;
      const acc_t mx = warp_max(fmax(s0, s1));
      const acc_t p0 = lane < nv ? exp(s0 - mx) : acc_t(0);
      const acc_t p1 = lane + 32 < nv ? exp(s1 - mx) : acc_t(0);
      Ps[warp][lane] = p0;
      Ps[warp][lane + 32] = p1;
      const acc_t l = warp_sum(p0 + p1);
      if (lane == 0) {
        ml_bk[(c * G + warp) * 2] = mx;
        ml_bk[(c * G + warp) * 2 + 1] = l;
      }
    }
    __syncthreads();

    // P V: thread per (g, d)
    for (int i = tid; i < G * HD; i += NT) {
      const int g = i / HD, d = i % HD;
      // four partial sums (positions t mod 4): short f32 chains
      acc_t a[4] = {};
      int t = 0;
      for (; t + 4 <= nv; t += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          a[u] = fma(Ps[g][t + u], (acc_t)Vs[(t + u) * LDS + d], a[u]);
      }
#pragma unroll
      for (int u = 0; u < 3; ++u)
        if (t + u < nv)
          a[u] = fma(Ps[g][t + u], (acc_t)Vs[(t + u) * LDS + d], a[u]);
      acc_bk[(long long)c * G * HD + i] = (a[0] + a[1]) + (a[2] + a[3]);
    }
  }

  // ticket: the last block of this (b, kv-head) merges. The barrier orders
  // the block's partial writes before thread 0's fence, which makes them
  // visible on the device before its ticket; the merging block fences
  // again before it reads (L2, past L1)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(&tickets[bk], 1) == nch - 1;
    if (s_last) __threadfence();
  }
  __syncthreads();
  if (!s_last) return;

  // merge the live chunks in order 0..n_live-1, CH chunks a batch: a
  // batch's (m, l) read at once, its weights exp(m_c - M) against the
  // running max M (the sums so far rescaled when M grows), then its
  // partials, 16 loads in flight per thread
  const int n_live = last < 0 ? 0 : min(last / CH + 1, nch);
  constexpr int R = (GMAX * HD + NT - 1) / NT;
  constexpr int U = 16;
  __shared__ acc_t Mrun[GMAX], Resc[GMAX];
  acc_t A[R], L[R];
#pragma unroll
  for (int r = 0; r < R; ++r) A[r] = L[r] = acc_t(0);
  if (tid < GMAX) Mrun[tid] = NEG_INF;
  for (int cb = 0; cb < n_live; cb += CH) {
    const int nb = min(CH, n_live - cb);
    __syncthreads();
    for (int i = tid; i < nb * G; i += NT) {
      const int cc = i / G, g = i % G;
      const acc_t* ml = ml_bk + ((cb + cc) * G + g) * 2;
      Ps[g][cc] = __ldcg(ml);
      Ls[g][cc] = __ldcg(ml + 1);
    }
    __syncthreads();
    if (warp < G) {
      acc_t bm = NEG_INF;
      for (int cc = lane; cc < nb; cc += 32) bm = fmax(bm, Ps[warp][cc]);
      const acc_t Mn = fmax(Mrun[warp], warp_max(bm));
      for (int cc = lane; cc < nb; cc += 32) {
        const acc_t w = exp(Ps[warp][cc] - Mn);
        Ps[warp][cc] = w;
        Ls[warp][cc] *= w;
      }
      __syncwarp();
      if (lane == 0) {
        Resc[warp] = exp(Mrun[warp] - Mn);
        Mrun[warp] = Mn;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * NT;
      if (i < G * HD) {
        const int g = i / HD;
        A[r] *= Resc[g];
        L[r] *= Resc[g];
        const acc_t* src = acc_bk + (long long)cb * G * HD + i;
        for (int c0 = 0; c0 < nb; c0 += U) {
          acc_t x[U];
#pragma unroll
          for (int u = 0; u < U; ++u)
            x[u] = c0 + u < nb ? __ldcg(src + (long long)(c0 + u) * G * HD)
                               : acc_t(0);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (c0 + u < nb) {
              A[r] = fma(x[u], Ps[g][c0 + u], A[r]);
              L[r] += Ls[g][c0 + u];
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * NT;
    if (i < G * HD)
      st(out + ((long long)b * H + kh * G) * HD + i,
         (float)(A[r] / fmax(L[r], acc_t(1e-30))));
  }
  if (tid == 0) tickets[bk] = 0;
}

template <typename T, typename C, typename Addr>
static int dispatch(const void* q, const void* k, const void* v,
                    const void* ks, const void* vs, int scale_per_row,
                    const void* kc, const void* vc, const void* pos,
                    int per_row, void* out, int B, int H, int K, int Smax,
                    int hd, int mc, int kv0, int Kmem, Addr addr, void* ws,
                    void* tickets, cudaStream_t stream) {
  if (H % K != 0 || H / K > GMAX || kv0 < 0 || kv0 + K > Kmem)
    return (int)cudaErrorInvalidValue;
  const acc_t scale = acc_t(1.0 / sqrt((double)hd));
  dim3 grid((Smax + CH - 1) / CH, B * K);
#define FD_ARGS                                                            \
  (const T*)q, (const C*)k, (const C*)v, (const float*)ks,                 \
      (const float*)vs, scale_per_row, (const T*)kc, (const T*)vc,         \
      (const int*)pos, per_row, (T*)out, H, K, Smax, mc, kv0, Kmem, scale, \
      addr, (acc_t*)ws, (int*)tickets
  // above 48 KB of shared memory, static and dynamic together, a kernel
  // is allowed it once, at its first launch (before any graph capture: a
  // captured step runs twice first, serving/graphs.py)
#define FD_CASE(HD_)                                                        \
  case HD_: {                                                               \
    constexpr int smem = fd_smem_bytes<HD_>();                              \
    if (smem + FD_STATIC_BYTES > 48 * 1024) {                               \
      static const cudaError_t attr = cudaFuncSetAttribute(                 \
          flash_decode_kernel<T, C, HD_, Addr>,                             \
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);               \
      if (attr != cudaSuccess) return (int)attr;                            \
    }                                                                       \
    flash_decode_kernel<T, C, HD_, Addr><<<grid, NT, smem, stream>>>(       \
        FD_ARGS);                                                           \
    break;                                                                  \
  }
  switch (hd) {
    FD_CASE(16)
    FD_CASE(32)
    FD_CASE(64)
    FD_CASE(80)
    FD_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FD_CASE
#undef FD_ARGS
  return (int)cudaGetLastError();
}

template <typename Addr>
static int launch(const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, int scale_per_row, const void* kc,
                  const void* vc, const void* pos, int pos_per_row, void* out,
                  int bf16, int cache_int8, int B, int H, int K, int Smax,
                  int hd, int mc, int kv0, int Kmem, Addr addr, void* ws,
                  void* tickets, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define FD_CALL(T, C)                                                       \
  dispatch<T, C, Addr>(q, k, v, ks, vs, scale_per_row, kc, vc, pos,         \
                       pos_per_row, out, B, H, K, Smax, hd, mc, kv0, Kmem,  \
                       addr, ws, tickets, st)
  if (bf16) {
    if (cache_int8) return FD_CALL(__nv_bfloat16, int8_t);
    return FD_CALL(__nv_bfloat16, __nv_bfloat16);
  }
  if (cache_int8) return FD_CALL(float, int8_t);
  return FD_CALL(float, float);
#undef FD_CALL
}

// acc_t (f32) values of the workspace a launch over Smax positions needs:
// the partials (acc, m, l) of every chunk of every (row, kv-head)
extern "C" long long flash_decode_workspace_elems(int B, int H, int K,
                                                  int Smax, int hd) {
  return (long long)B * K * ((Smax + CH - 1) / CH) * (H / K) * (hd + 2);
}

// contiguous cache: k/v (B, Smax, Kmem, hd), heads [kv0, kv0 + K) read
// (kv0 = 0, Kmem = K: every head); ws: flash_decode_workspace_elems acc_t
// values; tickets: B*K int32 zeros
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, int scale_per_row, const void* kc, const void* vc,
    const void* pos, int pos_per_row, void* out, int bf16, int cache_int8,
    int B, int H, int K, int Smax, int hd, int mc, int kv0, int Kmem,
    void* ws, void* tickets, void* stream) {
  return launch(q, k, v, ks, vs, scale_per_row, kc, vc, pos, pos_per_row, out,
                bf16, cache_int8, B, H, K, Smax, hd, mc, kv0, Kmem,
                Contig{Smax}, ws, tickets, stream);
}

// paged pool: k/v (n_pages, ps, Kmem, hd), page_table (B, P) int32, heads
// [kv0, kv0 + K) read; ws and tickets as above with Smax = P * ps
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* ks, const void* vs, int scale_per_row, const void* kc,
    const void* vc, const void* pos, int pos_per_row, void* out, int bf16,
    int cache_int8, int B, int H, int K, int P, int ps, int hd, int mc,
    int kv0, int Kmem, void* ws, void* tickets, void* stream) {
  return launch(q, k, v, ks, vs, scale_per_row, kc, vc, pos, pos_per_row, out,
                bf16, cache_int8, B, H, K, P * ps, hd, mc, kv0, Kmem,
                Paged{(const int*)page_table, P, ps}, ws, tickets, stream);
}
