// Backward of prefill attention with a CushionCache prefix and a live-length
// key mask: dQ, dK and dV of flash_attention.cu's function, f32 CUDA cores.
//
// Replaces: nothing in Pallas. The reference differentiates its jnp
// attention (models/common.py `_sdpa_dense`, `flash_attention_jnp`) with
// jax.grad when core/cushioncache.py `prefix_tune` trains the cushion KV;
// the port's card path runs the flash_attention kernel, so the kernel needs
// a gradient of its own.
//
//   q, o, dO (B, H, S, hd); k, v (B, Kh, T, hd); G = H / Kh; lse (B, H, S)
//   f32, the forward's per-row natural log-sum-exp; scale = 1 / sqrt(hd)
//   key j visible to query i iff j < T and (j < LV or P <= j <= i + P)
//   p_ij = exp(scale q_i.k_j - lse_i) where visible, else 0
//   D_i = sum_d dO_id O_id
//   dV_j = sum_i p_ij dO_i      dS_ij = p_ij (dO_i.v_j - D_i)
//   dK_j = scale sum_i dS_ij q_i      dQ_i = scale sum_j dS_ij k_j
//   summed over the G query heads of kv-head j's group for dK and dV.
//
// Three kernels in one launch: `attn_bwd_delta` (D, one warp a row, into a
// workspace), `attn_bwd_dkdv` (one block owns 32 keys of one kv-head and
// walks the G query heads and every query tile that sees them: no atomics,
// deterministic) and `attn_bwd_dq` (one block owns 32 query rows of one head
// and walks the key tiles they see). Accumulation is f32; the outputs take
// the inputs' dtype (f32 or bf16). A key row in [LV, P) is seen by no query
// and gets an exact zero dK and dV.
//
// Bound on the card: at the tuning shape (smollm-360m, B = 2, S = 256,
// m = 4, hd = 64) about 0.25 GFLOP of products a call, ~4 us on the bf16
// tensor cores, against ~2 MB of inputs and outputs (~0.6 us). This first
// version runs the products on the f32 CUDA cores from shared-memory tiles
// (each p and dS is recomputed from q, k and lse, FlashAttention-2's
// recomputation, so no (S, T) matrix is stored): simple and right first, a
// tensor-core version is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// (b, head, row) strides of q, k, v, o, dout, dq, dk, dv, passed by value
struct Strides {
  long long q[3], k[3], v[3], o[3], d[3], dq[3], dk[3], dv[3];
};

constexpr int BT = 32;          // rows of a tile (keys or queries)
constexpr int NT = 256;         // threads a block
constexpr int TPR = NT / BT;    // threads per tile row: 8

__device__ __forceinline__ bool visible(int i, int j, int T_, int P, int LV) {
  return j < T_ && (j < LV || (j >= P && j <= i + P));
}

// strided (B, X, R, hd) rows [r0, r0 + BT) into s[BT][HD + 1] as f32; rows
// past n read as 0
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float (*s)[HD + 1], const T* base,
                                          long long rs, int r0, int n) {
  for (int e = threadIdx.x; e < BT * HD; e += NT) {
    const int r = e / HD, d = e % HD, row = r0 + r;
    s[r][d] = row < n ? ld(base + (long long)row * rs + d) : 0.f;
  }
}

// D = rowsum(dO * O): one warp a row
template <typename T>
__global__ void attn_bwd_delta(const T* __restrict__ o,
                               const T* __restrict__ dout,
                               float* __restrict__ delta, int H, int S,
                               int hd, long long n_rows, Strides str) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32)
                        + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const int i = (int)(row % S);
  const int h = (int)((row / S) % H);
  const int b = (int)(row / ((long long)S * H));
  const T* op = o + b * str.o[0] + h * str.o[1] + i * str.o[2];
  const T* dp = dout + b * str.d[0] + h * str.d[1] + i * str.d[2];
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += ld(op + d) * ld(dp + d);
#pragma unroll
  for (int s = 16; s > 0; s /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[row] = acc;
}

// dK, dV of 32 keys of one kv-head: grid (key tiles, B * Kh)
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
attn_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, int H, int Kh, int S,
              int T_, int P, int LV, Strides str, float scale) {
  constexpr int NPT = HD / TPR;     // output dims a thread
  __shared__ float Ks[BT][HD + 1], Vs[BT][HD + 1];
  __shared__ float Qs[BT][HD + 1], Ds[BT][HD + 1];
  __shared__ float Ps[BT][BT + 1], Ss[BT][BT + 1];
  __shared__ float lse_s[BT], del_s[BT];
  const int t0 = blockIdx.x * BT;
  const int b = blockIdx.y / Kh, kh = blockIdx.y % Kh, G = H / Kh;
  const int tid = threadIdx.x;
  // this thread's outputs: key r = tid / TPR, dims d = tid % TPR + TPR u
  const int r = tid / TPR, c = tid % TPR;
  const long long *sq = str.q, *sk = str.k, *sv = str.v, *sd = str.d;
  const long long *sdk = str.dk, *sdv = str.dv;

  float ak[NPT], av[NPT];
#pragma unroll
  for (int u = 0; u < NPT; ++u) ak[u] = av[u] = 0.f;

  // a tile wholly in the dead rows [LV, P) is seen by no query: zeros
  const bool dead = t0 >= LV && t0 + BT <= P;
  if (!dead) {
    load_tile<T, HD>(Ks, k + b * sk[0] + kh * sk[1], sk[2], t0, T_);
    load_tile<T, HD>(Vs, v + b * sv[0] + kh * sv[1], sv[2], t0, T_);
    // the first query that sees a key of this tile: all of them where the
    // tile holds a live prefix key, else the query whose diagonal reaches
    // the tile's first key
    const int i_first = t0 < LV ? 0 : max(0, t0 - P);
    for (int g = 0; g < G; ++g) {
      const int h = kh * G + g;
      const long long bh = (long long)b * H + h;
      for (int i0 = (i_first / BT) * BT; i0 < S; i0 += BT) {
        __syncthreads();      // the previous tile's readers are done
        load_tile<T, HD>(Qs, q + b * sq[0] + h * sq[1], sq[2], i0, S);
        load_tile<T, HD>(Ds, dout + b * sd[0] + h * sd[1], sd[2], i0, S);
        if (tid < BT) {
          const int i = i0 + tid;
          lse_s[tid] = i < S ? lse[bh * S + i] : 0.f;
          del_s[tid] = i < S ? delta[bh * S + i] : 0.f;
        }
        __syncthreads();
        // p and dS of (query qi = tid / TPR, keys tid % TPR + TPR u)
#pragma unroll
        for (int u = 0; u < BT / TPR; ++u) {
          const int qi = tid / TPR, kj = tid % TPR + TPR * u;
          float p = 0.f, ds = 0.f;
          if (i0 + qi < S && visible(i0 + qi, t0 + kj, T_, P, LV)) {
            float sqk = 0.f, dpv = 0.f;
#pragma unroll 16
            for (int d = 0; d < HD; ++d) {
              sqk = fmaf(Qs[qi][d], Ks[kj][d], sqk);
              dpv = fmaf(Ds[qi][d], Vs[kj][d], dpv);
            }
            p = expf(sqk * scale - lse_s[qi]);
            ds = p * (dpv - del_s[qi]);
          }
          Ps[qi][kj] = p;
          Ss[qi][kj] = ds;
        }
        __syncthreads();
#pragma unroll 8
        for (int i = 0; i < BT; ++i) {
          const float p = Ps[i][r], ds = Ss[i][r];
#pragma unroll
          for (int u = 0; u < NPT; ++u) {
            av[u] = fmaf(p, Ds[i][c + TPR * u], av[u]);
            ak[u] = fmaf(ds, Qs[i][c + TPR * u], ak[u]);
          }
        }
      }
    }
  }
  const int j = t0 + r;
  if (j < T_) {
    T* kp = dk + b * sdk[0] + kh * sdk[1] + (long long)j * sdk[2];
    T* vp = dv + b * sdv[0] + kh * sdv[1] + (long long)j * sdv[2];
#pragma unroll
    for (int u = 0; u < NPT; ++u) {
      st(kp + c + TPR * u, ak[u] * scale);
      st(vp + c + TPR * u, av[u]);
    }
  }
}

// dQ of 32 query rows of one head: grid (query tiles, B * H)
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dq, int H, int Kh, int S, int T_, int P, int LV,
            Strides str, float scale) {
  constexpr int NPT = HD / TPR;
  __shared__ float Qs[BT][HD + 1], Ds[BT][HD + 1];
  __shared__ float Ks[BT][HD + 1], Vs[BT][HD + 1];
  __shared__ float Ss[BT][BT + 1];
  __shared__ float lse_s[BT], del_s[BT];
  const int i0 = blockIdx.x * BT;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / (H / Kh);
  const long long bh = (long long)b * H + h;
  const int tid = threadIdx.x;
  const int r = tid / TPR, c = tid % TPR;
  const long long *sq = str.q, *sk = str.k, *sv = str.v, *sd = str.d;
  const long long* sdq = str.dq;

  load_tile<T, HD>(Qs, q + b * sq[0] + h * sq[1], sq[2], i0, S);
  load_tile<T, HD>(Ds, dout + b * sd[0] + h * sd[1], sd[2], i0, S);
  if (tid < BT) {
    const int i = i0 + tid;
    lse_s[tid] = i < S ? lse[bh * S + i] : 0.f;
    del_s[tid] = i < S ? delta[bh * S + i] : 0.f;
  }
  float aq[NPT];
#pragma unroll
  for (int u = 0; u < NPT; ++u) aq[u] = 0.f;
  // the last key any row of the tile sees is (i0 + BT - 1) + P
  const int t_end = min(T_, i0 + BT + P);
  for (int t0 = 0; t0 < t_end; t0 += BT) {
    if (t0 >= LV && t0 + BT <= P) continue;     // wholly dead rows
    __syncthreads();          // the previous tile's readers are done
    load_tile<T, HD>(Ks, k + b * sk[0] + kh * sk[1], sk[2], t0, T_);
    load_tile<T, HD>(Vs, v + b * sv[0] + kh * sv[1], sv[2], t0, T_);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < BT / TPR; ++u) {
      const int qi = tid / TPR, kj = tid % TPR + TPR * u;
      float ds = 0.f;
      if (i0 + qi < S && visible(i0 + qi, t0 + kj, T_, P, LV)) {
        float sqk = 0.f, dpv = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) {
          sqk = fmaf(Qs[qi][d], Ks[kj][d], sqk);
          dpv = fmaf(Ds[qi][d], Vs[kj][d], dpv);
        }
        const float p = expf(sqk * scale - lse_s[qi]);
        ds = p * (dpv - del_s[qi]);
      }
      Ss[qi][kj] = ds;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < BT; ++j) {
      const float ds = Ss[r][j];
#pragma unroll
      for (int u = 0; u < NPT; ++u)
        aq[u] = fmaf(ds, Ks[j][c + TPR * u], aq[u]);
    }
  }
  const int i = i0 + r;
  if (i < S) {
    T* qp = dq + b * sdq[0] + h * sdq[1] + (long long)i * sdq[2];
#pragma unroll
    for (int u = 0; u < NPT; ++u) st(qp + c + TPR * u, aq[u] * scale);
  }
}

template <typename T, int HD>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* delta, void* dq, void* dk,
        void* dv, int B, int H, int Kh, int S, int T_, int P, int LV,
        const Strides& str, cudaStream_t st) {
  const float scale = (float)(1.0 / sqrt((double)HD));
  const long long rows = (long long)B * H * S;
  attn_bwd_delta<T><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const T*)o, (const T*)dout, delta, H, S, HD, rows, str);
  int err = (int)cudaGetLastError();
  if (err) return err;
  dim3 g_kv((T_ + BT - 1) / BT, B * Kh);
  attn_bwd_dkdv<T, HD><<<g_kv, NT, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, H, Kh, S, T_, P, LV, str, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  dim3 g_q((S + BT - 1) / BT, B * H);
  attn_bwd_dq<T, HD><<<g_q, NT, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, H, Kh, S, T_, P, LV, str, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// strides (24 int64, host memory): q, k, v, o, dout, dq, dk, dv, each
// (b, head, row); `delta` is a (B, H, S) f32 workspace
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int bf16_in, int B, int H, int Kh, int S, int T_, int hd,
    int prefix_len, int prefix_live, const long long* strides,
    void* stream) {
  if (prefix_live < 0 || prefix_live > prefix_len || H % Kh)
    return (int)cudaErrorInvalidValue;
  Strides str;
  long long* dst[8] = {str.q, str.k, str.v, str.o, str.d, str.dq, str.dk,
                       str.dv};
  for (int t = 0; t < 8; ++t)
    for (int a = 0; a < 3; ++a) dst[t][a] = strides[3 * t + a];
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
#define BWD(T, HD)                                                          \
  run<T, HD>(q, k, v, o, dout, l, dl, dq, dk, dv, B, H, Kh, S, T_,          \
             prefix_len, prefix_live, str, st)
  if (bf16_in) {
    switch (hd) {
      case 16: return BWD(__nv_bfloat16, 16);
      case 32: return BWD(__nv_bfloat16, 32);
      case 64: return BWD(__nv_bfloat16, 64);
    }
  } else {
    switch (hd) {
      case 16: return BWD(float, 16);
      case 32: return BWD(float, 32);
      case 64: return BWD(float, 64);
    }
  }
#undef BWD
  return (int)cudaErrorInvalidValue;
}
