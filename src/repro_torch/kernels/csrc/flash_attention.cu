// Prefill attention with a fully visible CushionCache prefix, GQA, f32
// online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py `flash_attention` (Pallas
// `_kernel`). The JAX prefill computes the same function with
// models/common.py `_sdpa_dense` / `flash_attention_jnp`; the port runs this
// kernel in `attention_full` on the card.
//
//   q (B, H, S, hd), k/v (B, Kh, T, hd), G = H / Kh
//   key j is visible to query i  iff  j < T and (j < prefix_live or
//   prefix_len <= j <= i + R); masked scores are -1e30 (not -inf), a masked
//   p is 0, and the output is acc / max(l, 1e-30).
//
// R is the causal reach. Causal (the decoder's self-attention): T =
// prefix_len + S and R = prefix_len. Non-causal (`causal` = 0: an
// encoder's self-attention, a cross-attention over encoder states):
// prefix_len = prefix_live = 0, T >= 1 is any length, independent of S, and
// R = T, so every key j < T is visible to every query. Each query tile then
// walks all ceil(T / 64) key tiles, the last one masked per key at j < T.
// The causal path computes with R = prefix_len exactly what it computed
// before R existed: only integer bounds read R, never a float.
//
// prefix_live <= prefix_len is the cushion search's live length (the
// reference's `prefix_valid = arange(m) < live`): rows [prefix_live,
// prefix_len) of a padded prefix are seen by no query. At prefix_live =
// prefix_len (the serving path) the mask, the tiles and every bit of the
// result are those of the kernel without it. Key tiles that lie wholly in
// [prefix_live, prefix_len) are skipped; a tile that straddles the edge
// masks per key. With a non-null `lse`, each row's log-sum-exp
// (m / sqrt(hd) + ln l, natural log, f32 (B, H, S)) is written for the
// backward (flash_attention_bwd.cu); the serving path passes null.
//
// Bound on the card: bytes at smollm's prefill shape (q, k, v and out read
// or written once: 3.1 us a call at B = 4, S = 512, against 2.05 GFLOP of
// useful work that the bf16 tensor cores do in about 2 us). What holds the
// kernel back is issue and latency inside the SM (softmax, the split of P,
// barriers), not either bound. Design of the bf16 kernel (smollm's prefill
// path): one block per (b, h, 64-query tile), four warps of 16 query rows,
// three blocks a SM; the grid runs the longest (last) query tiles first.
// The Q fragments stay in registers for the whole loop. 64-key K and V
// tiles are staged in shared memory by 16-byte `cp.async` copies,
// double-buffered so that tile j + 1 loads while tile j computes, rows
// padded by 16 bytes so that `ldmatrix` (`.trans` for V) reads them without
// bank conflicts. S = Q K^T runs on `mma.sync.m16n8k16` (bf16 in, f32
// accumulate). The mask, the online softmax (row max and sum reduced over
// the quad of lanes that shares a row) and the rescale are f32 on the
// accumulator fragments, in base 2 as FlashAttention-2 does: one FFMA and
// one `ex2` per score (e^(x) = 2^(x log2 e); the accurate `expf` takes
// about a tenth longer, tools/kernel_variants.py).
//
// P V must keep the f32 function of the Pallas kernel and of the plain
// version (one bf16 ulp of the output, with a 1e-6 floor near zero): P
// rounded once to bf16, as FlashAttention-2 does, misses that for about a
// tenth of the outputs. So each p is split into three bf16 terms
// p1 = bf16(p), p2 = bf16(p - p1), p3 = bf16(p - p1 - p2) (together exact
// to f32's 24 bits), fed as A fragments straight from the accumulator
// layout, and three `mma.sync` per k-step add them into one f32
// accumulator: 4.1 GFLOP a call in all, which the tensor cores absorb (P V
// is about a quarter of the kernel's time). `wgmma` and TMA would not move
// the bytes bound and are not used.
//
// Key tiles start at absolute key 0 and step by 64 whatever the query tile,
// and tiles past the block's last visible key (q0 + 63 + prefix_len) are
// not loaded; a warp skips the tiles past its own last visible key. A
// query's result depends on no other query (a tile a row cannot see would
// scale its state by 2^0 = 1 and add 0), so a chunked or prefix-tail
// prefill gives the same rows, bit for bit, as a one-shot one. The kv-head
// is h / G, read in place; strides are passed in, so q and out may be
// (B, S, H, hd) tensors viewed as (B, H, S, hd) (rows 16-byte aligned, as
// the wrapper checks).
//
// The f32 instantiation keeps the CUDA-core kernel of the first port (one
// thread per query row, f32 FMAs): no card path runs an f32 prefill, and
// TF32 tensor cores would change the function. It was not redesigned; it
// lives in flash_attention_f32.cu, a translation unit of its own, so that
// nvcc builds it beside this file.
//
// Head dims: 16, 32, 64 and 80 (stablelm-3b's) in both dtypes, and 128 in
// bf16 (olmoe's): there the three tiles (87 KB) take dynamic shared memory
// and two blocks share a SM; the f32 kernel, whose thread holds a row of q
// and of acc in registers, stays at 80 and below.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_mma.cuh"

#define NEG_INF (-1e30f)

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), cp.async double buffering
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int TQ = 64;          // query rows per block (16 per warp)
constexpr int TK = 64;          // keys per tile
constexpr int TWARPS = 4;
constexpr int TTHREADS = TWARPS * 32;

// three blocks of 4 warps a SM: the registers fit (~160 a thread) without
// spills; a fourth block would cap them at 128 and spill in the loop. At
// head_dim 128 (olmoe) a block's tiles take 87 KB, so two blocks a SM fit
// and the registers may grow to 255 a thread; head_dim 80 (stablelm-3b)
// takes 55 KB and the same two blocks. At 80 every tiling is whole: five
// k-steps of Q K^T, ten output n-tiles (five ldmatrix.trans pairs), ten
// 16-byte chunks a row, and the padded row of 88 bf16 (176 bytes, eleven
// 16-byte units) keeps ldmatrix's eight rows on eight distinct bank groups
template <int HD>
constexpr int fa_min_blocks() { return HD > 64 ? 2 : 3; }

// the Q tile and two K and V tiles, padded rows, in dynamic shared memory
// (past the 48 KB of a static allocation at head_dim 128)
template <int HD>
constexpr int fa_smem_bytes() { return (TQ + 4 * TK) * (HD + 8) * 2; }

template <int HD>
__global__ void __launch_bounds__(TTHREADS, fa_min_blocks<HD>())
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ lse, int H, int G, int S,
                           int T_, int P, int LV, int R, long long qsb,
                           long long qsh, long long qss, long long ksb,
                           long long ksh, long long kst, long long vsb,
                           long long vsh, long long vst, long long osb,
                           long long osh, long long oss, float scale_log2) {
  constexpr int LD = HD + 8;      // padded row: ldmatrix conflict-free
  constexpr int CPR = HD / 8;     // 16-byte chunks per row
  constexpr int KS = HD / 16;     // k-steps of Q K^T
  constexpr int NO = HD / 8;      // n-tiles of the output
  constexpr int NS = TK / 8;      // n-tiles of a score tile
  extern __shared__ __align__(16) unsigned char fa_smem[];
  // Q [TQ * LD], then the two K tiles and the two V tiles [TK * LD]
  bf16* const Qs = reinterpret_cast<bf16*>(fa_smem);
  bf16* const Ks = Qs + TQ * LD;
  bf16* const Vs = Ks + 2 * TK * LD;

  // grid (B * H, query tiles), the longest (last) query tiles first
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + kh * ksh;
  const bf16* vb = v + b * vsb + kh * vsh;
  // last key any query of this tile can see is (q0 + TQ - 1) + R
  int t_end = q0 + TQ + R;
  if (t_end > T_) t_end = T_;
  // tiles [lo, lo + n_dead) lie wholly in the dead rows [LV, P) and are
  // skipped: the loop walks n_tiles - n_dead tiles, the j-th being tile(j).
  // The first tile walked holds key 0 < LV or key P, which every row sees
  // (non-causal: key 0), so every row's max is a real score after it (see
  // the softmax below). At LV = P no tile is dead.
  const int lo = (LV + TK - 1) / TK;
  const int n_dead = max(0, P / TK - lo);
  const int n_tiles = (t_end + TK - 1) / TK - n_dead;
  auto tile = [&](int j) { return j < lo ? j : j + n_dead; };

  for (int i = tid; i < TQ * CPR; i += TTHREADS) {
    const int r = i / CPR, c = i % CPR, qi = q0 + r;
    cp_async16(&Qs[r * LD + c * 8],
               qb + (long long)(qi < S ? qi : 0) * qss + c * 8, qi < S);
  }
  auto load_kv = [&](int tile, int buf) {
    for (int i = tid; i < TK * CPR; i += TTHREADS) {
      const int r = i / CPR, c = i % CPR, t = tile * TK + r;
      const bool ok = t < T_;
      const long long tt = ok ? t : 0;
      cp_async16(&Ks[(buf * TK + r) * LD + c * 8], kb + tt * kst + c * 8,
                 ok);
      cp_async16(&Vs[(buf * TK + r) * LD + c * 8], vb + tt * vst + c * 8,
                 ok);
    }
  };
  load_kv(tile(0), 0);
  cp_async_commit();

  // this lane's two rows of the warp's 16 (fragment rows g and g + 8)
  const int row0 = q0 + warp * 16 + lane / 4;
  const int row1 = row0 + 8;
  uint32_t qf[KS][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_kv(tile(j + 1), (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], &Qs[(warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8)
                                    * LD + kk * 16 + (lane / 16) * 8]);
    }
    const bf16* Kt = Ks + (j & 1) * TK * LD;
    const bf16* Vt = Vs + (j & 1) * TK * LD;
    const int t0 = tile(j) * TK;
    // a tile past the warp's last visible key (q0 + 16 warp + 15 + R) is
    // masked for all its rows: the warp skips it (a masked p is 0 and adds
    // nothing)
    if (t0 <= q0 + warp * 16 + 15 + R) {
      // S = Q K^T (f32)
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, &Kt[(np * 16 + (lane % 8) + (lane / 16) * 8) * LD
                               + kk * 16 + ((lane / 8) % 2) * 8]);
          mma_bf16(s[2 * np], qf[kk], bfr[0], bfr[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bfr[2], bfr[3]);
        }
      }

      // mask, online softmax (f32) in base 2 on the raw dot products d:
      // p = 2^(c d - c m) = e^((d - m) / sqrt(hd)) with c = log2(e) /
      // sqrt(hd), one FFMA and one ex2 per score; a tile every row of the
      // warp sees whole needs no mask
      const bool need_mask =
          t0 + TK > T_ || t0 + TK - 1 > q0 + warp * 16 + R ||
          (LV < P && t0 < P && t0 + TK > LV);
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = t0 + n * 8 + (lane % 4) * 2 + (e & 1);
          const int qi = e < 2 ? row0 : row1;
          if (need_mask &&
              !(kj < T_ && (kj < LV || (kj >= P && kj <= qi + R))))
            s[n][e] = NEG_INF;
          mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      // a masked score is -1e30 and every row sees a key of the first tile
      // walked (key 0 < LV, or key P), so mx is a real score from then on
      // and 2^(c (-1e30) - c mx) is exactly 0: a masked p is 0
      float alpha[2], ps[2] = {0.f, 0.f}, cm[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        alpha[r] = ex2(scale_log2 * (m_r[r] - mx[r]));
        cm[r] = scale_log2 * mx[r];
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = ex2(fmaf(s[n][e], scale_log2, -cm[e / 2]));
          ps[e / 2] += s[n][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
        ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
        l_r[r] = l_r[r] * alpha[r] + ps[r];
        m_r[r] = mx[r];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P V, P in three bf16 terms; the A fragment of keys
      // [16 kk, 16 kk + 16) is score n-tiles 2 kk and 2 kk + 1
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        uint32_t a[3][4];
        split3(s[2 * kk][0], s[2 * kk][1], a[0][0], a[1][0], a[2][0]);
        split3(s[2 * kk][2], s[2 * kk][3], a[0][1], a[1][1], a[2][1]);
        split3(s[2 * kk + 1][0], s[2 * kk + 1][1], a[0][2], a[1][2], a[2][2]);
        split3(s[2 * kk + 1][2], s[2 * kk + 1][3], a[0][3], a[1][3], a[2][3]);
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, &Vt[(kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8)
                                         * LD + dp * 16 + (lane / 16) * 8]);
#pragma unroll
          for (int term = 0; term < 3; ++term) {
            mma_bf16(o[2 * dp], a[term], bfr[0], bfr[1]);
            mma_bf16(o[2 * dp + 1], a[term], bfr[2], bfr[3]);
          }
        }
      }
    }
    // every warp is done with buffer j & 1 before tile j + 2 lands in it
    __syncthreads();
  }

  const float inv0 = 1.f / fmaxf(l_r[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l_r[1], 1e-30f);
  bf16* ob = out + b * osb + h * osh;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = n * 8 + (lane % 4) * 2;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * oss + d) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * oss + d) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
  if (lse && lane % 4 == 0) {
    // m_r is the raw dot product's max: ln l + m / sqrt(hd)
    const float c = scale_log2 * 0.69314718055994531f;
    float* lb = lse + (long long)bh * S;
    if (row0 < S) lb[row0] = fmaf(m_r[0], c, logf(fmaxf(l_r[0], 1e-30f)));
    if (row1 < S) lb[row1] = fmaf(m_r[1], c, logf(fmaxf(l_r[1], 1e-30f)));
  }
}

// ---------------------------------------------------------------------------

#define FA_ARGS(T)                                                          \
  (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, H, G, S, T_, P, LV,  \
      R,                                                                     \
      str[0], str[1], str[2], str[3], str[4], str[5], str[6], str[7],        \
      str[8], str[9], str[10], str[11], scale

// the f32 instantiation's dispatch (flash_attention_f32.cu, compiled beside
// this file)
int flash_attention_dispatch_f32(const void* q, const void* k, const void* v,
                                 void* out, float* lse, int B, int H, int Kh,
                                 int S, int T_, int hd, int P, int LV, int R,
                                 const long long* str, cudaStream_t stream);

// one launch of the bf16 kernel; above 48 KB of dynamic shared memory the
// kernel is allowed it once, at its first launch (before any graph capture:
// a captured step runs twice first, serving/graphs.py)
template <int HD, typename... Args>
static int launch_mma(dim3 grid, cudaStream_t stream, Args... args) {
  constexpr int smem = fa_smem_bytes<HD>();
  if (smem > 48 * 1024) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_attention_mma_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  flash_attention_mma_kernel<HD><<<grid, TTHREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

static int dispatch_bf16(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int H, int Kh, int S,
                         int T_, int hd, int P, int LV, int R,
                         const long long* str, cudaStream_t stream) {
  dim3 grid(B * H, (S + TQ - 1) / TQ);
  const int G = H / Kh;
  // the kernel works in base 2: log2(e) / sqrt(hd)
  const float scale = (float)(1.4426950408889634 / sqrt((double)hd));
  switch (hd) {
    case 16: return launch_mma<16>(grid, stream, FA_ARGS(bf16));
    case 32: return launch_mma<32>(grid, stream, FA_ARGS(bf16));
    case 64: return launch_mma<64>(grid, stream, FA_ARGS(bf16));
    case 80: return launch_mma<80>(grid, stream, FA_ARGS(bf16));
    case 128: return launch_mma<128>(grid, stream, FA_ARGS(bf16));
    default: return (int)cudaErrorInvalidValue;
  }
}
#undef FA_ARGS

// causal = 0: every key j < T is visible to every query (prefix_len and
// prefix_live must be 0)
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int bf16_in, int causal, int B, int H, int Kh, int S, int T_, int hd,
    int prefix_len, int prefix_live, long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
    long long kst, long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long oss, void* stream) {
  const long long str[12] = {qsb, qsh, qss, ksb, ksh, kst,
                             vsb, vsh, vst, osb, osh, oss};
  cudaStream_t st = (cudaStream_t)stream;
  if (prefix_live < 0 || prefix_live > prefix_len || T_ < 1 ||
      (!causal && prefix_len != 0))
    return (int)cudaErrorInvalidValue;
  const int R = causal ? prefix_len : T_;
  float* l = (float*)lse;
  if (bf16_in)
    return dispatch_bf16(q, k, v, out, l, B, H, Kh, S, T_, hd, prefix_len,
                         prefix_live, R, str, st);
  return flash_attention_dispatch_f32(q, k, v, out, l, B, H, Kh, S, T_, hd,
                                      prefix_len, prefix_live, R, str, st);
}
