// Backward of prefill attention with a CushionCache prefix and a live-length
// key mask: dQ, dK and dV of flash_attention.cu's function.
//
// Replaces: nothing in Pallas. The reference differentiates its jnp
// attention (models/common.py `_sdpa_dense`, `flash_attention_jnp`) with
// jax.grad when core/cushioncache.py `prefix_tune` trains the cushion KV;
// the port's card path runs the flash_attention kernel, so the kernel needs
// a gradient of its own.
//
//   q, o, dO (B, H, S, hd); k, v (B, Kh, T, hd); G = H / Kh; lse (B, H, S)
//   f32, the forward's per-row natural log-sum-exp; scale = 1 / sqrt(hd)
//   key j visible to query i iff j < T and (j < LV or P <= j <= i + R)
//   R the causal reach: P causal (T = P + S); T non-causal (`causal` = 0,
//   P = LV = 0, any T >= 1: every key visible to every query, so a dQ block
//   walks every key tile below T and a dK/dV block takes every query tile
//   in its chunks). Only integer bounds read R: the causal path computes
//   what it computed before R existed
//   p_ij = exp(scale q_i.k_j - lse_i) where visible, else 0
//   D_i = sum_d dO_id O_id
//   dV_j = sum_i p_ij dO_i      dS_ij = p_ij (dO_i.v_j - D_i)
//   dK_j = scale sum_i dS_ij q_i      dQ_i = scale sum_j dS_ij k_j
//   summed over the G query heads of kv-head j's group for dK and dV.
// Accumulation is f32; the outputs take the inputs' dtype (f32 or bf16). A
// key row in [LV, P) is seen by no query and gets an exact zero dK and dV.
//
// Bound on the card, counted as chip_smoke.py counts it: at the tuning
// shape (smollm-360m, B = 2, S = 256, m = 4, 15 / 5 heads of 64) ~1.02 M
// visible pairs a call and 10 hd operations a pair (Q K^T and dO V^T
// recomputed, dV, dK, dQ): 0.65 GFLOP, 0.66 us on the bf16 tensor cores;
// q, k, v, o, dO and lse read once and dq, dk, dv written once: 5.3 MB,
// 1.6 us. Bytes bound it.
//
// bf16 (the tuning path): the products on the tensor cores, no atomics,
// deterministic, two kernels in one launch:
// 1. `attn_bwd_delta_bf16`: D, hd / 8 lanes a row, into the workspace. It
//    lets the next kernel start at once (programmatic dependent launch):
//    that kernel's blocks stage their first tiles meanwhile and wait for D
//    (`griddepcontrol.wait`) before they read it.
// 2. `attn_bwd_mma`: one grid of 4-warp blocks of two kinds, three a SM, so
//    that a small problem fills the card (at the tuning shape 120 + 300
//    blocks on 132 SMs, where the CUDA-core version ran 90 long blocks):
//    - a dQ block owns 64 query rows (16 a warp) of one (b, h) and walks
//      the key tiles they see as the forward does, Q and dO fragments in
//      registers, K and V double-buffered by 16-byte `cp.async` copies
//      (rows padded for `ldmatrix`): S = Q K^T and dP = dO V^T on
//      `mma.sync.m16n8k16` (bf16 in, f32 accumulate: the products are
//      exact, only the order of the sums differs from the plain version),
//      p = 2^(c s - lse log2 e) and dS = p (dP - D) in f32 on the
//      accumulator fragments, dQ += dS K with dS taken straight from the
//      accumulator layout as A fragments (K read by `ldmatrix.trans`). It
//      recomputes S and dP rather than read a stored dS. The longest (last)
//      query tiles run first.
//    - a dK/dV block owns 64 keys (16 a warp) of one (b, query head) and a
//      chunk (one of QCHUNKS) of the query tiles that see them: K and V
//      fragments in registers, Q and dO double-buffered, S^T = K Q^T,
//      dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q (Q and dO read
//      transposed). The G heads and the chunks of one (b, kv-head, key
//      tile) form one thread block cluster; at the end each block puts its
//      f32 dK and dV in its shared memory and the cluster sums them in rank
//      order (head, then chunk) through distributed shared memory, a
//      share of the keys a block, into the output dtype. The longest key
//      tiles (the first: every query sees the prefix) run first.
// P and dS are f32; before P^T dO, dS^T Q and dS K each is split into bf16
// terms, x1 = bf16(x), x2 = bf16(x - x1) (`split_terms`,
// attention_mma.cuh), as the forward splits P in three. One term misses the
// one-bf16-ulp bar for about a tenth of the outputs; two hold it, as three
// do (tests/test_torch_attention_split.py; tools/kernel_variants.py on the
// card), so P_TERMS and DS_TERMS are 2. The kernel is latency-bound, not
// bound by its products: the terms, the order in which the `mma.sync` of
// the terms issue, and the dK product barely move its time (PERF.md §6).
//
// f32 keeps the first port's CUDA-core kernels (`attn_bwd_delta`, one warp
// a row; `attn_bwd_dkdv`, a block per 32 keys of a kv-head walking its G
// heads; `attn_bwd_dq`, a block per 32 query rows): TF32 tensor cores
// would change the function. The card runs f32 tuning on paper_tiny only.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "attention_mma.cuh"

namespace {

// (b, head, row) strides of q, k, v, o, dout, dq, dk, dv, passed by value
struct Strides {
  long long q[3], k[3], v[3], o[3], d[3], dq[3], dk[3], dv[3];
};

__device__ __forceinline__ bool visible(int i, int j, int T_, int P, int LV,
                                        int R) {
  return j < T_ && (j < LV || (j >= P && j <= i + R));
}

// D = rowsum(dO * O) of f32 rows: one warp a row
__global__ void attn_bwd_delta(const float* __restrict__ o,
                               const float* __restrict__ dout,
                               float* __restrict__ delta, int H, int S,
                               int hd, long long n_rows, Strides str) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32)
                        + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const int i = (int)(row % S);
  const int h = (int)((row / S) % H);
  const int b = (int)(row / ((long long)S * H));
  const float* op = o + b * str.o[0] + h * str.o[1] + i * str.o[2];
  const float* dp = dout + b * str.d[0] + h * str.d[1] + i * str.d[2];
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += op[d] * dp[d];
#pragma unroll
  for (int s = 16; s > 0; s /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

// lanes a row of attn_bwd_delta_bf16: hd / 8 rounded up to a power of two
// (16 at head_dim 80), so that a row's lanes lie in one warp and sum by
// butterfly shuffles; the lanes past hd / 8 add zeros
__host__ __device__ constexpr int delta_lanes(int hd) {
  return hd / 8 <= 2 ? 2 : 2 * delta_lanes((hd / 8 + 1) / 2 * 8);
}

// D = rowsum(dO * O): delta_lanes(hd) lanes a row, one 16-byte
// load of each a lane below hd / 8 (rows 16-byte aligned, as the wrapper
// ensures). The kernel launched after it may start at once (programmatic
// dependent launch): its blocks stage their tiles meanwhile and wait for D
// before they read it.
__global__ void attn_bwd_delta_bf16(const bf16* __restrict__ o,
                                    const bf16* __restrict__ dout,
                                    float* __restrict__ delta, int H, int S,
                                    int hd, long long n_rows, Strides str) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lpr = delta_lanes(hd);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = idx / lpr;
  const int part = (int)(idx % lpr);
  float acc = 0.f;
  if (row < n_rows && part < hd / 8) {
    const int i = (int)(row % S);
    const int h = (int)((row / S) % H);
    const int b = (int)(row / ((long long)S * H));
    const uint4 x = *reinterpret_cast<const uint4*>(
        o + b * str.o[0] + h * str.o[1] + i * str.o[2] + 8 * part);
    const uint4 y = *reinterpret_cast<const uint4*>(
        dout + b * str.d[0] + h * str.d[1] + i * str.d[2] + 8 * part);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      acc = fmaf(bf16_lo(xs[w]), bf16_lo(ys[w]), acc);
      acc = fmaf(bf16_hi(xs[w]), bf16_hi(ys[w]), acc);
    }
  }
  for (int s = lpr / 2; s > 0; s /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (part == 0 && row < n_rows) delta[row] = acc;
}

constexpr int TILE = 64;            // keys or queries of a block and a step
constexpr int MWARPS = 4;           // 16 rows of the block's 64 a warp
constexpr int MTHREADS = MWARPS * 32;
constexpr int P_TERMS = 2;          // bf16 terms of P in dV += P^T dO
constexpr int DS_TERMS = 2;         // of dS in dK += dS^T Q and dQ += dS K
constexpr int QCHUNKS = 2;          // dK/dV blocks a (head group, key tile)
constexpr float LOG2E = 1.4426950408889634f;

struct MmaArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  int B, H, Kh, G, GB, NC, S, T, P, LV, R, n_q_blocks, n_q_pad;
  float scale, scale_log2;
  Strides str;
};

// programmatic dependent launch: the backward's grid starts while the D
// kernel runs; a block waits here until D is written and visible
__device__ __forceinline__ void wait_for_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// 4-byte global -> shared copy; a false predicate writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// 64 rows [r0, r0 + 64) of a (row stride rs) matrix into a padded tile by
// 16-byte cp.async copies; rows past n are zeros
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* base,
                                           long long rs, int r0, int n) {
  constexpr int LD = HD + 8, CPR = HD / 8;
  for (int i = threadIdx.x; i < TILE * CPR; i += MTHREADS) {
    const int r = i / CPR, c = i % CPR, row = r0 + r;
    cp_async16(&dst[r * LD + c * 8],
               base + (long long)(row < n ? row : 0) * rs + c * 8, row < n);
  }
}

// the A fragments (16 rows of this warp, all HD columns) of a staged tile
template <int HD>
__device__ __forceinline__ void a_frags(uint32_t (&f)[HD / 16][4],
                                        const bf16* t, int warp, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(f[kk], &t[(warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD
                          + kk * 16 + (lane / 16) * 8]);
}

// c0 (16 x 64) += a0 (16 x HD, fragments) * t0^T and c1 += a1 * t1^T,
// t0 and t1 staged 64 x HD tiles whose rows are the 64 output columns; the
// two products interleaved, so that 16 independent accumulators lie
// between two `mma.sync` of one chain
template <int HD>
__device__ __forceinline__ void mma_abt2(float (&c0)[TILE / 8][4],
                                         const uint32_t (&a0)[HD / 16][4],
                                         const bf16* t0,
                                         float (&c1)[TILE / 8][4],
                                         const uint32_t (&a1)[HD / 16][4],
                                         const bf16* t1, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int np = 0; np < TILE / 16; ++np) {
      const int off = (np * 16 + (lane % 8) + (lane / 16) * 8) * LD
                      + kk * 16 + ((lane / 8) % 2) * 8;
      uint32_t b0[4], b1[4];
      ldmatrix_x4(b0, &t0[off]);
      ldmatrix_x4(b1, &t1[off]);
      mma_bf16(c0[2 * np], a0[kk], b0[0], b0[1]);
      mma_bf16(c1[2 * np], a1[kk], b1[0], b1[1]);
      mma_bf16(c0[2 * np + 1], a0[kk], b0[2], b0[3]);
      mma_bf16(c1[2 * np + 1], a1[kk], b1[2], b1[3]);
    }
}

// the A fragments of 16 columns [16 kk, 16 kk + 16) of x (16 x 64, f32
// accumulator layout: score n-tiles 2 kk and 2 kk + 1), split into N bf16
// terms
template <int N>
__device__ __forceinline__ void a_terms(uint32_t (&a)[N][4],
                                        const float (&x)[TILE / 8][4],
                                        int kk) {
  uint32_t t[4][N];
  split_terms<N>(x[2 * kk][0], x[2 * kk][1], t[0]);
  split_terms<N>(x[2 * kk][2], x[2 * kk][3], t[1]);
  split_terms<N>(x[2 * kk + 1][0], x[2 * kk + 1][1], t[2]);
  split_terms<N>(x[2 * kk + 1][2], x[2 * kk + 1][3], t[3]);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[n][r] = t[r][n];
}

// c0 (16 x HD) += x0 (16 x 64, accumulator layout, in N0 bf16 terms) * t0
// and, with x1, c1 += x1 * t1 (N1 terms), t0 and t1 staged 64 x HD tiles
// read transposed; each k-step issues every accumulator's term before the
// next term, so HD / 4 (two products) or HD / 8 independent accumulators
// lie between two `mma.sync` of one chain
template <int HD, int N0, int N1>
__device__ __forceinline__ void mma_xt2(float (&c0)[HD / 8][4],
                                        const float (&x0)[TILE / 8][4],
                                        const bf16* t0,
                                        float (&c1)[HD / 8][4],
                                        const float (&x1)[TILE / 8][4],
                                        const bf16* t1, int lane) {
  constexpr int LD = HD + 8, NMAX = N0 > N1 ? N0 : N1;
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    uint32_t a0[N0 > 0 ? N0 : 1][4], a1[N1 > 0 ? N1 : 1][4];
    uint32_t b0[HD / 16][4], b1[HD / 16][4];
    if constexpr (N0 > 0) a_terms<N0>(a0, x0, kk);
    if constexpr (N1 > 0) a_terms<N1>(a1, x1, kk);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      const int off = (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD
                      + dp * 16 + (lane / 16) * 8;
      if constexpr (N0 > 0) ldmatrix_x4_trans(b0[dp], &t0[off]);
      if constexpr (N1 > 0) ldmatrix_x4_trans(b1[dp], &t1[off]);
    }
#pragma unroll
    for (int term = 0; term < NMAX; ++term)
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        if (term < N0) {
          mma_bf16(c0[2 * dp], a0[term], b0[dp][0], b0[dp][1]);
          mma_bf16(c0[2 * dp + 1], a0[term], b0[dp][2], b0[dp][3]);
        }
        if (term < N1) {
          mma_bf16(c1[2 * dp], a1[term], b1[dp][0], b1[dp][1]);
          mma_bf16(c1[2 * dp + 1], a1[term], b1[dp][2], b1[dp][3]);
        }
      }
  }
}

// c (16 x HD) += x (16 x 64, accumulator layout, in N bf16 terms) * t
template <int HD, int N>
__device__ __forceinline__ void mma_xt(float (&c)[HD / 8][4],
                                       const float (&x)[TILE / 8][4],
                                       const bf16* t, int lane) {
  mma_xt2<HD, N, 0>(c, x, t, c, x, t, lane);
}

// dK, dV of 64 keys of one (b, kv-head): the block of head group gi and
// query chunk c walks the G / GB heads of its group one after another,
// each over its chunk of the query tiles that see the keys; the GB * NC
// blocks of the kv-head (one thread block cluster) sum their dK and dV in
// rank order (head group, then chunk) through distributed shared memory
template <int HD>
__device__ __forceinline__ void dkdv_block(const MmaArgs& A, int blk,
                                           bf16* tiles, float* rowv) {
  constexpr int NO = HD / 8, NS = TILE / 8, TS = TILE * (HD + 8);
  const int CS = A.GB * A.NC;                    // blocks a cluster
  const int per_tile = A.B * A.Kh * CS;
  const int t0 = blk / per_tile * TILE;          // tile 0 (longest) first
  const int r = blk % per_tile, rank = r % CS;
  const int b = r / (A.Kh * CS), kh = r / CS % A.Kh;
  const int gi = rank / A.NC, c = rank % A.NC;
  const int hpb = A.G / A.GB, h_lo = kh * A.G + gi * hpb;
  const int S = A.S, T_ = A.T, P = A.P, LV = A.LV, R = A.R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kw0 = t0 + warp * 16;                // the warp's first key
  const Strides& st = A.str;
  // stage s: Q and dO in tiles 2 s and 2 s + 1, the log-sum-exps and D of
  // its 64 rows in rowv[2 s] and rowv[2 s + 1]
  auto tile = [&](int i) { return tiles + i * TS; };

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // the query tiles that see a key of the tile: from the first (every
  // query where it holds a live prefix key, else the one whose diagonal
  // reaches t0) to the last, in NC chunks; this block's chunk starts at
  // q_lo and has nqc tiles. A tile wholly in the dead rows [LV, P) is seen
  // by no query: zeros
  const int qt0 = (t0 < LV ? 0 : max(0, t0 - R)) / TILE;
  const int nq = (S + TILE - 1) / TILE - qt0;
  const int cs = (nq + A.NC - 1) / A.NC, q_lo = qt0 + c * cs;
  const int nqc = max(0, min(nq - c * cs, cs));
  const int n_steps = t0 >= LV && t0 + TILE <= P ? 0 : hpb * nqc;
  if (n_steps > 0) {
    auto load_step = [&](int j, int s) {
      const int h = h_lo + j / nqc, i0 = (q_lo + j % nqc) * TILE;
      stage_rows<HD>(tile(2 * s), A.q + b * st.q[0] + h * st.q[1], st.q[2],
                     i0, S);
      stage_rows<HD>(tile(2 * s + 1), A.dout + b * st.d[0] + h * st.d[1],
                     st.d[2], i0, S);
      if (tid < TILE) {
        const bool ok = i0 + tid < S;
        const long long row = ok ? ((long long)b * A.H + h) * S + i0 + tid : 0;
        cp_async4(&rowv[2 * s * TILE + tid], A.lse + row, ok);
        cp_async4(&rowv[(2 * s + 1) * TILE + tid], A.delta + row, ok);
      }
    };
    // K and V through stage 1's tiles, then into registers for the walk
    stage_rows<HD>(tile(2), A.k + b * st.k[0] + kh * st.k[1], st.k[2], t0,
                   T_);
    stage_rows<HD>(tile(3), A.v + b * st.v[0] + kh * st.v[1], st.v[2], t0,
                   T_);
    wait_for_prerequisites();
    load_step(0, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    uint32_t kf[HD / 16][4], vf[HD / 16][4];
    a_frags<HD>(kf, tile(2), warp, lane);
    a_frags<HD>(vf, tile(3), warp, lane);
    __syncthreads();

    for (int j = 0; j < n_steps; ++j) {
      if (j + 1 < n_steps) {
        load_step(j + 1, (j + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int s = j & 1, i0 = (q_lo + j % nqc) * TILE;
      const bf16 *Qt = tile(2 * s), *Dt = tile(2 * s + 1);
      const float *l2 = rowv + 2 * s * TILE, *dl = l2 + TILE;
      const int i_last = min(i0 + TILE, S) - 1;
      // the warp's keys seen by a query of the step: a live prefix key, or
      // a key in [P, T) no later than the last query's diagonal
      const bool any = kw0 < T_ && (kw0 < LV || (kw0 + 15 >= P &&
                                                 max(kw0, P) <= i_last + R));
      if (any) {
        float s_[NS][4], dp[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s_[n][e] = dp[n][e] = 0.f;
        // S^T = K Q^T, dP^T = V dO^T
        mma_abt2<HD>(s_, kf, Qt, dp, vf, Dt, lane);
        // every pair of the warp's 16 x 64 visible: no mask
        const bool full = kw0 + 15 < T_ && i0 + TILE <= S &&
                          (kw0 + 15 < LV || (kw0 >= P && kw0 + 15 <= i0 + R));
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          // this lane's two query columns 8 n + 2 (lane % 4) + {0, 1}
          const int q2 = n * 8 + (lane % 4) * 2;
          const float2 lq = *reinterpret_cast<const float2*>(&l2[q2]);
          const float2 dq2 = *reinterpret_cast<const float2*>(&dl[q2]);
          const float nl[2] = {-(lq.x * LOG2E), -(lq.y * LOG2E)};
          const float dd[2] = {dq2.x, dq2.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = kw0 + lane / 4 + (e / 2) * 8, ql = q2 + (e & 1);
            const bool ok = full || (i0 + ql < S &&
                                     visible(i0 + ql, kj, T_, P, LV, R));
            const float p =
                ok ? ex2(fmaf(s_[n][e], A.scale_log2, nl[e & 1])) : 0.f;
            dp[n][e] = ok ? p * (dp[n][e] - dd[e & 1]) : 0.f;
            s_[n][e] = p;
          }
        }
        // dV += P^T dO, dK += dS^T Q
        mma_xt2<HD, P_TERMS, DS_TERMS>(dv, s_, Dt, dk, dp, Qt, lane);
      }
      // every warp is done with stage j & 1 before step j + 2 lands in it
      __syncthreads();
    }
  }

  // this group's dK (scaled) and dV, f32, into this block's tiles
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float* red = reinterpret_cast<float*>(tiles);    // [2][TILE][HD]
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kl = warp * 16 + lane / 4 + rr * 8;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + (lane % 4) * 2;
      *reinterpret_cast<float2*>(&red[kl * HD + c]) =
          make_float2(dk[n][2 * rr] * A.scale, dk[n][2 * rr + 1] * A.scale);
      *reinterpret_cast<float2*>(&red[(TILE + kl) * HD + c]) =
          make_float2(dv[n][2 * rr], dv[n][2 * rr + 1]);
    }
  }
  cluster.sync();
  // this block's share of the keys (rank, rank + CS, ...): the cluster's
  // rows summed in rank order, four columns a thread
  const int nr = (TILE - rank + CS - 1) / CS, c4 = HD / 4;
  for (int e = tid; e < 2 * nr * c4; e += MTHREADS) {
    const int which = e / (nr * c4), kl = rank + CS * (e % (nr * c4) / c4);
    const int col = e % c4 * 4, key = t0 + kl;
    if (key >= T_) continue;
    const int off = (which * TILE + kl) * HD + col;
    float4 acc = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(red, 0) + off);
    for (int g = 1; g < CS; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(red, g) + off);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const long long* so = which ? st.dv : st.dk;
    bf16* out = (which ? A.dv : A.dk) + b * so[0] + kh * so[1]
                + (long long)key * so[2] + col;
    reinterpret_cast<__nv_bfloat162*>(out)[0] =
        __floats2bfloat162_rn(acc.x, acc.y);
    reinterpret_cast<__nv_bfloat162*>(out)[1] =
        __floats2bfloat162_rn(acc.z, acc.w);
  }
  // no block leaves while another reads its tiles
  cluster.sync();
}

// dQ of 64 query rows of one (b, h): the key tiles they see, as the forward
// walks them
template <int HD>
__device__ __forceinline__ void dq_block(const MmaArgs& A, int blk,
                                         bf16* tiles) {
  constexpr int NO = HD / 8, NS = TILE / 8, TS = TILE * (HD + 8);
  if (blk >= A.n_q_blocks) return;               // the grid's padding
  const int BH = A.B * A.H;
  const int n_qt = (A.S + TILE - 1) / TILE;
  const int q0 = (n_qt - 1 - blk / BH) * TILE;   // the last tile first
  const int bh = blk % BH, b = bh / A.H, h = bh % A.H, kh = h / A.G;
  const int S = A.S, T_ = A.T, P = A.P, LV = A.LV, R = A.R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Strides& st = A.str;
  const bf16* kb = A.k + b * st.k[0] + kh * st.k[1];
  const bf16* vb = A.v + b * st.v[0] + kh * st.v[1];
  // K and V of stage s in tiles 2 s, 2 s + 1
  auto tile = [&](int i) { return tiles + i * TS; };
  // last key any query of the block sees is (q0 + 63) + R; tiles
  // [lo, lo + n_dead) lie wholly in the dead rows [LV, P) and are skipped
  const int t_end = min(T_, q0 + TILE + R);
  const int lo = (LV + TILE - 1) / TILE;
  const int n_dead = max(0, P / TILE - lo);
  const int n_tiles = (t_end + TILE - 1) / TILE - n_dead;
  auto key_tile = [&](int j) { return j < lo ? j : j + n_dead; };
  auto load_kv = [&](int j, int s) {
    stage_rows<HD>(tile(2 * s), kb, st.k[2], key_tile(j) * TILE, T_);
    stage_rows<HD>(tile(2 * s + 1), vb, st.v[2], key_tile(j) * TILE, T_);
  };

  // Q and dO through stage 1's tiles, then into registers for the walk
  stage_rows<HD>(tile(2), A.q + b * st.q[0] + h * st.q[1], st.q[2], q0, S);
  stage_rows<HD>(tile(3), A.dout + b * st.d[0] + h * st.d[1], st.d[2], q0,
                 S);
  load_kv(0, 0);
  cp_async_commit();
  // this lane's two rows of the warp's 16 (fragment rows g and g + 8)
  const int row[2] = {q0 + warp * 16 + lane / 4, q0 + warp * 16 + lane / 4 + 8};
  float l2[2], dl[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    l2[rr] = row[rr] < S ? A.lse[(long long)bh * S + row[rr]] * LOG2E : 0.f;
  wait_for_prerequisites();
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    dl[rr] = row[rr] < S ? A.delta[(long long)bh * S + row[rr]] : 0.f;
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[HD / 16][4], df[HD / 16][4];
  a_frags<HD>(qf, tile(2), warp, lane);
  a_frags<HD>(df, tile(3), warp, lane);
  __syncthreads();
  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_kv(j + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = key_tile(j) * TILE;
    // a tile past the warp's last visible key, or a warp past the last
    // row, adds nothing
    if (t0 <= q0 + warp * 16 + 15 + R && q0 + warp * 16 < S) {
      const bf16 *Kt = tile(2 * (j & 1)), *Vt = tile(2 * (j & 1) + 1);
      float s_[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_[n][e] = dp[n][e] = 0.f;
      mma_abt2<HD>(s_, qf, Kt, dp, df, Vt, lane);  // S = Q K^T, dP = dO V^T
      const bool need_mask =
          t0 + TILE > T_ || t0 + TILE - 1 > q0 + warp * 16 + R ||
          (LV < P && t0 < P && t0 + TILE > LV);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = t0 + n * 8 + (lane % 4) * 2 + (e & 1);
          const bool ok = !need_mask ||
                          visible(row[e / 2], kj, T_, P, LV, R);
          const float p = ok ? ex2(fmaf(s_[n][e], A.scale_log2, -l2[e / 2]))
                             : 0.f;
          dp[n][e] = ok ? p * (dp[n][e] - dl[e / 2]) : 0.f;
        }
      mma_xt<HD, DS_TERMS>(dq, dp, Kt, lane);      // dQ += dS K
    }
    // every warp is done with stage j & 1 before tile j + 2 lands in it
    __syncthreads();
  }

  bf16* qb = A.dq + b * st.dq[0] + h * st.dq[1];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (row[rr] >= S) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(qb + (long long)row[rr] * st.dq[2]
                                         + c) =
          __floats2bfloat162_rn(dq[n][2 * rr] * A.scale,
                                dq[n][2 * rr + 1] * A.scale);
    }
  }
}

// the dQ blocks (padded to a whole number of clusters), then the dK/dV
// blocks (in clusters of GB * NC), of one grid; three blocks a SM. At
// head_dim 128 (olmoe) the four tiles take 68 KB of dynamic shared memory
// (past a static allocation's 48 KB) and one block a SM lets a thread hold
// its fragments and accumulators in up to 255 registers; so at head_dim 80
// (stablelm-3b: 45 KB, five k-steps and ten n-tiles; the cluster's f32 dK
// and dV, 40 KB, fit in the four tiles)
template <int HD>
constexpr int mma_min_blocks() { return HD > 64 ? 1 : 3; }

template <int HD>
constexpr int mma_smem_bytes() { return 4 * TILE * (HD + 8) * 2; }

template <int HD>
__global__ void __launch_bounds__(MTHREADS, mma_min_blocks<HD>())
attn_bwd_mma(MmaArgs A) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* const tiles = reinterpret_cast<bf16*>(mma_smem);   // 4 TILE (HD + 8)
  __shared__ float rowv[4 * TILE];
  if ((int)blockIdx.x < A.n_q_pad)
    dq_block<HD>(A, blockIdx.x, tiles);
  else
    dkdv_block<HD>(A, blockIdx.x - A.n_q_pad, tiles, rowv);
}

// dK/dV blocks a kv-head and key tile, in one cluster of at most 8: GB
// head groups (a divisor of G; a block walks G / GB heads) times NC query
// chunks
int heads_per_group_blocks(int G) {
  int gb = G < 8 ? G : 8;
  while (G % gb) --gb;
  return gb;
}
int query_chunks(int GB) { return QCHUNKS < 8 / GB ? QCHUNKS : 8 / GB; }

template <int HD>
int run_mma(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const float* lse, float* ws, void* dq,
            void* dk, void* dv, int B, int H, int Kh, int S, int T_, int P,
            int LV, int R, const Strides& str, cudaStream_t st) {
  MmaArgs A;
  A.q = (const bf16*)q;
  A.k = (const bf16*)k;
  A.v = (const bf16*)v;
  A.dout = (const bf16*)dout;
  A.lse = lse;
  A.delta = ws;
  A.dq = (bf16*)dq;
  A.dk = (bf16*)dk;
  A.dv = (bf16*)dv;
  A.B = B;
  A.H = H;
  A.Kh = Kh;
  A.G = H / Kh;
  A.GB = heads_per_group_blocks(A.G);
  A.NC = query_chunks(A.GB);
  A.S = S;
  A.T = T_;
  A.P = P;
  A.LV = LV;
  A.R = R;
  const int n_kt = (T_ + TILE - 1) / TILE, n_qt = (S + TILE - 1) / TILE;
  const int CS = A.GB * A.NC;
  A.n_q_blocks = n_qt * B * H;
  A.n_q_pad = (A.n_q_blocks + CS - 1) / CS * CS;
  A.scale = (float)(1.0 / sqrt((double)HD));
  A.scale_log2 = (float)(1.4426950408889634 / sqrt((double)HD));
  A.str = str;
  const long long rows = (long long)B * H * S,
                  lanes = rows * delta_lanes(HD);
  attn_bwd_delta_bf16<<<(unsigned)((lanes + 255) / 256), 256, 0, st>>>(
      (const bf16*)o, (const bf16*)dout, ws, H, S, HD, rows, str);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = CS;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[1].val.programmaticStreamSerializationAllowed = 1;
  constexpr int smem = mma_smem_bytes<HD>();
  if (smem > 48 * 1024) {
    // allowed once, at the first launch (before any graph capture)
    static const cudaError_t attr = cudaFuncSetAttribute(
        attn_bwd_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(MTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  auto launch = [&](int n_blocks) {
    cfg.gridDim = dim3((unsigned)n_blocks);
    const int e = (int)cudaLaunchKernelEx(&cfg, attn_bwd_mma<HD>, A);
    return e ? e : (int)cudaGetLastError();
  };
  return launch(A.n_q_pad + n_kt * B * Kh * CS);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores (the first port's kernels)
// ---------------------------------------------------------------------------

constexpr int BT = 32;          // rows of a tile (keys or queries)
constexpr int NT = 256;         // threads a block
constexpr int TPR = NT / BT;    // threads per tile row: 8

// strided (B, X, R, hd) rows [r0, r0 + BT) into s[BT][HD + 1]; rows past n
// read as 0
template <int HD>
__device__ __forceinline__ void load_tile(float (*s)[HD + 1], const float* base,
                                          long long rs, int r0, int n) {
  for (int e = threadIdx.x; e < BT * HD; e += NT) {
    const int r = e / HD, d = e % HD, row = r0 + r;
    s[r][d] = row < n ? base[(long long)row * rs + d] : 0.f;
  }
}

// the K, V, Q and dO tiles, P and dS, the rows' lse and D of
// attn_bwd_dkdv, in dynamic shared memory: 49.7 KB at head_dim 80, past a
// static allocation's 48 KB
template <int HD>
constexpr int dkdv_smem_bytes() {
  return (4 * BT * (HD + 1) + 2 * BT * (BT + 1) + 2 * BT) * 4;
}

// dK, dV of 32 keys of one kv-head: grid (key tiles, B * Kh)
template <int HD>
__global__ void __launch_bounds__(NT)
attn_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, int H, int Kh,
              int S, int T_, int P, int LV, int R, Strides str, float scale) {
  constexpr int NPT = HD / TPR;     // output dims a thread
  typedef float Row[HD + 1];
  typedef float PRow[BT + 1];
  extern __shared__ float dkdv_smem[];
  Row* const Ks = reinterpret_cast<Row*>(dkdv_smem);
  Row* const Vs = Ks + BT;
  Row* const Qs = Vs + BT;
  Row* const Ds = Qs + BT;
  PRow* const Ps = reinterpret_cast<PRow*>(Ds + BT);
  PRow* const Ss = Ps + BT;
  float* const lse_s = reinterpret_cast<float*>(Ss + BT);
  float* const del_s = lse_s + BT;
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
    load_tile<HD>(Ks, k + b * sk[0] + kh * sk[1], sk[2], t0, T_);
    load_tile<HD>(Vs, v + b * sv[0] + kh * sv[1], sv[2], t0, T_);
    // the first query that sees a key of this tile: all of them where the
    // tile holds a live prefix key, else the query whose diagonal reaches
    // the tile's first key
    const int i_first = t0 < LV ? 0 : max(0, t0 - R);
    for (int g = 0; g < G; ++g) {
      const int h = kh * G + g;
      const long long bh = (long long)b * H + h;
      for (int i0 = (i_first / BT) * BT; i0 < S; i0 += BT) {
        __syncthreads();      // the previous tile's readers are done
        load_tile<HD>(Qs, q + b * sq[0] + h * sq[1], sq[2], i0, S);
        load_tile<HD>(Ds, dout + b * sd[0] + h * sd[1], sd[2], i0, S);
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
          if (i0 + qi < S && visible(i0 + qi, t0 + kj, T_, P, LV, R)) {
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
    float* kp = dk + b * sdk[0] + kh * sdk[1] + (long long)j * sdk[2];
    float* vp = dv + b * sdv[0] + kh * sdv[1] + (long long)j * sdv[2];
#pragma unroll
    for (int u = 0; u < NPT; ++u) {
      kp[c + TPR * u] = ak[u] * scale;
      vp[c + TPR * u] = av[u];
    }
  }
}

// dQ of 32 query rows of one head: grid (query tiles, B * H)
template <int HD>
__global__ void __launch_bounds__(NT)
attn_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, int H, int Kh, int S, int T_, int P,
            int LV, int R, Strides str, float scale) {
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

  load_tile<HD>(Qs, q + b * sq[0] + h * sq[1], sq[2], i0, S);
  load_tile<HD>(Ds, dout + b * sd[0] + h * sd[1], sd[2], i0, S);
  if (tid < BT) {
    const int i = i0 + tid;
    lse_s[tid] = i < S ? lse[bh * S + i] : 0.f;
    del_s[tid] = i < S ? delta[bh * S + i] : 0.f;
  }
  float aq[NPT];
#pragma unroll
  for (int u = 0; u < NPT; ++u) aq[u] = 0.f;
  // the last key any row of the tile sees is (i0 + BT - 1) + R
  const int t_end = min(T_, i0 + BT + R);
  for (int t0 = 0; t0 < t_end; t0 += BT) {
    if (t0 >= LV && t0 + BT <= P) continue;     // wholly dead rows
    __syncthreads();          // the previous tile's readers are done
    load_tile<HD>(Ks, k + b * sk[0] + kh * sk[1], sk[2], t0, T_);
    load_tile<HD>(Vs, v + b * sv[0] + kh * sv[1], sv[2], t0, T_);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < BT / TPR; ++u) {
      const int qi = tid / TPR, kj = tid % TPR + TPR * u;
      float ds = 0.f;
      if (i0 + qi < S && visible(i0 + qi, t0 + kj, T_, P, LV, R)) {
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
    float* qp = dq + b * sdq[0] + h * sdq[1] + (long long)i * sdq[2];
#pragma unroll
    for (int u = 0; u < NPT; ++u) qp[c + TPR * u] = aq[u] * scale;
  }
}

template <int HD>
int run_f32(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const float* lse, float* delta, void* dq,
            void* dk, void* dv, int B, int H, int Kh, int S, int T_, int P,
            int LV, int R, const Strides& str, cudaStream_t st) {
  const float scale = (float)(1.0 / sqrt((double)HD));
  const long long rows = (long long)B * H * S;
  typedef const float* cf;
  attn_bwd_delta<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (cf)o, (cf)dout, delta, H, S, HD, rows, str);
  int err = (int)cudaGetLastError();
  if (err) return err;
  dim3 g_kv((T_ + BT - 1) / BT, B * Kh);
  constexpr int smem = dkdv_smem_bytes<HD>();
  if (smem > 48 * 1024) {
    // allowed once, at the first launch (before any graph capture)
    static const cudaError_t attr = cudaFuncSetAttribute(
        attn_bwd_dkdv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  attn_bwd_dkdv<HD><<<g_kv, NT, smem, st>>>(
      (cf)q, (cf)k, (cf)v, (cf)dout, lse, delta, (float*)dk, (float*)dv, H,
      Kh, S, T_, P, LV, R, str, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  dim3 g_q((S + BT - 1) / BT, B * H);
  attn_bwd_dq<HD><<<g_q, NT, 0, st>>>(
      (cf)q, (cf)k, (cf)v, (cf)dout, lse, delta, (float*)dq, H, Kh, S, T_, P,
      LV, R, str, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 elements of the workspace flash_attention_bwd_launch needs: D
extern "C" long long flash_attention_bwd_workspace_elems(int bf16_in, int B,
                                                         int H, int Kh, int S,
                                                         int T_, int hd) {
  return (long long)B * H * S;
}

// strides (24 int64, host memory): q, k, v, o, dout, dq, dk, dv, each
// (b, head, row); `workspace` holds flash_attention_bwd_workspace_elems
// f32, 16-byte aligned; causal = 0: every key j < T visible to every query
// (prefix_len and prefix_live must be 0)
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* workspace, void* dq, void* dk,
    void* dv, int bf16_in, int causal, int B, int H, int Kh, int S, int T_,
    int hd, int prefix_len, int prefix_live, const long long* strides,
    void* stream) {
  if (prefix_live < 0 || prefix_live > prefix_len || H % Kh || T_ < 1 ||
      (!causal && prefix_len != 0))
    return (int)cudaErrorInvalidValue;
  const int R = causal ? prefix_len : T_;
  Strides str;
  long long* dst[8] = {str.q, str.k, str.v, str.o, str.d, str.dq, str.dk,
                       str.dv};
  for (int t = 0; t < 8; ++t)
    for (int a = 0; a < 3; ++a) dst[t][a] = strides[3 * t + a];
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* ws = (float*)workspace;
#define BWD(RUN, HD)                                                        \
  RUN<HD>(q, k, v, o, dout, l, ws, dq, dk, dv, B, H, Kh, S, T_, prefix_len, \
          prefix_live, R, str, st)
  if (bf16_in) {
    switch (hd) {
      case 16: return BWD(run_mma, 16);
      case 32: return BWD(run_mma, 32);
      case 64: return BWD(run_mma, 64);
      case 80: return BWD(run_mma, 80);
      case 128: return BWD(run_mma, 128);
    }
  } else {
    switch (hd) {
      case 16: return BWD(run_f32, 16);
      case 32: return BWD(run_f32, 32);
      case 64: return BWD(run_f32, 64);
      case 80: return BWD(run_f32, 80);
    }
  }
#undef BWD
  return (int)cudaErrorInvalidValue;
}
