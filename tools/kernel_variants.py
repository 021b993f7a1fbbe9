#!/usr/bin/env python3
"""Where the time of the port's attention kernels (forward and backward),
int matmuls and activation quantizers goes, on one card.

    python3 tools/kernel_variants.py        # from the root of a checkout
    python3 tools/kernel_variants.py --only flash_attention_bwd

Builds ablated copies of ``csrc/flash_attention.cu``,
``csrc/flash_decode.cu``, ``csrc/flash_attention_bwd.cu``, the int
matmuls' shared mainloop ``csrc/int_matmul.cuh`` (built with
``w8a8_matmul.cu`` and ``w4a8_matmul.cu``) and the quantizers
(``act_quant.cu`` with its ``act_quant.cuh``, whose arithmetic the int
matmuls' decode staging shares), each one named set of text substitutions
away from the source (``ATTENTION``, ``DECODE``, ``BACKWARD``,
``INT_MATMUL``, ``ACT_QUANT`` below), every copy into its own shared
library by its own ``nvcc`` (all started together), and times each copy at
``chip_smoke.py``'s phase-3 shapes with that script's ``device_ms``: the
L2 flushed before every call, device time between CUDA events, the card
kept busy while the host enqueues. Each copy is bound with the package's
own C signatures (``kernels/_lib.py``) and its workspace sized by the
copy's own ``flash_decode_workspace_elems`` or
``flash_attention_bwd_workspace_elems``. A substitution whose text the
source no longer holds stops the script before anything is built, so a
change to a kernel source shows here as that error, never as a wrong
ablation. ``--only`` builds and times the named families alone. A
one-element fill is timed the same way: the floor of the method (launch
and events). Each attention result line gives device µs per call, how many
outputs (written into a zeroed buffer) fall outside the one-bf16-ulp check
against the plain version, and the largest error over its bound; each
backward line the µs a call and a tuning step at the tuning shape and, per
output, the entries outside the card's bar; the timeline copies the
blocks' own clock stamps (when each kind of block starts, how long its
preamble and each of its steps take); each int matmul line the µs of every
main-path site at M = 4 (decode; on int8 codes and on the bf16 activation
the staging quantizes) or M = 2048 (prefill), their sum over one decode
step or one prefill, and how many outputs differ from the plain version;
each quantizer line the µs of every phase-3 shape and the sums over a step
and a prefill: copies that drop work fail by design and time what they
leave. Last, the decode copies named in ``PRECISION`` and the backward
copies named in ``BWD_PRECISION`` are held to their checks on more seeded
draws. Needs one NVIDIA card and nvcc; writes
``chiprun_out/kernel_variants.json`` (with ``--only``,
``kernel_variants.<families>.json``).
"""
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# name: [(text in the source, replacement)]
ATTENTION = {
    "as_built": [],
    # P rounded once to bf16 before P V, as FlashAttention-2 does
    "p_one_bf16_term": [("for (int term = 0; term < 3; ++term)",
                         "for (int term = 0; term < 1; ++term)")],
    # no P V at all: what S, the softmax, the loads and barriers take
    "no_pv": [("      for (int kk = 0; kk < TK / 16; ++kk) {\n"
               "        uint32_t a[3][4];",
               "      for (int kk = 0; kk < 0; ++kk) {\n"
               "        uint32_t a[3][4];")],
    # the accurate expf in place of one FFMA and one ex2
    "accurate_expf": [("s[n][e] = ex2(fmaf(s[n][e], scale_log2, -cm[e / 2]));",
                       "s[n][e] = expf((s[n][e] - mx[e / 2])"
                       " * (scale_log2 * 0.69314718f));")],
    # four blocks a SM: registers capped at 128, spills in the loop
    "four_blocks_per_sm": [("return HD > 64 ? 2 : 3;",
                            "return HD > 64 ? 2 : 4;")],
    # every warp computes every tile its block loads
    "no_warp_tile_skip": [("    if (t0 <= q0 + warp * 16 + 15 + R) {",
                           "    if (true) {")],
}
DECODE = {
    "as_built": [],
    # every block returns at once: the launch of the grid and the method
    "launch_only": [("  const int c = blockIdx.x, nch = gridDim.x;",
                     "  if (ks != nullptr) return;\n"
                     "  const int c = blockIdx.x, nch = gridDim.x;")],
    # no K/V read and no chunk compute: pos, the ticket and the merge
    "no_kv_no_compute": [("  if (nv > 0) {\n", "  if (nv > 0 && nv < 0) {\n")],
    # the last block does not merge: loads, compute, partials and ticket
    "no_merge": [("  if (!s_last) return;", "  if (true) return;")],
    # the scores' dot products in f32 too: all arithmetic f32
    "f32_dots": [("typedef double dot_t;", "typedef float dot_t;")],
    # every other sum in f64 as well
    "f64_sums": [("typedef float acc_t;", "typedef double acc_t;")],
}
# the quantizers' codes: the division, the stores, the arithmetic
CODE_DIV = "  return __fdiv_rn(v, s);"
CODE_MUL = "  return __fmul_rn(v, s);"
NO_STORE = [
    ("  *p = (int8_t)v;", "  asm volatile(\"\" ::\"r\"(v));"),
    ("  *reinterpret_cast<uint32_t*>(p) = v;",
     "  asm volatile(\"\" ::\"r\"(v));"),
    ("  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);",
     "  asm volatile(\"\" ::\"r\"(lo), \"r\"(hi));")]
NO_ARITH = [("    q = bf_round(__fadd_rn(bf_round(code_div(v, s)), z));\n"
             "  else\n"
             "    q = __fadd_rn(code_div(v, s), z);",
             "    q = v;\n  else\n    q = v;")]
INT_MATMUL = {
    "as_built": [],
    # decode: one slice per group (at most 32 k-steps), no K split beyond
    # the groups: fewer blocks, no workspace round trip on W8A8
    "no_split_k": [("    cs = (cs + D_NW - 1) / D_NW * D_NW;\n",
                    "    cs = D_MAXCS;\n")],
    # prefill: B's chunks stored as loaded, without the XOR swizzle (the
    # fragment reads conflict as the earlier byte-transposed staging did)
    "b_unswizzled": [("16 * (c ^ (2 * ((r / RK) & 3)))", "16 * c"),
                     ("(((wc >> 2) ^ (2 * q)) << 2)", "((wc >> 2) << 2)")],
    # no tensor-core work: the loads, staging and transposes only
    "no_mma": [("      \"mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 \"\n"
                "      \"{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, \"\n"
                "      \"{%0, %1, %2, %3};\\n\"",
                "      \"xor.b32 %0, %0, %4;\\n xor.b32 %1, %1, %8;\\n\"\n"
                "      \"xor.b32 %2, %2, %9;\\n xor.b32 %3, %3, %7;\\n\"")],
    # decode: every block stores its own partial (no workspace atomics, no
    # ticket, no merge by the last block)
    "no_merge": [("  if (total == 1) {", "  if (true) {")],
    # decode: every block returns at once (the launch of the grid)
    "decode_launch_only": [
        ("  const int tile = blockIdx.x, g = blockIdx.y / cpg, c = "
         "blockIdx.y % cpg;",
         "  if (ws != nullptr) return;\n"
         "  const int tile = blockIdx.x, g = blockIdx.y / cpg, c = "
         "blockIdx.y % cpg;")],
    # decode: the weight's registers filled from indices, no weight read
    "decode_no_weight_loads": [
        ("        raw[h][r] = ok ? load16(w + row * N + n, n, N, vec)\n"
         "                       : make_uint4(0u, 0u, 0u, 0u);",
         "        raw[h][r] = make_uint4(k, r, n, 0u);")],
    # prefill: the tiles' loads only (no fragments, no MMA)
    "prefill_loads_only": [("    compute(t % P_STAGES);",
                            "    if (t < 0) compute(t % P_STAGES);")],
    # prefill: no tile loads (the MMAs on whatever the stages hold)
    "prefill_no_loads": [("    if (nt < T) load_tile(nt, nt % P_STAGES);",
                          "    if (nt < 0) load_tile(nt, nt % P_STAGES);")],
    # decode on bf16 x: the quantizing staging without its divisions
    "staging_no_division": [(CODE_DIV, CODE_MUL)],
}
# act_quant_ptoken's first design, the one its block-per-row kernel
# replaced: a warp per row, four rows a block, the row in registers (up to
# 24 16-byte vectors a lane: 6144 bf16, 3072 f32), min and max by shuffles
# only, no shared memory and no barrier; wider rows keep the block kernel
PTOKEN_LAUNCH = """template <typename T>
int launch_ptoken(const T* x, int8_t* out, float* scale, float* zero,
                  float* lo, float* hi, int mode, int M, int D, float qmax,
                  cudaStream_t st) {
  constexpr int N = aq::Vec<T>::N;
"""
PTOKEN_WARP = """constexpr int W_ROWS = 4;

template <typename T, int VPL>
__global__ void __launch_bounds__(32 * W_ROWS)
act_quant_ptoken_warp(const T* __restrict__ x, int8_t* __restrict__ out,
                      float* __restrict__ scale, float* __restrict__ zero,
                      int M, int D, float qmax) {
  constexpr int N = aq::Vec<T>::N;
  constexpr bool BF16_ARITH = sizeof(T) == 2;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * W_ROWS + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * D;
  int8_t* orow = out + (size_t)row * D;
  const int head = aq::head_elems<T>(xr, D);
  const int nvec = (D - head) / N;
  const int t0 = head + nvec * N;
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  uint4 u[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = lane + 32 * k;
    u[k] = i < nvec ? aq::ld_nc16(xv + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  const float hv = lane < head ? aq::to_f32(xr[lane]) : 0.0f;
  const float tv = t0 + lane < D ? aq::to_f32(xr[t0 + lane]) : 0.0f;
  float mn = fminf(fminf(hv, tv), 0.0f), mx = fmaxf(fmaxf(hv, tv), 0.0f);
#pragma unroll
  for (int k = 0; k < VPL; ++k)
    if (lane + 32 * k < nvec) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float f = aq::elem<T>(u[k], e);
        mn = fminf(mn, f);
        mx = fmaxf(mx, f);
      }
    }
  warp_minmax(mn, mx);
  float s, z;
  row_params<BF16_ARITH>(mn, mx, qmax, &s, &z);
  if (lane == 0) {
    scale[row] = s;
    zero[row] = z;
  }
  const bool ovec = (reinterpret_cast<uintptr_t>(orow) + head) % N == 0;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = lane + 32 * k;
    if (i < nvec)
      aq::put_codes<T, BF16_ARITH>(orow + head + i * N, ovec, u[k], s, z,
                                   qmax);
  }
  if (lane < head) aq::put8(orow + lane, aq::code<BF16_ARITH>(hv, s, z, qmax));
  if (t0 + lane < D)
    aq::put8(orow + t0 + lane, aq::code<BF16_ARITH>(tv, s, z, qmax));
}

""" + PTOKEN_LAUNCH + """  const int vpl = (D / N + 31) / 32;
  const int wb = (M + W_ROWS - 1) / W_ROWS, wt = 32 * W_ROWS;
  if (vpl <= 24 && mode == 0) {
    if (vpl <= 4)
      act_quant_ptoken_warp<T, 4><<<wb, wt, 0, st>>>(x, out, scale, zero, M,
                                                     D, qmax);
    else if (vpl <= 8)
      act_quant_ptoken_warp<T, 8><<<wb, wt, 0, st>>>(x, out, scale, zero, M,
                                                     D, qmax);
    else if (vpl <= 16)
      act_quant_ptoken_warp<T, 16><<<wb, wt, 0, st>>>(x, out, scale, zero,
                                                      M, D, qmax);
    else
      act_quant_ptoken_warp<T, 24><<<wb, wt, 0, st>>>(x, out, scale, zero,
                                                      M, D, qmax);
    return (int)cudaGetLastError();
  }
"""
ACT_QUANT = {
    "as_built": [],
    # act_quant_ptoken a warp per row (the static quantizer as built)
    "ptoken_warp_per_row": [(PTOKEN_LAUNCH, PTOKEN_WARP)],
    # every x / s a multiply: what the IEEE division costs
    "no_division": [(CODE_DIV, CODE_MUL)],
    # the codes computed, never stored
    "no_store": NO_STORE,
    # the loads (and the per-token min / max), a clamp of each element, no
    # division, no store: what reading x costs
    "loads_only": NO_STORE + NO_ARITH,
}
# flash_attention_bwd (bf16): the split of P and dS, where the G heads of a
# kv-head are summed, how dQ gets dS, the order of issue, occupancy, and
# what each kind of block costs
P2, D2 = "constexpr int P_TERMS = 2;", "constexpr int DS_TERMS = 2;"
DQ_DS_READ = """      {
        const int TP = (T_ + TILE - 1) / TILE * TILE;
        const float* dsb = A.ds + (long long)bh * S * TP;
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = row[e / 2];
            dp[n][e] = r < S ? dsb[(long long)r * TP + t0 + n * 8
                                   + (lane % 4) * 2 + (e & 1)] : 0.f;
          }
      }
"""
DKDV_DS_WRITE = """            s_[n][e] = p;
          }
        {
          const int TP = (T_ + TILE - 1) / TILE * TILE;
          float* dsb = A.ds + ((long long)b * A.H + h_lo + j / nq) * S * TP;
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ql = n * 8 + (lane % 4) * 2 + (e & 1);
              if (i0 + ql < S)
                dsb[(long long)(i0 + ql) * TP + kw0 + lane / 4 + (e / 2) * 8]
                    = dp[n][e];
            }
        }
"""
BWD_WS = "  return (long long)B * H * S;"
BWD_DISPATCH = ("  if ((int)blockIdx.x < A.n_q_pad)\n"
                "    dq_block<HD>(A, blockIdx.x, tiles);\n  else\n"
                "    dkdv_block<HD>(A, blockIdx.x - A.n_q_pad, tiles, rowv);")
DKDV_ELEMENTWISE = ("            const float p =\n"
                    "                ok ? ex2(fmaf(s_[n][e], A.scale_log2, "
                    "nl[e & 1])) : 0.f;\n"
                    "            dp[n][e] = ok ? p * (dp[n][e] - dd[e & 1]) : "
                    "0.f;\n")
DKDV_PRODUCTS = ("        mma_xt2<HD, P_TERMS, DS_TERMS>(dv, s_, Dt, dk, dp, "
                 "Qt, lane);\n")
BACKWARD = {
    "as_built": [],
    # P and dS each rounded once to bf16, as FlashAttention-2 does
    "one_term": [(P2, "constexpr int P_TERMS = 1;"),
                 (D2, "constexpr int DS_TERMS = 1;")],
    # three terms each, as the forward splits P (f32's 24 bits)
    "three_terms": [(P2, "constexpr int P_TERMS = 3;"),
                    (D2, "constexpr int DS_TERMS = 3;")],
    # each accumulator's terms issued back to back (a chain of dependent
    # mma.sync), as a straightforward loop nest would
    "terms_chained": [
        ("    for (int term = 0; term < NMAX; ++term)\n#pragma unroll\n"
         "      for (int dp = 0; dp < HD / 16; ++dp) {",
         "    for (int dp = 0; dp < HD / 16; ++dp)\n#pragma unroll\n"
         "      for (int term = 0; term < NMAX; ++term) {")],
    # each dK/dV block walks all the query tiles that see its keys (the
    # cluster sums heads only)
    "qchunks_1": [("constexpr int QCHUNKS = 2;", "constexpr int QCHUNKS = 1;")],
    # the G heads of a kv-head walked by one dK/dV block (G times fewer,
    # longer blocks)
    "g_in_block": [("  int gb = G < 8 ? G : 8;", "  int gb = 1;")],
    # two blocks a SM: registers up to 255, no spills
    "two_blocks_per_sm": [("return HD > 64 ? 1 : 3;",
                           "return HD > 64 ? 1 : 2;")],
    # the backward's grid launched after the D kernel ends (no
    # programmatic dependent launch)
    "no_pdl": [("  cfg.numAttrs = 2;", "  cfg.numAttrs = 1;")],
    # the dQ blocks return at once: what the dK/dV blocks take
    "no_dq_blocks": [("    dq_block<HD>(A, blockIdx.x, tiles);",
                      "    return;")],
    # the dK/dV blocks return at once: what the dQ blocks take
    "no_dkdv_blocks": [("    dkdv_block<HD>(A, blockIdx.x - A.n_q_pad, "
                        "tiles, rowv);", "    return;")],
    # where a dK/dV step's time goes: without the dK product, without both
    # products, without the mask and exponentials, without S^T and dP^T,
    # and with nothing but the loads and barriers
    "probe_dkdv_no_dk": [(DKDV_PRODUCTS, DKDV_PRODUCTS.replace(
        "P_TERMS, DS_TERMS", "P_TERMS, 0"))],
    "probe_dkdv_no_products": [(DKDV_PRODUCTS, "")],
    "probe_dkdv_no_elementwise": [(DKDV_ELEMENTWISE,
                                   "            const float p = s_[n][e];\n"
                                   "            dp[n][e] *= p;\n")],
    "probe_dkdv_no_s_dp": [("        mma_abt2<HD>(s_, kf, Qt, dp, vf, Dt, "
                            "lane);\n", "")],
    "probe_dkdv_loads_only": [("      if (any) {",
                               "      if (any && kw0 < 0) {")],
    # dQ from a stored dS: the dK/dV blocks (every warp, every step) write
    # dS in f32 to the workspace, then a second grid of dQ blocks reads it
    # in place of recomputing Q K^T and dO V^T (no V staged)
    "dq_from_ds": [
        ("  Strides str;\n};", "  Strides str;\n  float* ds;\n  int block0;\n};"),
        (BWD_DISPATCH,
         "  const int blk = (int)blockIdx.x + A.block0;\n"
         "  if (blk < A.n_q_pad)\n    dq_block<HD>(A, blk, tiles);\n"
         "  else\n    dkdv_block<HD>(A, blk - A.n_q_pad, tiles, rowv);"),
        ("      if (any) {", "      if (true) {"),
        ("            s_[n][e] = p;\n          }\n", DKDV_DS_WRITE),
        ("      mma_abt2<HD>(s_, qf, Kt, dp, df, Vt, lane);  // S = Q K^T, "
         "dP = dO V^T\n", DQ_DS_READ),
        ("          const float p = ok ? ex2(fmaf(s_[n][e], A.scale_log2, "
         "-l2[e / 2]))\n                             : 0.f;\n"
         "          dp[n][e] = ok ? p * (dp[n][e] - dl[e / 2]) : 0.f;\n", ""),
        ("    stage_rows<HD>(tile(2 * s + 1), vb, st.v[2], key_tile(j) * "
         "TILE, T_);\n", ""),
        ("  A.str = str;\n",
         "  A.str = str;\n  A.ds = ws + (long long)B * H * S;\n"),
        ("  return launch(A.n_q_pad + n_kt * B * Kh * CS);",
         "  A.block0 = A.n_q_pad;\n  const int e = launch(n_kt * B * Kh * CS);"
         "\n  if (e) return e;\n  A.block0 = 0;\n"
         "  return launch(A.n_q_pad);"),
        (BWD_WS, "  return (long long)B * H * S\n"
                 "         * (bf16_in ? 1 + (T_ + 63) / 64 * 64 : 1);"),
    ],
}
# per-block stamps of the as-built kernel: the global timer and the SM's
# clock at the block's start, the SM's clock once its fragments are in
# registers, and both at its end, into the workspace after D (6 u64 a
# block)
TIMELINE = [
    ("  Strides str;\n};", "  Strides str;\n  unsigned long long* stamps;\n};"),
    ("  __shared__ float rowv[4 * TILE];\n",
     "  __shared__ float rowv[4 * TILE];\n"
     "  unsigned long long g0, c0 = clock64();\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0));\n"),
    ("    dkdv_block<HD>(A, blockIdx.x - A.n_q_pad, tiles, rowv);\n}",
     "    dkdv_block<HD>(A, blockIdx.x - A.n_q_pad, tiles, rowv);\n"
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0) {\n"
     "    unsigned long long g1, c1 = clock64();\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
     "    unsigned long long* s = A.stamps + 6 * blockIdx.x;\n"
     "    s[0] = g0; s[1] = c0; s[3] = c1; s[4] = g1; s[5] = 1;\n"
     "  }\n}"),
    ("    a_frags<HD>(vf, tile(3), warp, lane);\n    __syncthreads();\n",
     "    a_frags<HD>(vf, tile(3), warp, lane);\n    __syncthreads();\n"
     "    if (tid == 0) A.stamps[6 * blockIdx.x + 2] = clock64();\n"),
    ("  a_frags<HD>(df, tile(3), warp, lane);\n",
     "  a_frags<HD>(df, tile(3), warp, lane);\n"
     "  if (tid == 0) A.stamps[6 * blockIdx.x + 2] = clock64();\n"),
    ("  A.str = str;\n",
     "  A.str = str;\n  A.stamps = (unsigned long long*)(ws + ((long long)B "
     "* H * S + 1) / 2 * 2);\n"),
    (BWD_WS, "  return ((long long)B * H * S + 1) / 2 * 2\n"
             "         + 12LL * (((S + 63) / 64 + 1) * B * H\n"
             "                   + 8LL * (T_ + 63) / 64 * B * Kh);"),
]
ONLY_DKDV = [("  const int BH = A.B * A.H;\n",
              "  if (true) return;\n  const int BH = A.B * A.H;\n")]
ONLY_DQ = [("  const int per_tile = A.B * A.Kh * CS;\n",
            "  if (true) return;\n  const int per_tile = A.B * A.Kh * CS;\n")]
BACKWARD.update({"timeline": TIMELINE,
                 "timeline_dkdv_alone": TIMELINE + ONLY_DKDV,
                 "timeline_dq_alone": TIMELINE + ONLY_DQ})
# the backward copies checked on more seeded draws at the tuning shape
BWD_PRECISION = ("as_built", "three_terms", "one_term", "qchunks_1")

# the decode copies whose outputs are checked on more data (pos 4000 of
# 4096, int8 (B, K)), and on how many seeded draws
PRECISION = ("as_built", "f32_dots", "f64_sums")
PRECISION_DRAWS = 8


def build(lib, name, source, subs, out_dir, extra=()):
    """A copy of ``source`` with ``subs`` applied, built with the sources
    ``extra`` (unchanged) into one library."""
    text = source
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    cu = out_dir / f"{name}.cu"
    cu.write_text(text)
    so = out_dir / f"{name}.so"
    cmd = [lib._nvcc(), *lib.NVCC_FLAGS, "-I", str(lib.CSRC), "-shared",
           str(cu), *map(str, extra), "-o", str(so)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)


def build_set(lib, family, name, subs, sources, out_dir):
    """A copy of every file of ``csrc/`` with ``subs`` applied (each text
    replaced in every file that holds it), ``sources`` built into one
    library."""
    texts = {p.name: p.read_text() for p in lib.CSRC.iterdir()}
    for old, new in subs:
        hits = [f for f, t in texts.items() if old in t]
        if not hits:
            raise SystemExit(f"{family}.{name}: the sources no longer hold "
                             f"{old!r}")
        for f in hits:
            texts[f] = texts[f].replace(old, new)
    d = out_dir / f"{family}.{name}"
    d.mkdir(parents=True, exist_ok=True)
    for f, t in texts.items():
        (d / f).write_text(t)
    so = d / "lib.so"
    cmd = [lib._nvcc(), *lib.NVCC_FLAGS, "-shared",
           *(str(d / f) for f in sources), "-o", str(so)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)


def check(got, want):
    """Outputs outside |err| <= 2^-7 |want| + 1e-6, and the largest err /
    that bound."""
    got, want = got.float(), want.float()
    ratio = (got - want).abs() / (2.0 ** -7 * want.abs() + 1e-6)
    return {"outside_one_ulp": int((ratio > 1).sum()),
            "worst_err_over_bound": float(ratio.max())}


FAMILIES = ("flash_attention", "flash_decode", "int_matmul", "act_quant",
            "flash_attention_bwd")


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=FAMILIES, default=FAMILIES,
                    help="the kernel families to build and time (default: "
                         "all)")
    only = set(ap.parse_args().only)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script times the card")
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.flash_decode import flash_decode_plain
    from chip_smoke import device_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out_dir = ROOT / "build" / "kernel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    libs, procs = {}, []
    for kernel, table in (("flash_attention", ATTENTION),
                          ("flash_decode", DECODE),
                          ("flash_attention_bwd", BACKWARD)):
        if kernel not in only:
            continue
        src = (_lib.CSRC / f"{kernel}.cu").read_text()
        # the f32 forward is a source of its own beside the bf16 kernels
        extra = ((_lib.CSRC / "flash_attention_f32.cu",)
                 if kernel == "flash_attention" else ())
        for name, subs in table.items():
            so, p = build(_lib, f"{kernel}.{name}", src, subs, out_dir,
                          extra)
            libs[(kernel, name)] = so
            procs.append((kernel, name, p))
    for family, table, sources in (
            ("int_matmul", INT_MATMUL, ("w8a8_matmul.cu", "w4a8_matmul.cu")),
            ("act_quant", ACT_QUANT, ("act_quant.cu",))):
        if family not in only:
            continue
        for name, subs in table.items():
            so, p = build_set(_lib, family, name, subs, sources, out_dir)
            libs[(family, name)] = so
            procs.append((family, name, p))
    for kernel, name, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc {kernel}.{name}:\n{log.decode()}")
    print(f"built {len(procs)} copies in {time.perf_counter() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int8, device=dev)

    def timed(fn):
        """Device µs a call (chip_smoke's method, 20 calls)."""
        return device_ms(fn, flush, iters=20) * 1e3

    def entry(kernel, variant, name):
        """The copy's C entry point, bound as the package binds it."""
        fn = getattr(ctypes.CDLL(str(libs[(kernel, variant)])), name)
        fn.argtypes = _lib._SIGNATURES[name]
        fn.restype = _lib._RESTYPES.get(name, ctypes.c_int)
        return fn

    def workspace(variant, B, H, K, Smax, hd):
        """The decode copy's workspace, in f64 for the copy that keeps its
        partials in f64 (an f32 copy uses the first half)."""
        n = entry("flash_decode", variant, "flash_decode_workspace_elems")(
            B, H, K, Smax, hd)
        return torch.empty(n, dtype=torch.float64, device=dev)

    results = []

    def report(row):
        results.append(row)
        print(json.dumps(row), flush=True)

    one = torch.zeros(1, device=dev)
    report({"kernel": "one-element fill (the floor)",
            "us": timed(lambda: one.zero_())})

    bf = torch.bfloat16
    H, K, hd, m = 15, 5, 64, 4
    stream = torch.cuda.current_stream().cuda_stream
    for B, S in ((4, 512), (1, 2048)) if "flash_attention" in only else ():
        T = S + m
        q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(bf)
        k = torch.randn((B, T, K, hd), generator=gen, device=dev).to(bf)
        v = torch.randn((B, T, K, hd), generator=gen, device=dev).to(bf)
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        want = flash_attention_plain(qh, kh, vh, prefix_len=m)
        out = torch.empty((B, S, H, hd), dtype=bf, device=dev).transpose(1, 2)
        for name in ATTENTION:
            fn = entry("flash_attention", name, "flash_attention_launch")
            args = (qh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
                    out.data_ptr(), None, 1, 1, B, H, K, S, T, hd, m, m,
                    *qh.stride()[:3], *kh.stride()[:3], *vh.stride()[:3],
                    *out.stride()[:3], stream)
            out.zero_()
            if fn(*args):
                raise SystemExit(f"flash_attention.{name}: launch failed")
            torch.cuda.synchronize()
            report({"kernel": "flash_attention", "variant": name, "B": B,
                    "S": S, "m": m, "us": timed(lambda: fn(*args)),
                    **check(out, want)})

    for Smax, pos_v in ((640, 548), (4096, 4000)) \
            if "flash_decode" in only else ():
        B = 4
        qd = torch.randn((B, H, hd), generator=gen, device=dev).to(bf)
        kq = torch.randint(-127, 128, (B, Smax, K, hd), generator=gen,
                           device=dev, dtype=torch.int8)
        vq = torch.randint(-127, 128, (B, Smax, K, hd), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((B, K), generator=gen, device=dev) * 0.05 + 0.01
        vs = torch.rand((B, K), generator=gen, device=dev) * 0.05 + 0.01
        kc = torch.randn((m, K, hd), generator=gen, device=dev).to(bf)
        vc = torch.randn((m, K, hd), generator=gen, device=dev).to(bf)
        pos = torch.full((B,), pos_v, dtype=torch.int32, device=dev)
        want = flash_decode_plain(qd, kq, vq, pos, ks, vs, kc, vc)
        out = torch.empty((B, H, hd), dtype=bf, device=dev)
        for name in DECODE:
            fn = entry("flash_decode", name, "flash_decode_launch")
            ws = workspace(name, B, H, K, Smax, hd)
            tickets = torch.zeros(B * K, dtype=torch.int32, device=dev)
            args = (qd.data_ptr(), kq.data_ptr(), vq.data_ptr(),
                    ks.data_ptr(), vs.data_ptr(), 1, kc.data_ptr(),
                    vc.data_ptr(), pos.data_ptr(), 1, out.data_ptr(), 1, 1,
                    B, H, K, Smax, hd, m, 0, K, ws.data_ptr(),
                    tickets.data_ptr(), stream)
            out.zero_()
            ws.zero_()
            if fn(*args):
                raise SystemExit(f"flash_decode.{name}: launch failed")
            torch.cuda.synchronize()
            report({"kernel": "flash_decode int8 (B, K)", "variant": name,
                    "B": B, "Smax": Smax, "pos": pos_v,
                    "us": timed(lambda: fn(*args)), **check(out, want)})

    if "int_matmul" in only:
        int_matmul_rows(dev, gen, flush, timed, entry, stream, report)
    if "act_quant" in only:
        act_quant_rows(dev, gen, timed, entry, stream, report)
    if "flash_attention_bwd" in only:
        backward_rows(dev, timed, entry, stream, report)
    if "flash_decode" in only:
        decode_precision(dev, entry, workspace, stream, report)

    rec = ROOT / "chiprun_out"
    rec.mkdir(exist_ok=True)
    name = "kernel_variants.json" if only == set(FAMILIES) else \
        "kernel_variants." + "+".join(sorted(only)) + ".json"
    (rec / name).write_text(
        json.dumps({"card": card, "results": results}, indent=1))


def decode_precision(dev, entry, workspace, stream, report):
    """The one-ulp check over PRECISION_DRAWS draws of the 4096-position
    int8 (B, K) case, per decode copy named in PRECISION."""
    import torch
    from repro_torch.kernels.flash_decode import flash_decode_plain
    bf = torch.bfloat16
    H, K, hd, m = 15, 5, 64, 4
    B, Smax, pos_v = 4, 4096, 4000
    fns = {name: (entry("flash_decode", name, "flash_decode_launch"),
                  workspace(name, B, H, K, Smax, hd)) for name in PRECISION}
    tally = {name: {"outside_one_ulp": 0, "worst_err_over_bound": 0.0}
             for name in PRECISION}
    for draw in range(PRECISION_DRAWS):
        g = torch.Generator(dev).manual_seed(1000 + draw)
        qd = torch.randn((B, H, hd), generator=g, device=dev).to(bf)
        kq = torch.randint(-127, 128, (B, Smax, K, hd), generator=g,
                           device=dev, dtype=torch.int8)
        vq = torch.randint(-127, 128, (B, Smax, K, hd), generator=g,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((B, K), generator=g, device=dev) * 0.05 + 0.01
        vs = torch.rand((B, K), generator=g, device=dev) * 0.05 + 0.01
        kc = torch.randn((m, K, hd), generator=g, device=dev).to(bf)
        vc = torch.randn((m, K, hd), generator=g, device=dev).to(bf)
        pos = torch.full((B,), pos_v, dtype=torch.int32, device=dev)
        want = flash_decode_plain(qd, kq, vq, pos, ks, vs, kc, vc)
        out = torch.empty((B, H, hd), dtype=bf, device=dev)
        for name, (fn, ws) in fns.items():
            tickets = torch.zeros(B * K, dtype=torch.int32, device=dev)
            if fn(qd.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(),
                  vs.data_ptr(), 1, kc.data_ptr(), vc.data_ptr(),
                  pos.data_ptr(), 1, out.data_ptr(), 1, 1, B, H, K, Smax, hd,
                  m, 0, K, ws.data_ptr(), tickets.data_ptr(), stream):
                raise SystemExit(f"flash_decode.{name}: launch failed")
            c = check(out, want)
            tally[name]["outside_one_ulp"] += c["outside_one_ulp"]
            tally[name]["worst_err_over_bound"] = max(
                tally[name]["worst_err_over_bound"],
                c["worst_err_over_bound"])
    for name in PRECISION:
        report({"kernel": "flash_decode int8 (B, K)", "variant": name,
                "B": B, "Smax": Smax, "pos": pos_v,
                "draws": PRECISION_DRAWS,
                "outputs": PRECISION_DRAWS * B * H * hd, **tally[name]})


BWD_DRAWS = 8


def backward_rows(dev, timed, entry, stream, report):
    """Every flash_attention_bwd copy at chip_smoke.py's tuning shape
    (smollm-360m: B = 2, S = 256 behind the 4-row cushion, 15 / 5 heads of
    64, bf16; the forward's own output and log-sum-exp), all rows live and
    rows [1, 4) dead: µs a call and ms a tuning step (32 calls); per output
    (dq, dk, dv) how many entries fall outside the card's bar against
    ``flash_attention_bwd_plain`` (one bf16 ulp of the plain value plus
    1e-5 of its largest entry) and the worst error over that bar; whether
    two calls agree bit for bit and the dead rows are zero. Then the
    as-built copy's device time by kernel (the profiler), and the copies
    named in BWD_PRECISION over BWD_DRAWS more seeded draws."""
    import ctypes

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import (
        _launch, flash_attention_bwd_plain)
    bf = torch.bfloat16
    B, H, K, S, m, hd, L = 2, 15, 5, 256, 4, 64, 32
    T = S + m
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int8, device=dev)

    def flush_l2():
        flush.zero_()

    def inputs(seed, live):
        g = torch.Generator(dev).manual_seed(seed)
        mk = lambda *sh: torch.randn(sh, generator=g, device=dev).to(bf)  # noqa: E731
        q = mk(B, S, H, hd).transpose(1, 2)
        k, v = mk(B, T, K, hd).transpose(1, 2), mk(B, T, K, hd).transpose(1, 2)
        do = mk(B, S, H, hd).transpose(1, 2)
        o, lse = _launch(q, k, v, m, live, with_lse=True)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, m, live)
        return (q, k, v, o, lse, do), want

    def bar(got, want):
        out = {}
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            a, b = a.float(), b.float()
            lim = 2.0 ** -7 * b.abs() + 1e-5 * float(b.abs().max())
            r = (a - b).abs() / lim
            out[name] = {"outside": int((r > 1).sum()),
                         "worst_err_over_bar": float(r.max())}
        return out

    def launcher(variant, ins, live):
        q, k, v, o, lse, do = ins
        fn = entry("flash_attention_bwd", variant,
                   "flash_attention_bwd_launch")
        n = entry("flash_attention_bwd", variant,
                  "flash_attention_bwd_workspace_elems")(1, B, H, K, S, T, hd)
        ws = torch.empty(n, dtype=torch.float32, device=dev)
        outs = tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                     for x in (q, k, v))
        strides = (ctypes.c_longlong * 24)(*[
            s for x in (q, k, v, o, do) + outs for s in x.stride()[:3]])
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), ws.data_ptr(),
                *(x.data_ptr() for x in outs), 1, 1, B, H, K, S, T, hd, m,
                live,
                strides, stream)

        def run():
            if fn(*args):
                raise SystemExit(f"flash_attention_bwd.{variant}: launch "
                                 f"failed")
        run.keep = (ws, strides)
        return run, outs

    for live in (m, 1):
        ins, want = inputs(0, live)
        for name in BACKWARD:
            run, outs = launcher(name, ins, live)
            for x in outs:
                x.zero_()
            run()
            first = tuple(x.clone() for x in outs)
            run()
            torch.cuda.synchronize()
            us = timed(run)
            report({"kernel": "flash_attention_bwd", "variant": name,
                    "B": B, "S": S, "m": m, "prefix_live": live, "us": us,
                    "tuning_step_ms": L * us / 1e3, **bar(outs, want),
                    "repeatable": all(torch.equal(a, b)
                                      for a, b in zip(first, outs)),
                    "dead_rows_zero": not (outs[1][:, :, live:m].any()
                                           or outs[2][:, :, live:m].any())})

    # the timeline copies: one call after an L2 flush, the blocks' stamps
    n_kt, n_qt = (T + 63) // 64, (S + 63) // 64
    G = H // K
    GB = max(g for g in range(1, min(G, 8) + 1) if G % g == 0)
    NC = min(2, 8 // GB)
    CS = GB * NC
    n_q = n_qt * B * H
    n_q_pad = -(-n_q // CS) * CS
    n_kv = n_kt * B * K * CS
    for name in ("timeline", "timeline_dkdv_alone", "timeline_dq_alone"):
        ins, _ = inputs(0, m)
        run, _ = launcher(name, ins, m)
        ws = run.keep[0]
        off = (B * H * S + 1) // 2 * 2
        stamps = ws[off:off + 12 * (n_q_pad + n_kv)].view(torch.int64) \
            .view(n_q_pad + n_kv, 6)
        stamps.zero_()
        run()
        torch.cuda.synchronize()
        stamps.zero_()
        flush_l2()
        run()
        torch.cuda.synchronize()
        st = stamps.cpu().tolist()
        ran = [i for i, s in enumerate(st) if s[5] == 1 and s[2] != 0]
        g_lo = min(st[i][0] for i in ran)
        g_hi = max(st[i][4] for i in ran)
        ghz = sum(st[i][3] - st[i][1] for i in ran) / max(1, sum(
            st[i][4] - st[i][0] for i in ran))

        def steps(i):
            if i < n_q_pad:
                q0 = (n_qt - 1 - i // (B * H)) * 64
                return (min(T, q0 + 64 + m) + 63) // 64
            i -= n_q_pad
            t0 = i // (B * K * CS) * 64
            nq = n_qt - max(0, t0 - m) // 64
            cs, c = -(-nq // NC), i % CS % NC
            return max(0, min(nq - c * cs, cs))

        rows = {}
        for kind, idx in (("dq", [i for i in ran if i < n_q_pad]),
                          ("dkdv", [i for i in ran if i >= n_q_pad
                                    and steps(i) > 0])):
            if not idx:
                continue
            us = sorted((st[i][4] - st[i][0]) / 1e3 for i in idx)
            pre = sorted(st[i][2] - st[i][1] for i in idx)
            per = sorted((st[i][3] - st[i][2]) / steps(i) for i in idx)
            start = sorted((st[i][0] - g_lo) / 1e3 for i in idx)
            rows[kind] = {
                "blocks": len(idx), "block_us_median": us[len(us) // 2],
                "block_us_max": us[-1],
                "preamble_cycles_median": pre[len(pre) // 2],
                "cycles_per_step_median": per[len(per) // 2],
                "cycles_per_step_max": per[-1],
                "start_us_median": start[len(start) // 2],
                "start_us_max": start[-1]}
        report({"kernel": "flash_attention_bwd", "variant": name,
                "span_us": (g_hi - g_lo) / 1e3, "sm_ghz": ghz, **rows,
                "of": "one call after an L2 flush; a step is a query tile "
                      "(dK/dV) or a key tile (dQ)"})

    ins, _ = inputs(0, m)
    run, _ = launcher("as_built", ins, m)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            run()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 20
    report({"kernel": "flash_attention_bwd", "variant": "as_built",
            "by_kernel_us": by, "of": "20 calls back to back, L2 warm"})

    tally = {name: {o: {"outside": 0, "worst_err_over_bar": 0.0}
                    for o in ("dq", "dk", "dv")} for name in BWD_PRECISION}
    for draw in range(BWD_DRAWS):
        live = m if draw % 2 == 0 else 1
        ins, want = inputs(100 + draw, live)
        for name in BWD_PRECISION:
            run, outs = launcher(name, ins, live)
            run()
            for o, c in bar(outs, want).items():
                tally[name][o]["outside"] += c["outside"]
                tally[name][o]["worst_err_over_bar"] = max(
                    tally[name][o]["worst_err_over_bar"],
                    c["worst_err_over_bar"])
    for name in BWD_PRECISION:
        report({"kernel": "flash_attention_bwd", "variant": name,
                "draws": BWD_DRAWS, "prefix_live": "4 and 1 in turn",
                "outputs_each": BWD_DRAWS * B * H * S * hd, **tally[name]})


def int_matmul_rows(dev, gen, flush, timed, entry, stream, report):
    """Every int matmul copy at smollm-360m's sites (chip_smoke.py phase 3):
    w8a8 at qkv, o, up/gate, down and the tied head, w4a8 at the four layer
    sites (one group of 960, or twenty of 128 for down), bf16 scales and
    output; M = 4 summed over one decode step (161 and 160 calls), M = 2048
    over one prefill's layer sites (32 layers). At M = 4 each copy runs
    twice: on int8 codes (x_kind 0, staged as before) and on the bf16
    activation that its staging quantizes (x_kind 2, the main path's
    "fused_step")."""
    import torch
    from repro_torch.kernels.w4a8_matmul import (quant_w4a8_matmul_plain,
                                                 w4a8_matmul_plain)
    from repro_torch.kernels.w8a8_matmul import (quant_w8a8_matmul_plain,
                                                 w8a8_matmul_plain)
    bf = torch.bfloat16
    D, F, V, L = 960, 2560, 49152, 32
    sites = {"qkv": (D, 1600, 1), "o": (D, D, 1), "up_gate": (D, F, 2),
             "down": (F, D, 1)}
    sx = torch.tensor(0.021, device=dev)
    zx = torch.tensor(131.0, device=dev)
    sw8 = torch.tensor(0.0037, device=dev).to(bf)
    cases = []
    for name, (K, N, per) in list(sites.items()) + [("head", (D, V, 1))]:
        w = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        cs = w.sum(0, dtype=torch.int32)
        gs = 128 if K % 128 == 0 else K
        wp = torch.randint(-128, 128, (K // 2, N), generator=gen,
                           device=dev, dtype=torch.int8)
        sw4 = (torch.rand((K // gs, N), generator=gen, device=dev) * 0.002
               + 1e-4).to(bf)
        c4 = torch.randn((N,), generator=gen, device=dev)
        for M in ((4,) if name == "head" else (4, 2048)):
            x = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                              dtype=torch.int8)
            xf = (torch.randn((M, K), generator=gen, device=dev) * 4).to(bf)
            out = torch.empty((M, N), dtype=bf, device=dev)
            runs = [("step" if M == 4 else "prefill", 0, x)]
            if M == 4:
                runs.append(("fused_step", 2, xf))
            for unit, kind, xin in runs:
                q = kind != 0
                w8 = ((quant_w8a8_matmul_plain(xin, w, sx, zx, sw8, cs, bf)
                       if q else
                       w8a8_matmul_plain(xin, w, sx, zx, sw8, cs, -128.0,
                                         bf)),
                      (xin.data_ptr(), kind, w.data_ptr(), cs.data_ptr(),
                       sx.data_ptr(), zx.data_ptr(), sw8.data_ptr(), 1,
                       -128.0, out.data_ptr(), 1, M, N, K))
                w4 = None
                if name != "head":
                    w4 = ((quant_w4a8_matmul_plain(xin, wp, sx, zx, sw4, c4,
                                                   gs, bf)
                           if q else
                           w4a8_matmul_plain(xin, wp, sx, zx, sw4, c4, gs,
                                             -128.0, bf)),
                          (xin.data_ptr(), kind, wp.data_ptr(),
                           sw4.data_ptr(), 1, c4.data_ptr(), sx.data_ptr(),
                           zx.data_ptr(), -128.0, out.data_ptr(), 1, M, N, K,
                           gs))
                # calls per step or prefill: the head once, a site per
                # layer; the operands ride along so their memory stays
                # allocated
                cases.append((name, M, K, N, gs, unit,
                              per if name == "head" else L * per, out, w8,
                              w4, (x, xf, w, cs, wp, sw4, c4)))
    for variant in INT_MATMUL:
        f8 = entry("int_matmul", variant, "w8a8_matmul_launch")
        f4 = entry("int_matmul", variant, "w4a8_matmul_launch")
        elems = entry("int_matmul", variant, "int_matmul_workspace_elems")
        sums = {}
        for name, M, K, N, gs, unit, per, out, w8, w4, _ in cases:
            for kern, fn, spec, grp in (("w8a8_matmul", f8, w8, K),
                                        ("w4a8_matmul", f4, w4, gs)):
                if spec is None:
                    continue
                want, args = spec
                ws = torch.zeros(max(int(elems(M, N, K, grp)), 1),
                                 dtype=torch.int32, device=dev)
                call = (lambda fn=fn, args=args, ws=ws:
                        fn(*args, ws.data_ptr(), stream))
                out.zero_()
                if call():
                    raise SystemExit(f"int_matmul.{variant} {kern}: launch "
                                     f"failed")
                torch.cuda.synchronize()
                wrong = int((out != want).sum())
                us = timed(call)
                key = f"{kern}_{unit}_ms"
                sums[key] = sums.get(key, 0.0) + us / 1e3 * per
                report({"kernel": kern, "variant": variant, "site": name,
                        "M": M, "K": K, "N": N, "unit": unit, "us": us, "outputs_differing": wrong})
        report({"kernel": "int matmuls", "variant": variant,
                "sums": sums, "unit": "step: 161 (w8a8) / 160 (w4a8) "
                "calls at M = 4 on int8 codes; fused_step: the same on bf16 "
                "x quantized in the staging; prefill: 160 calls at M = 2048"})


def act_quant_rows(dev, gen, timed, entry, stream, report):
    """Every act_quant copy at chip_smoke.py's phase-3 shapes (bf16 x):
    act_quant_static and act_quant_ptoken at D = 960 and 2560, M = 4 and
    2048, summed as that script sums them (a decode step: 4 x 960 and one
    2560 a layer, and the head; a prefill: the static quantizer's 160
    layer sites, the per-token one's 160 and its head at M = 4). The M = 4
    rows are timed again with row 1 all zero (``zero_row``): a zero
    dividend takes the IEEE division's slow path."""
    import torch
    from repro_torch.kernels.act_quant import (act_quant_ptoken_plain,
                                               act_quant_static_plain)
    D, F, L, B, MP = 960, 2560, 32, 4, 2048
    s = torch.tensor(0.027, device=dev)
    z = torch.tensor(117.0, device=dev)
    xs = {}
    for Dd in (D, F):
        for M in (B, MP):
            x = (torch.randn((M, Dd), generator=gen, device=dev) * 3
                 + 0.2).to(torch.bfloat16)
            xs[(Dd, M, False)] = x
            if M == B:
                x = x.clone()
                x[1] = 0.0
                xs[(Dd, M, True)] = x
    xs = {k: (x, act_quant_static_plain(x, s, z), act_quant_ptoken_plain(x))
          for k, x in xs.items()}
    for variant in ACT_QUANT:
        fs = entry("act_quant", variant, "act_quant_static_launch")
        fp = entry("act_quant", variant, "act_quant_ptoken_launch")
        us = {}
        for (Dd, M, zr), (x, want_s, want_p) in xs.items():
            out = torch.zeros((M, Dd), dtype=torch.int8, device=dev)
            sc = torch.zeros((M, 1), device=dev)
            zp = torch.zeros((M, 1), device=dev)
            calls = {
                "act_quant_static": (lambda x=x, out=out: fs(
                    x.data_ptr(), 1, s.data_ptr(), z.data_ptr(),
                    out.data_ptr(), x.numel(), stream)),
                "act_quant_ptoken": (lambda x=x, out=out, sc=sc, zp=zp: fp(
                    x.data_ptr(), 1, out.data_ptr(), sc.data_ptr(),
                    zp.data_ptr(), 0, 0, 0, M, Dd, 255.0, stream))}
            for kern, call in calls.items():
                out.zero_()
                if call():
                    raise SystemExit(f"act_quant.{variant} {kern}: launch "
                                     f"failed")
                torch.cuda.synchronize()
                want = want_s if kern == "act_quant_static" else want_p[0]
                us[(kern, Dd, M, zr)] = timed(call)
                report({"kernel": kern, "variant": variant, "D": Dd, "M": M,
                        "zero_row": zr, "us": us[(kern, Dd, M, zr)],
                        "outputs_differing": int((out != want).sum())})
        sums = {}
        for kern in ("act_quant_static", "act_quant_ptoken"):
            for zr in (False, True):
                u = {(Dd, M): v for (k, Dd, M, r), v in us.items()
                     if k == kern and r == zr}
                step = L * (4 * u[(D, B)] + u[(F, B)]) + u[(D, B)]
                sums[f"{kern}_step_ms" + ("_zero_row" if zr else "")] = \
                    step / 1e3
            pre = L * (4 * us[(kern, D, MP, False)] + us[(kern, F, MP, False)])
            if kern == "act_quant_ptoken":
                pre += us[(kern, D, B, False)]
            sums[f"{kern}_prefill_ms"] = pre / 1e3
        report({"kernel": "act quantizers", "variant": variant,
                "sums": sums, "unit": "step: 161 calls at M = 4 (the "
                "standalone static quantizer no longer runs there; "
                "_zero_row: each call's row 1 all zero); prefill: 160 "
                "static calls at M = 2048, 161 per-token calls (the head at "
                "M = 4)"})

if __name__ == "__main__":
    main()
