#!/usr/bin/env python3
"""Where the time of the port's attention kernels, int matmuls and
activation quantizers goes, on one card.

    python3 tools/kernel_variants.py        # from the root of a checkout

Builds ablated copies of ``csrc/flash_attention.cu``,
``csrc/flash_decode.cu``, the int matmuls' shared mainloop
``csrc/int_matmul.cuh`` (built with ``w8a8_matmul.cu`` and
``w4a8_matmul.cu``) and the quantizers (``act_quant.cu`` with its
``act_quant.cuh``, whose arithmetic the int matmuls' decode staging shares),
each one named text substitution away from the source (``ATTENTION``,
``DECODE``, ``INT_MATMUL``, ``ACT_QUANT`` below), every copy into
its own shared library by its own ``nvcc`` (all started together), and
times each copy at
``chip_smoke.py``'s phase-3 shapes with that script's ``device_ms``: the
L2 flushed before every call, device time between CUDA events, the card
kept busy while the host enqueues. Each copy is bound with the package's
own C signatures (``kernels/_lib.py``) and its decode workspace sized by
the copy's own ``flash_decode_workspace_elems``. A substitution whose text
the source no longer holds stops the script before anything is built, so
a change to a kernel source shows here as that error, never as a wrong
ablation. A one-element fill is timed the same way: the
floor of the method (launch and events). Each attention result line gives
device µs per call, how many outputs (written into a zeroed buffer) fall
outside the one-bf16-ulp check against the plain version, and the largest
error over its bound; each int matmul line the µs of every main-path site
at M = 4 (decode; on int8 codes and on the bf16 activation the staging
quantizes) or M = 2048 (prefill), their sum over one decode step or one
prefill, and how many outputs differ from the plain version; each
quantizer line the µs of every phase-3 shape and the sums over a step and a
prefill: copies that drop work fail by design and time what they leave. Last, the decode copies named in ``PRECISION`` are held to that
check on more seeded draws of the 4096-position case. Needs one NVIDIA
card and nvcc; writes ``chiprun_out/kernel_variants.json``.
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
    "four_blocks_per_sm": [("__launch_bounds__(TTHREADS, 3)",
                            "__launch_bounds__(TTHREADS, 4)")],
    # every warp computes every tile its block loads
    "no_warp_tile_skip": [("    if (t0 <= q0 + warp * 16 + 15 + P) {",
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
int launch_ptoken(const T* x, int8_t* out, float* scale, float* zero, int M,
                  int D, float qmax, cudaStream_t st) {
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
  if (vpl <= 24) {
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
# the decode copies whose outputs are checked on more data (pos 4000 of
# 4096, int8 (B, K)), and on how many seeded draws
PRECISION = ("as_built", "f32_dots", "f64_sums")
PRECISION_DRAWS = 8


def build(lib, name, source, subs, out_dir):
    text = source
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    cu = out_dir / f"{name}.cu"
    cu.write_text(text)
    so = out_dir / f"{name}.so"
    cmd = [lib._nvcc(), *lib.NVCC_FLAGS, "-shared", str(cu), "-o", str(so)]
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


def main() -> None:
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
                          ("flash_decode", DECODE)):
        src = (_lib.CSRC / f"{kernel}.cu").read_text()
        for name, subs in table.items():
            so, p = build(_lib, f"{kernel}.{name}", src, subs, out_dir)
            libs[(kernel, name)] = so
            procs.append((kernel, name, p))
    for family, table, sources in (
            ("int_matmul", INT_MATMUL, ("w8a8_matmul.cu", "w4a8_matmul.cu")),
            ("act_quant", ACT_QUANT, ("act_quant.cu",))):
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

    def check(got, want):
        """Outputs outside |err| <= 2^-7 |want| + 1e-6, and the largest
        err / that bound."""
        got, want = got.float(), want.float()
        ratio = (got - want).abs() / (2.0 ** -7 * want.abs() + 1e-6)
        return {"outside_one_ulp": int((ratio > 1).sum()),
                "worst_err_over_bound": float(ratio.max())}

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
    for B, S in ((4, 512), (1, 2048)):
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
                    out.data_ptr(), 1, B, H, K, S, T, hd, m,
                    *qh.stride()[:3], *kh.stride()[:3], *vh.stride()[:3],
                    *out.stride()[:3], stream)
            out.zero_()
            if fn(*args):
                raise SystemExit(f"flash_attention.{name}: launch failed")
            torch.cuda.synchronize()
            report({"kernel": "flash_attention", "variant": name, "B": B,
                    "S": S, "m": m, "us": timed(lambda: fn(*args)),
                    **check(out, want)})

    for Smax, pos_v in ((640, 548), (4096, 4000)):
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
                    B, H, K, Smax, hd, m, ws.data_ptr(), tickets.data_ptr(),
                    stream)
            out.zero_()
            ws.zero_()
            if fn(*args):
                raise SystemExit(f"flash_decode.{name}: launch failed")
            torch.cuda.synchronize()
            report({"kernel": "flash_decode int8 (B, K)", "variant": name,
                    "B": B, "Smax": Smax, "pos": pos_v,
                    "us": timed(lambda: fn(*args)), **check(out, want)})

    int_matmul_rows(dev, gen, flush, timed, entry, stream, report)
    act_quant_rows(dev, gen, timed, entry, stream, report)

    # precision at length: the one-ulp check over PRECISION_DRAWS draws of
    # the 4096-position int8 (B, K) case, per decode copy
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
                  m, ws.data_ptr(), tickets.data_ptr(), stream):
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

    rec = ROOT / "chiprun_out"
    rec.mkdir(exist_ok=True)
    (rec / "kernel_variants.json").write_text(
        json.dumps({"card": card, "results": results}, indent=1))


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
                    zp.data_ptr(), M, Dd, 255.0, stream))}
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
