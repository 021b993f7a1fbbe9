#!/usr/bin/env python3
"""Where the time of the port's two attention kernels goes, on one card.

    python3 tools/kernel_variants.py        # from the root of a checkout

Builds ablated copies of ``csrc/flash_attention.cu`` and
``csrc/flash_decode.cu``, each one named text substitution away from the
source (``ATTENTION``, ``DECODE`` below), every copy into its own shared
library by its own ``nvcc`` (all started together), and times each copy at
``chip_smoke.py``'s phase-3 shapes with that script's ``device_ms``: the
L2 flushed before every call, device time between CUDA events, the card
kept busy while the host enqueues. Each copy is bound with the package's
own C signatures (``kernels/_lib.py``) and its decode workspace sized by
the copy's own ``flash_decode_workspace_elems``. A substitution whose text
the source no longer holds stops the script before anything is built, so
a change to a kernel source shows here as that error, never as a wrong
ablation. A one-element fill is timed the same way: the
floor of the method (launch and events). Each result line gives device µs
per call, how many outputs (written into a zeroed buffer) fall outside the
one-bf16-ulp check against the plain version, and the largest error over
its bound: copies that drop work fail it by design and time what they
leave. Last, the decode copies named in ``PRECISION`` are held to that
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


if __name__ == "__main__":
    main()
