#!/usr/bin/env python3
"""Device time of one decode step by kernel, on one card.

    python3 tools/step_profile.py [--src DIR] [--out FILE]

Builds smollm-360m at full width and depth with seeded random weights and
a 4-token seeded cushion, and for static W8A8 (int8 KV), W4A8 (int8 KV) and
ptoken_dynamic (fp KV) replays the static ``Engine``'s captured decode
step (the CUDA graph that ``generate`` replays) at B = 4 after a 512-token
prefill, under ``torch.profiler``: the device time of every kernel, summed
by name over 6 replays and divided by 6, and the total (``chip_smoke.py``
phase 4 reports the same total); then the same step run eagerly, its
total beside (``eager_device_ms_per_step``). pt_static scales are
calibrated on two batches of seeded random token ids (not the synthetic
corpus, which takes ~80 s of host time to build); the kernels' work does not
depend on the token values. ``--src`` imports ``repro_torch`` from another
source tree that has the captured step (another commit, unpacked), so two
versions can be compared in one call. Writes ``chiprun_out/step_profile.json`` unless
``--out`` says otherwise.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
STEPS = 6


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "step_profile.json"))
    args = ap.parse_args()
    # chip_smoke puts this checkout's src first on import: --src goes
    # before it
    from chip_smoke import by_kernel
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script profiles the "
                         "card")
    import repro_torch
    from repro_torch.configs import QuantConfig, get_config
    from repro_torch.launch.serve import seeded_cushion
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("smollm-360m")
    api = build(cfg, "cuda")
    params = api.init_params(torch.Generator(dev).manual_seed(0))
    cushion = seeded_cushion(api, params, 4, seed=0)
    rs = np.random.RandomState(0)

    def tokens():
        return {"tokens": torch.as_tensor(
            rs.randint(0, cfg.vocab_size, (4, 512)), device=dev)}

    calib = [tokens(), tokens()]
    batch = tokens()
    qw8 = QuantConfig(mode="pt_static", true_int8=True)
    out = {"src": str(Path(repro_torch.__file__).parent), "steps": STEPS}
    print(f"repro_torch from {out['src']}", flush=True)
    scales = None
    for label, qcfg, kv, pre, wb in (
            ("w8a8_int8kv", qw8, "int8", True, 8),
            ("w4a8_int8kv", qw8, "int8", True, 4),
            ("ptoken_fp", QuantConfig(mode="ptoken_dynamic"), None, False,
             8)):
        eng = Engine(api, params, qcfg, cushion=cushion, max_seq=640,
                     kv_dtype=kv, calib_batches=calib if pre else None,
                     scales=scales if pre else None, prequant=pre,
                     weight_bits=wb)
        scales = eng.scales if pre else scales
        eng.generate(batch, 4)              # warm-up; captures the step
        with torch.inference_mode():
            st, _ = eng._run_prefill(batch)
            tok, pos = st.tok.clone(), st.pos.clone()

            def eager():
                logits, _ = eng._decode(tok, pos, st.cache)
                tok.copy_(torch.argmax(logits, dim=-1))
                pos.add_(1)

            totals = {}
            for name, step in (("graph", st.step), ("eager", eager)):
                for _ in range(2):
                    step()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(STEPS):
                        step()
                    torch.cuda.synchronize()
                totals[name] = by_kernel(prof, STEPS, top=None)
        rows = totals["graph"]
        total = sum(ms for _, ms in rows.values())
        eager_total = sum(ms for _, ms in totals["eager"].values())
        out[label] = {"device_ms_per_step": total, "kernels": rows,
                      "eager_device_ms_per_step": eager_total,
                      "graph_nodes": eng.states[4].graph.n_nodes}
        print(f"{label}: device ms per decode step {total:.4f} (graph "
              f"replays), {eager_total:.4f} (eager)", flush=True)
        for name, (calls, ms) in list(rows.items())[:12]:
            print(f"  {ms:8.4f} ms {calls:7.1f} calls  {name[:90]}",
                  flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
