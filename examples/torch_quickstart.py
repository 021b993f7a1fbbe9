"""Quickstart with the PyTorch port: train a tiny LM, discover a
CushionCache, and compare per-tensor static W8A8 with and without it. On
the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] \
        [--steps 120]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import (CushionConfig, QuantConfig, RunConfig,
                                 get_config)
from repro_torch.core import cushioncache as CC
from repro_torch.core.calibration import calibrate
from repro_torch.data.pipeline import Pipeline, SyntheticCorpus
from repro_torch.launch.serve import to_device
from repro_torch.models.registry import build
from repro_torch.train.trainer import eval_ppl, make_optimizer, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--tune-steps", type=int, default=40)
    args = ap.parse_args(argv)
    cfg = get_config("paper_tiny")
    api = build(cfg, args.device)
    dev = api.device
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    pipe = Pipeline(corpus, batch=8, seq_len=128, seed=0)

    def batch(i, rows=None):
        b = to_device(pipe.get_batch(i), dev)
        return b if rows is None else {k: v[:rows] for k, v in b.items()}

    # 1. train a small model so activations have structure
    run = RunConfig(model=cfg, seq_len=128, global_batch=8, lr=2e-3,
                    train_steps=args.steps, warmup_steps=10)
    params = api.init_params(torch.Generator(dev).manual_seed(0)).tree()
    opt = make_optimizer(run)
    st = opt.init(params)
    step = make_train_step(api, run, opt)
    for i in range(run.train_steps):
        params, st, m = step(params, st, batch(i))
        if i % 40 == 0:
            print(f"step {i}: loss {float(m['loss']):.3f}")

    evalb = [batch(9000 + i) for i in range(4)]
    calb = [batch(8000 + i) for i in range(4)]

    # 2. baseline: fp against per-tensor static W8A8
    qn, qs = QuantConfig(mode="none"), QuantConfig(mode="pt_static")
    scales, _ = calibrate(api, params, calb, qs)
    print(f"FP ppl:            {eval_ppl(api, params, evalb, qn):.3f}")
    print(f"W8A8 static ppl:   "
          f"{eval_ppl(api, params, evalb, qs, scales=scales):.3f}")

    # 3. CushionCache: greedy search + quantization-aware prefix tuning
    ccfg = CushionConfig(max_prefix_len=4, tau=0.98, n_candidates=32,
                         tune_steps=args.tune_steps, seed_tokens=(1,))

    def tune_iter():
        i = 0
        while True:
            yield batch(6000 + i)
            i += 1
    cushion, sr, _ = CC.discover(api, params, lambda i: batch(5000 + i, 1),
                                 tune_iter(), QuantConfig(mode="pt_dynamic"),
                                 ccfg, torch.Generator().manual_seed(1))
    print(f"prefix tokens: {sr.prefix_ids.tolist()}")

    # 4. quantize WITH the cushion (recalibrated for the deployment)
    cscales, _ = calibrate(api, params, calb, qs, cushion=cushion)
    ppl = eval_ppl(api, params, evalb, qs, cushion=cushion, scales=cscales)
    print(f"W8A8 static + CushionCache ppl: {ppl:.3f}")


if __name__ == "__main__":
    main()
