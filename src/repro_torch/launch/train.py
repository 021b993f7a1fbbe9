"""Fault-tolerant training launcher, ported from ``repro/launch/train.py``
with its flags and defaults, on the card unless ``--device cpu``.

    python -m repro_torch.launch.train --arch smollm-360m
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch paper_tiny --steps 5 --batch 2 --seq 32

Weights are random, made from ``--seed`` by a ``torch.Generator`` on the
run's device; batches come from ``data/pipeline.py`` (a copy of the
reference's) with the reference's seeds, so a run gets the reference's
batches. The ``Supervisor`` (``distributed/fault_tolerance.py``) retries a
failed step from the latest checkpoint and replays the pipeline from its
step; ``--resume`` restores ``{"params", "opt"}`` from the latest
checkpoint in ``--ckpt-dir``, the reference's format, so a checkpoint that
the JAX launcher wrote resumes here. Metrics are fetched from the card
every 20 steps (``monitoring.host_sync``), where the reference logs them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from repro_torch import monitoring as MON
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.configs import QuantConfig, RunConfig, get_config, reduced
from repro_torch.data.pipeline import Pipeline, SyntheticCorpus
from repro_torch.distributed.fault_tolerance import Supervisor
from repro_torch.models.registry import build
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.trainer import eval_ppl, make_optimizer, make_train_step

LOG_EVERY = 20


def main(argv=None, pipe: Pipeline = None):
    """Train; returns ``(state, eval perplexity)``, ``state`` being
    ``{"params", "opt"}`` as the reference's. ``pipe``: an already built
    ``Pipeline`` of ``--batch`` x ``--seq`` over the arch's vocabulary and
    ``--seed`` (a caller that launches several runs builds the synthetic
    corpus once; at a 49,152-id vocabulary that takes a minute and more)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_tiny")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config of the arch family")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--quant", default="none")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg, dtype="float32")
    api = build(cfg, args.device)
    dev = api.device
    run = RunConfig(model=cfg, quant=QuantConfig(mode=args.quant),
                    seq_len=args.seq, global_batch=args.batch, lr=args.lr,
                    train_steps=args.steps,
                    warmup_steps=max(10, args.steps // 20))

    if pipe is None:
        corpus = SyntheticCorpus(cfg.vocab_size, seed=args.seed)
        pipe = Pipeline(corpus, batch=args.batch, seq_len=args.seq,
                        seed=args.seed)
    elif (pipe.batch, pipe.seq_len, pipe.seed, pipe.corpus.vocab_size) != (
            args.batch, args.seq, args.seed, cfg.vocab_size):
        raise ValueError(
            f"the given pipeline draws {pipe.batch} x {pipe.seq_len} with "
            f"seed {pipe.seed} over {pipe.corpus.vocab_size} ids; this run "
            f"needs {args.batch} x {args.seq}, seed {args.seed}, "
            f"{cfg.vocab_size} ids")

    def batch_of(step):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in pipe.get_batch(step).items()}

    params = api.init_params(
        torch.Generator(dev).manual_seed(args.seed)).tree()
    opt = make_optimizer(run)
    opt_state = opt.init(params)
    step_fn = make_train_step(api, run, opt)

    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    state = {"params": params, "opt": opt_state._asdict()}
    step0 = 0
    if args.resume and ckpt.latest_step() is not None:
        step0 = ckpt.latest_step()
        state = ckpt.restore(step0, like=state)
        print(f"[train] resumed from step {step0}")

    sup = Supervisor(ckpt, save_every=args.save_every)
    log = []

    def do_step(state, step):
        p, o, metrics = step_fn(state["params"],
                                AdamWState(**state["opt"]), batch_of(step))
        return {"params": p, "opt": o._asdict()}, metrics

    def on_metrics(step, metrics):
        if step % LOG_EVERY == 0:
            rec = {"step": step, **{k: float(v) for k, v in
                                    MON.host_sync(metrics).items()}}
            log.append(rec)
            print(f"[train] step={step} loss={rec['loss']:.4f} "
                  f"lr={rec.get('lr', 0):.2e}")

    t0 = time.time()
    state, report = sup.run(state, step0, args.steps - step0, do_step,
                            on_metrics=on_metrics)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0

    eval_batches = [batch_of(10_000 + i) for i in range(args.eval_batches)]
    ppl = eval_ppl(api, state["params"], eval_batches, run.quant)
    print(f"[train] done steps={report.completed_steps} wall={wall:.1f}s "
          f"eval_ppl={ppl:.3f} failures={report.failures} "
          f"stragglers={len(report.stragglers)}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"ppl": ppl, "wall_s": wall, "log": log,
                       "report": dataclasses.asdict(report)}, f)
    return state, ppl


if __name__ == "__main__":
    main()
