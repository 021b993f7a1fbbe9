"""CushionCache tuning launcher: search -> tune -> save a versioned cushion
artifact that ``launch/serve.py --cushion DIR`` serves, on the card unless
``--device cpu``.

    python -m repro_torch.launch.tune --arch paper_tiny --steps 60 \
        --out-dir artifacts/cushion --with-scales

The paper's two stages, as in the reference's launcher:

  1. greedy token search (``core.cushioncache.greedy_search``, KV-reuse
     scoring) over calibration samples;
  2. the prefix KV artifact in the model dtype
     (``ModelAPI.extract_cushion``);
  3. gradient prefix tuning of the cushion KV
     (``core.cushioncache.prefix_tune``: CE + λ·activation-range
     regularizer, metrics drained every ``--log-every`` steps);
  4. ``--with-scales``: pt_static site scales calibrated under the tuned
     cushion, stored with its fingerprint;
  5. ``checkpoint.store.CheckpointManager`` saves ``{"cushion": ...,
     "scales": ...}`` with the fingerprint and the tuning metadata in the
     manifest's ``extra``: the reference's artifact format, which either
     side reads.

Batches come from ``data/pipeline.py`` (a copy of the reference's) with the
reference's seeds, so a run gets the reference's samples, tuning and eval
batches; the candidate pools differ (``candidate_pool`` draws from a
``torch.Generator``). Weights are random, made from ``--seed``, unless
``--ckpt-dir`` restores the ``params`` subtree of a checkpoint. Before /
after quality numbers (last-block max-activation top-1, held-out
perplexity) print at the end and land in ``--report-json``.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.configs import (CushionConfig, Family, QuantConfig,
                                 get_config)
from repro_torch.core import cushioncache as CC
from repro_torch.core import outliers as OUT
from repro_torch.data.pipeline import Pipeline, SyntheticCorpus
from repro_torch.models import convert
from repro_torch.models.registry import build
from repro_torch.train.trainer import eval_ppl


def _make_batch_fns(api, cfg, args):
    """(sample_fn for the search, tuning batch generator, held-out eval
    batches): token-only families draw from the synthetic pipeline with the
    reference launcher's seeds and disjoint step ranges; a family with
    other inputs (a VLM's patches) draws whole batches with
    ``ModelAPI.make_batch``, with the reference launcher's seeds for a
    ``torch.Generator``."""
    if cfg.family in (Family.VLM, Family.ENCDEC):
        def draw(seed, b, n):
            return api.make_batch(torch.Generator().manual_seed(seed), b, n)

        def sample_fn(i):
            return draw(args.seed * 7919 + i, 1, args.sample_len)

        def tune_batches():
            i = 0
            while True:
                yield draw(args.seed * 104729 + 3000 + i, args.batch,
                           args.seq_len)
                i += 1

        eval_batches = [draw(args.seed * 7 + 7000 + i, args.batch,
                             args.seq_len) for i in range(args.eval_batches)]
        return sample_fn, tune_batches(), eval_batches

    dev = api.device
    corpus = SyntheticCorpus(cfg.vocab_size, seed=args.seed)
    sample_pipe = Pipeline(corpus, batch=1, seq_len=args.sample_len,
                           seed=args.seed + 1)
    tune_pipe = Pipeline(corpus, batch=args.batch, seq_len=args.seq_len,
                         seed=args.seed + 2)

    def as_dev(b):
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    def sample_fn(i):
        return as_dev(sample_pipe.get_batch(i))

    def tune_batches():
        i = 0
        while True:
            yield as_dev(tune_pipe.get_batch(3000 + i))
            i += 1

    eval_batches = [as_dev(tune_pipe.get_batch(7000 + i))
                    for i in range(args.eval_batches)]
    return sample_fn, tune_batches(), eval_batches


def _quality(api, params, cushion, eval_batches):
    """(max-activation top-1 of the last block's input, held-out ppl)."""
    qnone = QuantConfig(mode="none")
    top1 = OUT.last_block_input_stats(api, params, eval_batches[0], qnone,
                                      cushion=cushion)["top1"]
    ppl = eval_ppl(api, params, eval_batches, qnone, cushion=cushion)
    return top1, ppl


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_tiny")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out-dir", required=True,
                    help="artifact store (checkpoint.store versioned dir)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the params subtree of the latest "
                         "checkpoint there (the reference's layout)")
    # search stage
    ap.add_argument("--max-prefix-len", type=int, default=8)
    ap.add_argument("--candidates", type=int, default=64)
    ap.add_argument("--tau", type=float, default=1.0)
    ap.add_argument("--sample-len", type=int, default=64,
                    help="calibration sample length for the greedy search")
    # tune stage
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lam", type=float, default=0.05,
                    help="λ on the activation-range regularizer (eq. 11)")
    ap.add_argument("--log-every", type=int, default=10,
                    help="tuning metric host-sync cadence (steps per "
                         "blocking transfer)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=48,
                    help="tuning/eval batch sequence length")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel tuning width (not ported: 1 only)")
    ap.add_argument("--quant", default="pt_dynamic",
                    help="quantized-forward mode the tuning loss runs "
                         "under (straight-through fake quant)")
    ap.add_argument("--eval-batches", type=int, default=4)
    # artifact contents
    ap.add_argument("--with-scales", action="store_true",
                    help="calibrate pt_static site scales under the tuned "
                         "cushion and store them (fingerprint-tagged) in "
                         "the artifact")
    ap.add_argument("--calib-batches", type=int, default=2)
    ap.add_argument("--report-json", default=None,
                    help="write the search/tune log + quality numbers here")
    args = ap.parse_args(argv)
    if args.dp > 1:
        raise NotImplementedError(
            "--dp > 1: data-parallel tuning is not ported (ROADMAP queue 1 "
            "item 6.1, multi-GPU)")

    cfg = get_config(args.arch)
    api = build(cfg, args.device)
    dev = api.device
    params = api.init_params(torch.Generator(dev).manual_seed(args.seed))
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        step = ckpt.latest_step()
        if step is not None:
            tree, _ = ckpt.restore_tree(step)
            params = convert.params_from_numpy(tree["params"], dev)
            print(f"[tune] restored step {step}")

    qcfg = QuantConfig(mode=args.quant)
    ccfg = CushionConfig(max_prefix_len=args.max_prefix_len, tau=args.tau,
                         sample_len=args.sample_len,
                         n_candidates=args.candidates, seed_tokens=(1,),
                         lam=args.lam, tune_steps=args.steps,
                         tune_lr=args.lr, log_every=args.log_every)
    sample_fn, tune_iter, eval_batches = _make_batch_fns(api, cfg, args)

    # stage 1: greedy search + artifact extraction (model dtype)
    greedy, sr, _ = CC.discover(api, params, sample_fn, iter(()), qcfg,
                                ccfg, torch.Generator().manual_seed(
                                    args.seed + 2), skip_tune=True)
    print(f"[tune] greedy prefix {sr.prefix_ids.tolist()} "
          f"({sr.wall_time_s:.1f}s, {len(sr.history)} iterations)")
    g_top1, g_ppl = _quality(api, params, greedy, eval_batches)

    # stage 2: gradient prefix tuning of the cushion KV block
    tr = CC.prefix_tune(api, params, greedy, tune_iter, qcfg, ccfg)
    tuned = tr.cushion
    t_top1, t_ppl = _quality(api, params, tuned, eval_batches)
    print(f"[tune] {args.steps} steps in {tr.wall_time_s:.1f}s; "
          f"max-activation top1 {g_top1:.1f} -> {t_top1:.1f}, "
          f"held-out ppl {g_ppl:.2f} -> {t_ppl:.2f}")

    fp = CC.cushion_fingerprint(tuned)
    tree = {"cushion": tuned}
    extra = {"kind": "cushion", "arch": cfg.name,
             "family": str(cfg.family), "dtype": cfg.dtype,
             "fingerprint": fp,
             "prefix_ids": [int(t) for t in sr.prefix_ids],
             "quant_mode": args.quant, "tune_steps": args.steps,
             "lam": args.lam, "lr": args.lr, "smoke": False,
             "device": str(dev),
             "maxact_top1": {"greedy": g_top1, "tuned": t_top1},
             "ppl": {"greedy": g_ppl, "tuned": t_ppl}}
    if args.with_scales:
        from repro_torch.core.calibration import (calibrate_tagged,
                                                  scales_to_plain)
        qstat = QuantConfig(mode="pt_static", true_int8=True)
        calib = [b for _, b in zip(range(args.calib_batches), tune_iter)]
        tagged, _ = calibrate_tagged(api, params, calib, qstat,
                                     cushion=tuned)
        tree["scales"] = scales_to_plain(tagged.scales)
        extra["scales_cushion_fp"] = tagged.cushion_fp
        print(f"[tune] pt_static scales calibrated under the tuned cushion "
              f"({len(calib)} batches)")

    store = CheckpointManager(args.out_dir)
    version = (store.latest_step() or 0) + 1
    path = store.save(version, tree, extra=extra)
    print(f"[tune] artifact v{version} -> {path} "
          f"(fingerprint {fp[:12]}, scales="
          f"{'yes' if 'scales' in tree else 'no'})")

    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump({"search": sr.history, "tune_log": tr.log,
                       "artifact": path, **extra}, f, indent=1)
        print(f"[tune] report -> {args.report_json}")
    return path


if __name__ == "__main__":
    main()
