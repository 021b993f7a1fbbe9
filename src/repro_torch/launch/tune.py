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
``--ckpt-dir`` restores the ``params`` subtree of a checkpoint (of either
package's ``launch/train.py``). ``--smoke`` takes the arch's reduced f32
config, as the reference's, and the artifact records it, so smoke
artifacts of either package load in the other's ``serve.py --smoke``.
Before / after quality numbers (last-block max-activation top-1, held-out
perplexity) print at the end and land in ``--report-json``.

``--dp N`` tunes data-parallel over N ranks (``launch/mesh.spawn_mesh``:
one process a rank, gloo where ranks share a card or on the CPU): rank 0
runs the greedy search and broadcasts the prefix ids, every rank extracts
the cushion and tunes it on its rows of each ``--batch`` (which N must
divide) with the cushion and its moments replicated
(``prefix_tune(mesh=)``), and rank 0 evaluates, calibrates
``--with-scales`` and writes the one artifact. The report's ``ranks``
holds each rank's tuning launches and tuned-cushion fingerprint (equal on
every rank; the tuning log's ``ranks_equal`` is 1 after every step). Two
ranks on one card time-slice it through the host: that is not data
parallelism's speed.

    python -m repro_torch.launch.tune --device cpu --arch paper_tiny \
        --dp 2 --out-dir /tmp/art
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.configs import (CushionConfig, Family, QuantConfig,
                                 get_config, reduced)
from repro_torch.core import cushioncache as CC
from repro_torch.core import outliers as OUT
from repro_torch.data.pipeline import Pipeline, SyntheticCorpus
from repro_torch.kernels import _lib
from repro_torch.launch.mesh import spawn_mesh
from repro_torch.launch.serve import restore_params
from repro_torch.models.registry import build
from repro_torch.train.trainer import check_data_parallel, eval_ppl


def _make_batch_fns(api, cfg, args, corpus=None):
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
    if corpus is None:
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


def main(argv=None, corpus: SyntheticCorpus = None):
    """Run the launcher; returns the artifact's path. ``corpus``: an
    already built ``SyntheticCorpus`` of the arch's vocabulary and
    ``--seed`` (a caller that launches several runs builds it once; at a
    49,152-id vocabulary that takes a minute and more)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_tiny")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (matches serve --smoke so a smoke "
                         "artifact serves against smoke params)")
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
                    help="tune over a data axis of this many ranks, each "
                         "on its rows of every batch (cushion and optimizer "
                         "state replicated)")
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
    if args.dp < 1:
        ap.error("--dp must be >= 1")
    if args.batch % args.dp:
        ap.error(f"--batch {args.batch} must divide over --dp {args.dp}")
    if args.dp == 1:
        ranks = [tune(args, corpus=corpus)]
    else:
        try:
            check_data_parallel(_config(args), data=args.dp)
        except ValueError as e:
            raise SystemExit(f"[tune] {e}")
        ranks = spawn_mesh(tune_rank, args.dp, 1, args, corpus,
                           device=args.device, every_rank=True)
        fps = {r["fingerprint"] for r in ranks}
        if len(fps) != 1:
            raise RuntimeError(f"--dp {args.dp}: the ranks tuned "
                               f"{len(fps)} different cushions")
    if args.report_json:
        with open(args.report_json) as f:
            rep = json.load(f)
        rep["ranks"] = [{k: v for k, v in r.items() if k != "path"}
                        for r in ranks]
        with open(args.report_json, "w") as f:
            json.dump(rep, f, indent=1)
    return ranks[0]["path"]


def _config(args):
    cfg = get_config(args.arch)
    return reduced(cfg, dtype="float32") if args.smoke else cfg


def tune_rank(mesh, args, corpus=None):
    """One rank of ``--dp N`` (a ``spawn_mesh`` target): ``tune`` on the
    rank's device and mesh; only rank 0 prints."""
    if mesh.data_rank != 0:
        sys.stdout = open(os.devnull, "w")
    print(f"[tune] data-parallel tuning over {mesh.data_size} ranks "
          f"({mesh.backend}), rank 0 on {mesh.device}")
    return tune(args, mesh, corpus)


def tune(args, mesh=None, corpus=None):
    """Search, tune and (rank 0) save as ``args`` say, on ``mesh``'s
    device and data axis when given. Returns this rank's ``{"path"`` (rank
    0's artifact, None elsewhere), ``"fingerprint"`` (of its tuned
    cushion), ``"tune_launches"`` (the kernels launched by its tuning
    steps), ``"tune_s"``, ``"cushion_move"`` (each KV leaf's mean |tuned -
    greedy|), ``"peak_bytes"}`` (the card's peak during the tuning; None
    on the CPU)."""
    lead = mesh is None or mesh.data_rank == 0
    cfg = _config(args)
    api = build(cfg, args.device if mesh is None else mesh.device)
    dev = api.device
    params = api.init_params(torch.Generator(dev).manual_seed(args.seed))
    if args.ckpt_dir:
        params = restore_params(args.ckpt_dir, params)

    qcfg = QuantConfig(mode=args.quant)
    ccfg = CushionConfig(max_prefix_len=args.max_prefix_len, tau=args.tau,
                         sample_len=args.sample_len,
                         n_candidates=args.candidates, seed_tokens=(1,),
                         lam=args.lam, tune_steps=args.steps,
                         tune_lr=args.lr, log_every=args.log_every)
    sample_fn, tune_iter, eval_batches = _make_batch_fns(api, cfg, args,
                                                         corpus)

    # stage 1: greedy search (rank 0) + artifact extraction (model dtype)
    greedy, sr, _ = CC.discover(api, params, sample_fn, iter(()), qcfg,
                                ccfg, torch.Generator().manual_seed(
                                    args.seed + 2), skip_tune=True,
                                mesh=mesh, verbose=lead)
    print(f"[tune] greedy prefix {sr.prefix_ids.tolist()} "
          f"({sr.wall_time_s:.1f}s, {len(sr.history)} iterations)")
    if lead:
        g_top1, g_ppl = _quality(api, params, greedy, eval_batches)

    # stage 2: gradient prefix tuning of the cushion KV block
    before = dict(_lib.LAUNCHES)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tr = CC.prefix_tune(api, params, greedy, tune_iter, qcfg, ccfg,
                        mesh=mesh, verbose=lead)
    tuned = tr.cushion
    fp = CC.cushion_fingerprint(tuned)
    rank_rec = {"path": None, "fingerprint": fp, "tune_s": tr.wall_time_s,
                # how far the tuning moved each cushion leaf (mean |.|)
                "cushion_move": {k: float((tuned["kv"][k].float()
                                           - greedy["kv"][k].float())
                                          .abs().mean())
                                 for k in tuned.get("kv", {})},
                "tune_launches": {k: v - before.get(k, 0)
                                  for k, v in _lib.LAUNCHES.items()},
                "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else None)}
    if not lead:
        return rank_rec
    t_top1, t_ppl = _quality(api, params, tuned, eval_batches)
    print(f"[tune] {args.steps} steps in {tr.wall_time_s:.1f}s; "
          f"max-activation top1 {g_top1:.1f} -> {t_top1:.1f}, "
          f"held-out ppl {g_ppl:.2f} -> {t_ppl:.2f}")

    tree = {"cushion": tuned}
    extra = {"kind": "cushion", "arch": cfg.name,
             "family": str(cfg.family), "dtype": cfg.dtype,
             "fingerprint": fp,
             "prefix_ids": [int(t) for t in sr.prefix_ids],
             "quant_mode": args.quant, "tune_steps": args.steps,
             "lam": args.lam, "lr": args.lr, "smoke": bool(args.smoke),
             "dp": args.dp, "device": str(dev),
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
    rank_rec["path"] = path
    return rank_rec


if __name__ == "__main__":
    main()
