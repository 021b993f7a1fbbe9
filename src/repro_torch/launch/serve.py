"""Serving launcher: a quantization mode with an optional CushionCache
prefix, on the card unless ``--device cpu``.

    python -m repro_torch.launch.serve --arch smollm-360m --quant pt_static \
        --prequant --kv-dtype int8 --cushion-len 4

``--weight-bits 4`` (with ``--prequant``) serves int4-packed weights (W4A8);
``--quant ptoken_dynamic`` the per-token dynamic baseline (fp weights,
fake-quantized per call, as in the reference).

The default (static) mode runs one Engine batch. ``--mode continuous``
replays a Poisson-arrival trace (``--rate`` req/s, 0 = all queued at once;
``--n-requests``; ``--trace-seed``) through ``ContinuousEngine`` with
``--slots`` cache slots; ``--paged --page-size --pages`` swap the dense
per-slot rows for the paged pool, ``--prefix-cache`` shares repeated prompt
stems' pages (fp pools), ``--chunk-tokens N|auto`` admits long prompts in
chunks between decode steps. It prints per-request TTFT/TPOT, the final
``ServeStats``, the page-pool gauges, tokens/s and p50/p99 latency:

    python -m repro_torch.launch.serve --device cpu --mode continuous \
        --paged --page-size 32 --prefix-cache --chunk-tokens 16

``--replicas N`` (continuous mode) sends the trace through the
fault-tolerant replica router (``serving/router.py``) over N engines that
share one copy of the weights; ``--chaos`` arms deterministic fault
injection (``kind@site:step[:stall_s]``, comma-separated), ``--max-queue``
bounds the admission queue. On one card every replica shares one fault
domain: a real device fault fails them all.

    python -m repro_torch.launch.serve --mode continuous --replicas 3 \
        --chaos crash@replica1.step:6

``--tp N`` serves a model of any family tensor-parallel over N ranks
(``launch/mesh.spawn_tp``: one process a rank, on ``cuda:{r % cards}``,
NCCL where every rank has a card of its own, else gloo, which it
prints), through either engine and pool; rank 0 prints the
``[serve]`` lines. Every rank makes the same weights (and a VLM's
requests the same patches) from ``--seed``, builds and quantizes the whole
model, and keeps its shard, so the whole model must fit on one card today
(ROADMAP queue 1, item 6.9); an axis that does not divide by N is whole on
every rank. W4A8 (``--weight-bits 4``), ``pt_dynamic`` and
``ptoken_dynamic`` serve under ``--tp`` too (their ranges taken over the
ranks where the features are cut). What one rank refuses stops before
the ranks spawn, with the reason: the encoder-decoder's ``pt_static``
and a paged pool of the encoder-decoder or the xLSTM:

    python -m repro_torch.launch.serve --device cpu --tp 2 --quant \
        pt_static --prequant --kv-dtype int8 --cushion-len 4
    python -m repro_torch.launch.serve --device cpu --tp 2 --quant \
        ptoken_dynamic --cushion-len 4
    python -m repro_torch.launch.serve --device cpu --smoke --tp 2 \
        --arch jamba-v0.1-52b --quant pt_static --prequant --kv-dtype int8 \
        --cushion-len 4
    python -m repro_torch.launch.serve --device cpu --smoke --tp 2 \
        --arch xlstm-350m --quant pt_static --prequant --cushion-len 4
    python -m repro_torch.launch.serve --device cpu --smoke --tp 2 \
        --arch whisper-base --mode continuous --quant pt_dynamic \
        --cushion-len 4 --rate 0

``--replicas R --tp N`` (continuous mode) runs the router over R replicas
of N ranks each: ``spawn_mesh(..., data=R, tp=N)``, replica i on data row
i (``launch/mesh.make_replica_meshes``), every rank running the same
router loop, world rank 0 deciding and printing. On one card these are
gloo ranks taking turns on the device: the mechanism, not the speed of
tensor parallelism.

    python -m repro_torch.launch.serve --device cpu --mode continuous \
        --replicas 2 --tp 2 --chaos crash@replica1.step:4

Weights are random, made from ``--seed``, unless ``--ckpt-dir`` serves the
``params`` of the latest checkpoint there (written by either package's
``launch/train.py``; its sha256 is verified on restore). ``--smoke`` serves
the arch's reduced f32 config, named ``<arch>-smoke`` as in the reference.
The cushion is ``extract_cushion`` of ``--cushion-len`` token ids drawn
from the seed, or with ``--cushion DIR`` the latest tuned artifact of a
``launch/tune.py --out-dir`` (of either package: the format is shared): its
fingerprint is recomputed over the restored bytes, and its stored
pt_static scales serve as they are, tagged with the cushion they were
calibrated under. Otherwise pt_static calibrates its site scales at engine
load over ``--calib-batches`` pipeline batches (default 2), under the
cushion. Prompts and calibration batches are the same token ids as the JAX
launcher's (``data/pipeline.py`` is a copy).

The whole user path, on the CPU (drop ``--device cpu`` for the card):

    python -m repro_torch.launch.train --device cpu --smoke --steps 5 \
        --ckpt-dir /tmp/ck
    python -m repro_torch.launch.tune --device cpu --smoke --dp 2 \
        --ckpt-dir /tmp/ck --out-dir /tmp/art --with-scales
    python -m repro_torch.launch.serve --device cpu --smoke --ckpt-dir \
        /tmp/ck --cushion /tmp/art --quant pt_static --prequant
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.configs import Family, QuantConfig, get_config, reduced
from repro_torch.data.pipeline import Pipeline, SyntheticCorpus
from repro_torch.distributed.fault_injection import FaultInjector
from repro_torch.launch.mesh import (make_replica_meshes, spawn_mesh,
                                     spawn_tp)
from repro_torch.models import encdec as ED
from repro_torch.models.common import ParamTree
from repro_torch.models.registry import build
from repro_torch.serving.engine import Engine, check_tp_serving
from repro_torch.serving.router import ReplicaRouter, RouterConfig
from repro_torch.serving.scheduler import ContinuousEngine, Request


def seeded_cushion(api, params, m: int, seed: int):
    """The cushion of ``m`` seeded token ids, extracted in fp."""
    ids = np.random.RandomState(seed).randint(0, api.cfg.vocab_size, m)
    return api.extract_cushion(params, torch.as_tensor(ids, dtype=torch.int32),
                               None, QuantConfig())


def load_cushion_artifact(path: str, api):
    """The latest cushion artifact of a ``launch/tune.py`` ``--out-dir``
    (the reference's or the port's), on the API's device. Returns
    ``(cushion, CalibratedScales | None, extra)``.

    The fingerprint is recomputed over the restored bytes and held to the
    manifest's: a corrupt or edited artifact stops here. An artifact tuned
    for another arch stops too. Stored scales come back as
    ``CalibratedScales`` carrying the fingerprint of the cushion they were
    calibrated under, which ``plan_quantization`` holds against the
    cushion served."""
    from repro_torch.core.calibration import (CalibratedScales,
                                              scales_from_plain)
    from repro_torch.core.cushioncache import cushion_fingerprint

    store = CheckpointManager(path)
    version = store.latest_step()
    if version is None:
        raise SystemExit(f"[serve] no cushion artifact under {path}")
    tree, manifest = store.restore_tree(version)
    extra = manifest.get("extra", {})
    if extra.get("kind") != "cushion":
        raise SystemExit(f"[serve] {path} v{version} is not a cushion "
                         f"artifact (kind={extra.get('kind')!r}); expected "
                         f"a launch/tune.py --out-dir")
    if extra.get("arch") and extra["arch"] != api.cfg.name:
        raise SystemExit(f"[serve] cushion artifact was tuned for arch "
                         f"{extra['arch']!r} but serving {api.cfg.name!r}")
    dev = api.device

    def on_dev(t):
        if isinstance(t, dict):
            return {k: on_dev(v) for k, v in t.items()}
        return t.to(dev)
    cushion = on_dev(tree["cushion"])
    got = cushion_fingerprint(cushion)
    want = extra.get("fingerprint")
    if want and got != want:
        raise SystemExit(f"[serve] cushion artifact fingerprint mismatch: "
                         f"manifest says {want[:12]} but restored bytes "
                         f"hash to {got[:12]}: artifact corrupt")
    scales = None
    if "scales" in tree:
        scales = CalibratedScales(scales_from_plain(on_dev(tree["scales"])),
                                  extra.get("scales_cushion_fp", got))
    print(f"[serve] cushion artifact v{version} from {path}: "
          f"prefix_ids={extra.get('prefix_ids')} fingerprint={got[:12]} "
          f"scales={'stored' if scales is not None else 'none'}")
    return cushion, scales, extra


def restore_params(ckpt_dir: str, params):
    """The ``params`` of the latest checkpoint in ``ckpt_dir`` (either
    package's ``launch/train.py``; its sha256 is verified on restore) in
    the structure, dtypes and device of ``params`` (a ``ParamTree``), or
    ``params`` itself where the directory holds none. A checkpoint of
    another parameter tree (another arch) stops here."""
    ckpt = CheckpointManager(ckpt_dir)
    step = ckpt.latest_step()
    if step is None:
        return params
    try:
        tree = ckpt.restore_subtree(step, "params", params.tree())
    except ValueError as e:
        raise SystemExit(f"[restore] {ckpt_dir} holds another parameter "
                         f"tree than the arch's: {e}")
    print(f"[restore] params of step {step} from {ckpt_dir}")
    return ParamTree(tree)


def to_device(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def poisson_trace(api, rng_seed: int, n_requests: int, rate: float,
                  prompt_lens, budgets) -> list:
    """Poisson-arrival request trace on the API's device: exponential
    inter-arrival gaps at ``rate`` req/s (0: every request arrives at
    once), prompts cycling through ``prompt_lens`` (total positions: a
    VLM's patches take ``num_patches`` of them) and budgets through
    ``budgets``. Everything derives from ``rng_seed``. The gaps and budgets
    are the JAX launcher's; the prompt ids come from a numpy
    ``RandomState(rng_seed + 7 i + 1)`` and a VLM's patches or an
    encoder-decoder's frames (each request its own) from a
    ``torch.Generator`` of the same seed, where the JAX launcher draws both
    with ``jax.random``, which the port cannot reproduce, so the two
    launchers serve different prompts."""
    rs = np.random.RandomState(rng_seed)
    t = 0.0
    reqs = []
    for i in range(n_requests):
        t += float(rs.exponential(1.0 / rate)) if rate > 0 else 0.0
        S = api.text_len(int(prompt_lens[i % len(prompt_lens)]))
        seed = rng_seed + 7 * i + 1
        ids = np.random.RandomState(seed).randint(0, api.cfg.vocab_size,
                                                  (1, S))
        batch = {"tokens": torch.as_tensor(ids, dtype=torch.int32,
                                           device=api.device),
                 **api.extra_inputs(torch.Generator().manual_seed(seed), 1)}
        reqs.append(Request(
            uid=i, batch=batch,
            max_new_tokens=int(budgets[i % len(budgets)]), arrival_s=t))
    return reqs


def install_sigterm_drain() -> None:
    """Map SIGTERM onto KeyboardInterrupt, so a shutdown takes the same
    graceful drain as ctrl-C. No-op off the main thread."""
    import signal

    def _handler(signum, frame):
        raise KeyboardInterrupt("SIGTERM")

    try:
        signal.signal(signal.SIGTERM, _handler)
    except ValueError:      # not the main thread
        pass


def _chunk_tokens_arg(v: str):
    """--chunk-tokens value: an int budget or 'auto' (adaptive)."""
    return v if v == "auto" else int(v)


def run_continuous(api, params, qcfg, args, calib_batches=None,
                   cushion=None, scales=None, mesh=None):
    install_sigterm_drain()
    dev = api.device
    reqs = poisson_trace(api, args.trace_seed, args.n_requests, args.rate,
                         prompt_lens=(args.prompt_len, args.prompt_len + 8),
                         budgets=(args.tokens, max(1, args.tokens // 2)))
    eng = ContinuousEngine(api, params, qcfg, n_slots=args.slots,
                           max_seq=args.prompt_len + 8 + args.tokens + 32,
                           cushion=cushion, scales=scales,
                           kv_dtype=None if args.kv_dtype == "fp"
                           else args.kv_dtype,
                           calib_batches=calib_batches,
                           prequant=args.prequant,
                           weight_bits=args.weight_bits, paged=args.paged,
                           page_size=args.page_size, n_pages=args.pages,
                           prefix_cache=args.prefix_cache,
                           chunk_tokens=args.chunk_tokens, mesh=mesh)
    if eng.chunk_auto:
        print(f"[serve] chunked prefill: adaptive budget (max "
              f"{eng.chunk_tokens} tokens/chunk)")
    elif eng.chunk_tokens:
        print(f"[serve] chunked prefill: {eng.chunk_tokens} tokens/chunk "
              f"(bucketed from --chunk-tokens {args.chunk_tokens})")
    print(f"[serve] device={dev} "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}"
          f" resident weights: "
          f"fp={eng.stats.weight_bytes_fp / 2 ** 20:.1f} MiB "
          f"int8={eng.stats.weight_bytes_int8 / 2 ** 20:.1f} MiB "
          f"int4={eng.stats.weight_bytes_int4 / 2 ** 20:.1f} MiB")
    if args.paged:
        st = eng.stats
        print(f"[serve] paged pool: {st.pages_total} pages x "
              f"{args.page_size} positions, "
              f"{st.pool_bytes / 2 ** 20:.2f} MiB resident "
              f"(cushion refs {st.cushion_page_refs})")
    if args.bench_json:
        eng.run(reqs)           # warm-up: allocator, kernel build
    outs = eng.run(reqs)
    for o in outs:
        print(f"[serve]   req {o.uid}: slot {o.slot} n={len(o.tokens)} "
              f"TTFT={o.ttft_ms:.1f}ms TPOT={o.tpot_ms:.2f}ms "
              f"latency={o.latency_s * 1e3:.0f}ms")
    if eng.stats.interrupted:
        print(f"[serve] DRAINED: interrupted after {len(outs)} of "
              f"{len(reqs)} requests; live slots completed, queued "
              f"remainder dropped")
    print(f"[serve] final stats: {eng.stats.as_dict()}")
    if args.paged:
        st = eng.stats
        print(f"[serve] page pool: total={st.pages_total} "
              f"free={st.pages_free} shared={st.pages_shared} "
              f"cushion_refs={st.cushion_page_refs} "
              f"prefix_hits={st.prefix_hits} "
              f"prefix_misses={st.prefix_misses} "
              f"positions_exhausted={st.positions_exhausted} "
              f"pool_bytes={st.pool_bytes}")
    if not outs:
        return outs
    total = sum(len(o.tokens) for o in outs)
    span = max(o.finished_s for o in outs) - min(r.arrival_s for r in reqs)
    lat = np.asarray([o.latency_s for o in outs])
    tps = total / max(span, 1e-9)
    occ = eng.stats.occupancy()
    print(f"[serve] continuous: {len(outs)} reqs, {total} tokens, "
          f"{tps:.1f} tok/s, p50={np.percentile(lat, 50) * 1e3:.0f}ms "
          f"p99={np.percentile(lat, 99) * 1e3:.0f}ms occupancy={occ:.2f}")
    if args.bench_json:
        _append_point(args.bench_json, {
            "mode": "continuous", "arch": args.arch, "quant": args.quant,
            "prequant": args.prequant, "weight_bits": args.weight_bits,
            "tp": args.tp,
            "paged": args.paged,
            "page_size": args.page_size, "prefix_cache": args.prefix_cache,
            "chunk_tokens": args.chunk_tokens, "kv_dtype": args.kv_dtype,
            "slots": args.slots, "rate": args.rate,
            "n_requests": args.n_requests,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "tokens_per_s": tps,
            "p50_latency_s": float(np.percentile(lat, 50)),
            "p99_latency_s": float(np.percentile(lat, 99)),
            "occupancy": occ, **eng.stats.as_dict()})
    return outs


def run_router(api, params, qcfg, args, calib_batches=None, cushion=None,
               scales=None):
    """--replicas N: the trace goes through the fault-tolerant replica
    router instead of a single engine. --chaos arms deterministic fault
    injection; rejections, retries, failovers and per-replica health land
    in the printed RouterStats. With --tp T (inside the spawn) each replica
    is a data row of T ranks."""
    install_sigterm_drain()
    dev = api.device
    meshes = None
    if args.tp > 1:
        meshes = make_replica_meshes(args.replicas, args.tp, args.device)
        print(f"[serve] {args.replicas} replicas x tp={args.tp} on disjoint "
              f"rank groups")
    injector = None
    if args.chaos:
        injector = FaultInjector.parse(args.chaos, seed=args.chaos_seed)
        print(f"[serve] chaos armed: {args.chaos} (seed {args.chaos_seed})")
    reqs = poisson_trace(api, args.trace_seed, args.n_requests, args.rate,
                         prompt_lens=(args.prompt_len, args.prompt_len + 8),
                         budgets=(args.tokens, max(1, args.tokens // 2)))
    router = ReplicaRouter(
        api, params, qcfg, n_replicas=args.replicas,
        cfg=RouterConfig(max_queue=args.max_queue), meshes=meshes,
        n_slots=args.slots, max_seq=args.prompt_len + 8 + args.tokens + 32,
        cushion=cushion, scales=scales,
        kv_dtype=None if args.kv_dtype == "fp" else args.kv_dtype,
        calib_batches=calib_batches, prequant=args.prequant,
        weight_bits=args.weight_bits,
        paged=args.paged, page_size=args.page_size, n_pages=args.pages,
        prefix_cache=args.prefix_cache, chunk_tokens=args.chunk_tokens)
    st0 = router.replicas[0].engine.stats
    print(f"[serve] device={dev} "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}"
          f" {args.replicas} replicas x {args.slots} slots, one copy of the "
          f"resident weights: fp={st0.weight_bytes_fp / 2 ** 20:.1f} MiB "
          f"int8={st0.weight_bytes_int8 / 2 ** 20:.1f} MiB "
          f"int4={st0.weight_bytes_int4 / 2 ** 20:.1f} MiB")
    if args.bench_json:
        router.run(reqs)        # warm-up, without faults: allocator, build
    res = router.run(reqs, injector=injector)
    for o in res.outputs:
        retry = f" attempts={o.attempts}" if o.attempts > 1 else ""
        print(f"[serve]   req {o.uid}: replica {o.replica} slot {o.slot} "
              f"n={len(o.tokens)} TTFT={o.ttft_ms:.1f}ms "
              f"TPOT={o.tpot_ms:.2f}ms "
              f"latency={o.latency_s * 1e3:.0f}ms{retry}")
    for r in res.rejected:
        print(f"[serve]   req {r.uid}: REJECTED ({r.reason})")
    st = res.stats
    print(f"[serve] router: {st.completed}/{st.submitted} completed, "
          f"{st.rejected} rejected, {st.retries} retries, "
          f"{st.failovers} failovers, {st.replica_deaths} deaths, "
          f"queue peak {st.queue_depth_peak}, states "
          f"{[p['state'] for p in st.per_replica]}")
    if st.drained:
        print("[serve] DRAINED: graceful shutdown completed the live slots")
    if res.outputs:
        lat = np.asarray([o.latency_s for o in res.outputs])
        print(f"[serve] p50={np.percentile(lat, 50) * 1e3:.0f}ms "
              f"p99={np.percentile(lat, 99) * 1e3:.0f}ms")
    print(f"[serve] final stats: {st.as_dict()}")
    if args.bench_json:
        _append_point(args.bench_json, {
            "mode": "router", "arch": args.arch, "quant": args.quant,
            "replicas": args.replicas, "chaos": args.chaos or "",
            "slots": args.slots, "rate": args.rate,
            "n_requests": args.n_requests,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            **st.as_dict()})
    return res


def _append_point(path: str, point: dict) -> None:
    hist = []
    if os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
        hist = prev if isinstance(prev, list) else [prev]
    hist.append(point)
    with open(path, "w") as f:
        json.dump(hist, f, indent=1)
    print(f"[serve] bench point -> {path}")


def main(argv=None, corpus: SyntheticCorpus = None):
    """Serve as ``argv`` says; returns the static path's ``GenerateResult``
    or the continuous path's outputs. ``corpus``: an already built
    ``SyntheticCorpus`` of the arch's vocabulary and ``--seed`` (the
    prompts' and the calibration's; at a 49,152-id vocabulary it takes a
    minute and more to build)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_tiny")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced f32 config (<arch>-smoke)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="serve the first N layers of --arch at its full "
                         "width (a multiple of a hybrid's period), where "
                         "all of them would not fit on the card")
    ap.add_argument("--quant", default="none",
                    choices=["none", "pt_static", "pt_dynamic",
                             "ptoken_dynamic"])
    ap.add_argument("--prequant", action="store_true",
                    help="int8-resident weights (requires --quant pt_static)")
    ap.add_argument("--weight-bits", type=int, default=8, choices=[8, 4],
                    help="resident weight precision with --prequant: 8 = "
                         "int8 w_int (W8A8), 4 = nibble-packed w_packed "
                         "(W4A8, 0.5 byte/weight); activations stay int8")
    ap.add_argument("--kv-dtype", default="fp", choices=["fp", "int8"])
    ap.add_argument("--mode", default="static",
                    choices=["static", "continuous"],
                    help="static: one Engine batch; continuous: a Poisson "
                         "trace through the slot-pool scheduler")
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous: cache-slot pool size")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="continuous: Poisson arrival rate (req/s; 0 = "
                         "all at once)")
    ap.add_argument("--n-requests", type=int, default=8,
                    help="continuous: trace length")
    ap.add_argument("--trace-seed", type=int, default=None,
                    help="seed of the trace (arrivals, prompts, budgets); "
                         "defaults to --seed")
    ap.add_argument("--replicas", type=int, default=1,
                    help="continuous: serve through the replica router over "
                         "N engine replicas (health checks, retries, "
                         "backpressure, drain) that share the weights")
    ap.add_argument("--chaos", default=None,
                    help="router: comma-separated fault specs "
                         "kind@site:step[:stall_s], e.g. "
                         "crash@replica1.step:12 (kinds: crash, stall, "
                         "heartbeat, interrupt)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for randomized fault schedules")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="router: bounded admission queue size (overflow "
                         "-> explicit queue_full rejection)")
    ap.add_argument("--paged", action="store_true",
                    help="continuous: paged KV pool (serving/paging.py)")
    ap.add_argument("--page-size", type=int, default=64,
                    help="paged: positions per page (multiple of 8, "
                         "divides max_seq)")
    ap.add_argument("--pages", type=int, default=None,
                    help="paged: physical page count (default: the worst "
                         "case, so admission never waits on pages)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged fp pools: share repeated prompt stems' "
                         "pages read-only, prefill only the tail")
    ap.add_argument("--chunk-tokens", type=_chunk_tokens_arg, default=None,
                    help="continuous: per-step prefill token budget "
                         "(bucketed to a power of two) or 'auto'; longer "
                         "prompts prefill one chunk per decode step")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--cushion-len", type=int, default=0,
                    help="cushion prefix length m (0: no cushion)")
    ap.add_argument("--cushion", default=None,
                    help="serve the latest tuned-cushion artifact from "
                         "this launch/tune.py --out-dir (with its stored "
                         "pt_static scales, if any)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the latest checkpoint there "
                         "(either package's launch/train.py)")
    ap.add_argument("--calib-batches", type=int, default=2,
                    help="pt_static: calibration batches drawn from the "
                         "synthetic pipeline at engine load")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallel over N ranks (every family; "
                         "one process a rank, NCCL where every rank has a "
                         "card, else gloo)")
    ap.add_argument("--bench-json", default=None,
                    help="append a trajectory point to this file")
    args = ap.parse_args(argv)
    if args.prequant and args.quant != "pt_static":
        ap.error("--prequant requires --quant pt_static")
    if args.weight_bits == 4 and not args.prequant:
        ap.error("--weight-bits 4 requires --prequant (the int4-packed "
                 "format only exists as resident serving weights)")
    if args.mode != "continuous" and (args.paged or args.chunk_tokens
                                      is not None):
        ap.error("--paged / --chunk-tokens require --mode continuous")
    if (args.replicas > 1 or args.chaos) and args.mode != "continuous":
        ap.error("--replicas/--chaos require --mode continuous (the "
                 "router fronts ContinuousEngine replicas)")
    if args.prefix_cache and (not args.paged or args.kv_dtype != "fp"):
        ap.error("--prefix-cache requires --paged and --kv-dtype fp")
    if args.trace_seed is None:
        args.trace_seed = args.seed
    if args.cushion and args.cushion_len:
        ap.error("--cushion and --cushion-len are exclusive")
    if args.tp < 1:
        ap.error("--tp must be >= 1")
    if args.tp > 1:
        try:
            check_tp_serving(_config(args),
                             QuantConfig(mode=args.quant), args.tp,
                             args.weight_bits, paged=args.paged)
        except ValueError as e:
            raise SystemExit(f"[serve] {e}")
        if args.mode == "continuous" and (args.replicas > 1 or args.chaos):
            return spawn_mesh(serve_rank, args.replicas, args.tp, args,
                              corpus, device=args.device)
        return spawn_tp(serve_rank, args.tp, args, corpus,
                        device=args.device)
    return serve(args, corpus=corpus)


def _config(args):
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg, dtype="float32")
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    return cfg


def serve_rank(mesh, args, corpus=None):
    """One rank of ``--tp N`` (a ``spawn_tp`` / ``spawn_mesh`` target):
    ``serve`` on the rank's device and mesh; only world rank 0 prints.
    Under ``--replicas`` the router makes the replicas' meshes."""
    if mesh.rank != 0 or mesh.data_rank != 0:
        sys.stdout = open(os.devnull, "w")
    print(f"[serve] tp={mesh.size} backend={mesh.backend} rank 0 on "
          f"{mesh.device}")
    return serve(args, None if mesh.data_size > 1 else mesh, corpus,
                 device=mesh.device)


def serve(args, mesh=None, corpus=None, device=None):
    """Serve as ``args`` say, on ``mesh``'s device and shard when given
    (else on ``device``, default ``args.device``)."""
    cfg = _config(args)
    api = build(cfg, mesh.device if mesh is not None
                else device or args.device)
    dev = api.device
    params = api.init_params(torch.Generator(dev).manual_seed(args.seed))
    if args.ckpt_dir:
        params = restore_params(args.ckpt_dir, params)
    qcfg = QuantConfig(mode=args.quant, true_int8=args.quant == "pt_static")
    cushion, art_scales = None, None
    if args.cushion:
        cushion, art_scales, _ = load_cushion_artifact(args.cushion, api)
        if args.quant != "pt_static":
            art_scales = None       # stored scales only apply to pt_static
    elif args.cushion_len:
        cushion = seeded_cushion(api, params, args.cushion_len, args.seed)

    extras = sorted(api.extra_inputs(torch.Generator(), 1))
    if extras and args.mode != "continuous":
        raise SystemExit(
            f"[serve] {args.arch}: the static path feeds the pipeline's "
            f"tokens only and {cfg.family.value} requests carry other "
            f"inputs ({', '.join(extras)}), as in the reference; serve it "
            f"with --mode continuous")
    if cfg.family == Family.ENCDEC:
        try:
            ED.check_serving_quant(qcfg)
        except ValueError as e:
            raise SystemExit(f"[serve] {args.arch}: {e}")
    if corpus is None:
        corpus = SyntheticCorpus(cfg.vocab_size, seed=args.seed)
    pipe = Pipeline(corpus, batch=args.batch, seq_len=args.prompt_len,
                    seed=args.seed + 1)
    calib = None
    if args.quant == "pt_static" and art_scales is None:
        if extras:
            # the pipeline draws tokens only: calibrate on drawn batches
            calib = [api.make_batch(torch.Generator().manual_seed(
                args.seed + 1000 + i), args.batch, args.prompt_len)
                for i in range(args.calib_batches)]
        else:
            calib = [to_device(pipe.get_batch(1000 + i), dev)
                     for i in range(args.calib_batches)]
    if args.mode == "continuous":
        if args.replicas > 1 or args.chaos:
            return run_router(api, params, qcfg, args, calib_batches=calib,
                              cushion=cushion, scales=art_scales)
        return run_continuous(api, params, qcfg, args, calib_batches=calib,
                              cushion=cushion, scales=art_scales, mesh=mesh)
    batch = to_device(pipe.get_batch(0), dev)
    eng = Engine(api, params, qcfg, max_seq=args.prompt_len + args.tokens + 32,
                 cushion=cushion, scales=art_scales,
                 kv_dtype=None if args.kv_dtype == "fp" else args.kv_dtype,
                 calib_batches=calib, prequant=args.prequant,
                 weight_bits=args.weight_bits, mesh=mesh)
    del params
    print(f"[serve] device={dev} "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}"
          f" resident weights: fp={eng.weight_bytes_fp / 2 ** 20:.1f} MiB "
          f"int8={eng.weight_bytes_int8 / 2 ** 20:.1f} MiB "
          f"int4={eng.weight_bytes_int4 / 2 ** 20:.1f} MiB")
    if args.bench_json:
        eng.generate(batch, args.tokens)     # warm-up: allocator, build
    res = eng.generate(batch, args.tokens)
    print(f"[serve] B={args.batch} prompt={args.prompt_len} "
          f"gen={args.tokens} kv={args.kv_dtype} m={eng.prefix_len} "
          f"tp={args.tp} "
          f"TTFT={res.ttft_ms:.1f}ms TPOT={res.tpot_ms:.2f}ms")
    print("[serve] sample:", res.tokens[0][:16].tolist())
    if args.bench_json:
        _append_point(args.bench_json, {
            "mode": "static", "arch": args.arch, "quant": args.quant,
            "prequant": args.prequant, "weight_bits": args.weight_bits,
            "tp": args.tp,
            "kv_dtype": args.kv_dtype,
            "cushion_len": args.cushion_len, "batch": args.batch,
            "prompt_len": args.prompt_len, "tokens": args.tokens,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "weight_bytes_fp": eng.weight_bytes_fp,
            "weight_bytes_int8": eng.weight_bytes_int8,
            "weight_bytes_int4": eng.weight_bytes_int4,
            "ttft_ms": res.ttft_ms, "tpot_ms": res.tpot_ms})
    return res


if __name__ == "__main__":
    main()
