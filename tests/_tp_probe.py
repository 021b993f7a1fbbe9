"""What one rank of a tensor-parallel serving run does, and what it saw:
the ``launch/mesh.spawn_tp`` target of the tensor-parallel parity tests
(``test_torch_sharding.py``, ``test_torch_cuda.py``) and of
``chip_smoke.py``'s phase 4k. It imports neither jax nor the JAX package:
a spawned rank imports this module (by the caller's ``sys.path``, which
the ranks inherit) to find its target.

``run_cases(mesh, cases)`` runs each case (a dict) on the calling rank and
returns one report a case. A case names:

* the model: ``cfg`` (the whole model's ``ModelConfig``) and either
  ``params`` (a tree of numpy arrays or CPU tensors, the same on every
  rank) or ``seed`` (every rank makes the tree from the seed on its device;
  trees made from one (cfg, seed) are kept for the next case);
* the serving setup: ``qcfg``, ``prequant``, ``kv_dtype``, ``max_seq``,
  ``cushion`` (a tree) or ``cushion_ids`` (extracted on the rank),
  ``scales`` (the plain ``{"scale", "zero"}`` tree) or ``calib`` (token
  arrays to calibrate on);
* ``kind`` "static": ``tokens`` (B, S) (and a VLM's ``patches`` (B, P,
  D) or an encoder-decoder's ``frames`` (B, T_enc, D), the same on every
  rank) and ``n_tokens`` through ``Engine.generate`` (``logits``: also
  the served request's prefill's last logits, the cushion block as its
  cache holds it and, of a hybrid or an xLSTM, the cushion state the
  rank's prefill starts from, its leaves by dotted path;
  ``record_quant``: also every activation quantization of that request,
  its prefill's and its decode steps', in call order, as its scale, zero
  point and codes, ``quant_records``);
  ``warmup``: one ``generate`` first, outside the report (on the card a
  single rank captures its decode graph there, with two eager warm-up
  steps); ``margins``: the top-1 minus top-2 logit of every row at every
  generated token, teacher-forced (B, n_tokens); "continuous":
  ``requests`` (dicts of ``tokens`` (1, S), ``patches`` or ``frames``,
  ``max_new_tokens``, ``arrival_s``) through ``ContinuousEngine.run`` with
  ``n_slots``, ``paged``, ``page_size``; ``clock_rates`` gives each rank a
  clock of its own (a tick of ``rate`` ms a read, the engine's ``clock``),
  to show that the ranks still agree; ``interrupt`` (rank, decode steps)
  sends that rank a SIGINT once it has run that many decode steps;
* ``kind`` "router" (run by ``run_router_cases`` in a ``spawn_mesh`` of
  ``n_replicas`` data rows): ``requests`` as "continuous" through a
  ``ReplicaRouter`` over ``launch/mesh.make_replica_meshes`` (a replica a
  data row), with ``n_slots``, ``paged``, ``page_size``, ``router_cfg``
  (``RouterConfig`` fields), ``chaos`` (a ``--chaos`` spec for rank 0's
  injector) and ``clock_rates`` (the router's and the engines' clocks, one
  a rank); ``warmup``: one run first, without faults, outside the report.
  The report: every output as (uid, replica, slot, tokens), the
  rejections, ``RouterStats`` and the launches;
* ``kind`` "train" and "tune": ``shard_train_step`` and
  ``prefix_tune(mesh=)`` on the mesh's ``("data", "model")`` form, as
  ``tests/_dp_probe.py`` runs them (tensor-parallel training), and its
  "range_tie" (``axis`` "tp": the extrema of a cut activation);
  "train_collectives": the all-reduces of ``launch/dryrun.train_program``'s
  rank program of one train step, as "collectives" counts them;
* ``kind`` "collectives": ``launch/dryrun.serving_program``'s rank program
  of a ``prefill`` and of one ``decode_step`` (global batch ``batch``,
  ``seq`` positions, ``qcfg``, ``prequant``, the whole tree ``params``) run
  on this rank; the report counts every ``torch.distributed.all_reduce``
  of each call and its bytes, the collectives the dry-run counts on its
  meta mesh (``tests/test_torch_sharding.py``);
* ``mesh``: False serves without a mesh (the unsharded engine);
* ``reset_peak``: False keeps the device's peak-memory count running
  (default: reset before serving);
* ``in_turn``: the ranks build one after another (each makes the whole
  tree, plans and cuts it, frees it and empties the card's cache before
  the next rank starts), so that one card holds one whole tree at a time;
  the trees' checksums are exchanged afterwards.

The report holds numpy arrays and numbers: the tokens, the cushion block as
this rank holds it, the launch counts of the kernels during the serving
call (``_lib.LAUNCHES``; none on the CPU), TTFT / TPOT, the backend, the
peak device memory and what the card held when the count was reset (the
weights, and the tree a rank keeps for the next case: ``held_bytes``)
and, for "continuous", every admission as (uid, slot, decode steps so
far) and each slot's cushion rows.
"""
from __future__ import annotations

import gc
import os
import signal
import time
from typing import Any, Dict, List

import contextlib

import numpy as np
import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core import quantization as Q
from repro_torch.kernels.act_quant import act_quant_static_plain
from repro_torch.distributed import collectives as DC
from repro_torch.kernels import _lib
from repro_torch.models import common as C
from repro_torch.models import convert
from repro_torch.models.registry import build, family_module
from repro_torch.distributed.fault_injection import FaultInjector
from repro_torch.launch.mesh import make_mesh, make_replica_meshes
from repro_torch.serving.engine import Engine, check_tree_sums
from repro_torch.serving.router import ReplicaRouter, RouterConfig
from repro_torch.serving.scheduler import ContinuousEngine, Request

# trees made from a seed on this rank, by (cfg, seed)
_TREES: Dict[Any, Any] = {}


class _Clock:
    """A scheduler clock: each read advances ``rate`` ms."""

    def __init__(self, rate: float):
        self.t = 0.0
        self.rate = rate

    def __call__(self) -> float:
        self.t += 1e-3 * self.rate
        return self.t


def _np(t: torch.Tensor) -> np.ndarray:
    """An f32 copy (never a view: pickling a CPU tensor for another
    process moves its storage into shared memory)."""
    return t.detach().float().cpu().numpy().copy()


def _params(api, case):
    if "params" in case:
        return convert.params_from_numpy(case["params"], api.device)
    key = (repr(api.cfg), case["seed"], str(api.device))
    tree = _TREES.get(key)
    if tree is None:
        _TREES.clear()
        tree = _TREES[key] = api.init_params(
            torch.Generator(api.device).manual_seed(case["seed"]))
    return tree


def _cushion(api, params, case):
    if case.get("cushion") is not None:
        return convert.cushion_from_numpy(case["cushion"], api.device)
    if case.get("cushion_ids") is not None:
        ids = torch.as_tensor(np.asarray(case["cushion_ids"]),
                              dtype=torch.int32)
        return api.extract_cushion(params, ids, None, QuantConfig())
    return None


def _tokens(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=torch.int32, device=device)


def _batch(d, device, dtype) -> Dict[str, torch.Tensor]:
    """A request's inputs on the rank: its tokens and, of a VLM, its
    patches, of an encoder-decoder its frames (numpy or a tensor) in the
    model dtype."""
    tok = d["tokens"]
    out = {"tokens": (tok.to(device, torch.int32)
                      if isinstance(tok, torch.Tensor)
                      else _tokens(tok, device))}
    for key in ("patches", "frames"):
        p = d.get(key)
        if p is not None:
            p = p if isinstance(p, torch.Tensor) else torch.from_numpy(
                np.array(p))
            out[key] = p.to(device, dtype)
    return out


def _state_view(cushion, cfg) -> Dict[str, np.ndarray]:
    """A recurrent cushion state as this rank reads it (the family's
    ``local_cushion``), its leaves flattened by path: a hybrid's Mamba
    ``h`` / ``conv``, an xLSTM's ``m.C``, ``s.h``, ..."""
    out: Dict[str, np.ndarray] = {}

    def visit(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, f"{path}.{k}" if path else k)
        else:
            out[path] = _np(node)
    visit(family_module(cfg).local_cushion(cushion, cfg)["state"], "")
    return out


def _cushion_view(cache: Dict[str, torch.Tensor], m: int) -> Dict:
    """The cushion block as this rank's cache holds it."""
    out = {k: _np(cache[k]) for k in ("kc", "vc", "kc_tp", "vc_tp")
           if k in cache}
    if "kc" not in cache and m:
        out["k_rows"] = _np(cache["k"][:, :, :m])
        out["v_rows"] = _np(cache["v"][:, :, :m])
    return out


@torch.inference_mode()
def _margins(eng, batch, tokens: np.ndarray) -> np.ndarray:
    """Top-1 minus top-2 logit along ``tokens``, teacher-forced through
    the engine's prefill and decode steps: (B, n)."""
    with DC.use_tp(eng.mesh):
        cache = eng._init_cache(tokens.shape[0])
        p = eng.params.tree()
        lg, cache, pos = eng.api.prefill(p, batch, cache, eng.qcfg,
                                         cushion=eng.cushion,
                                         scales=eng.scales)
        steps = [lg[:, -1]]
        for i in range(tokens.shape[1] - 1):
            tok = _tokens(tokens[:, i], pos.device)
            lg, cache = eng.api.decode_step(p, tok, pos + i, cache,
                                            eng.qcfg, scales=eng.scales)
            steps.append(lg)
    top2 = torch.stack(steps, 1).float().topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).cpu().numpy()


@torch.inference_mode()
def prefill_view(eng, batch) -> Dict[str, Any]:
    """An engine's prefill of ``batch`` as this rank sees it: the last
    position's logits, the cushion block as its cache holds it and, of a
    hybrid, the Mamba cushion state its prefill starts from."""
    with DC.use_tp(eng.mesh):
        cache = eng._init_cache(batch["tokens"].shape[0])
        lg, cache, _ = eng.api.prefill(eng.params.tree(), batch, cache,
                                       eng.qcfg, cushion=eng.cushion,
                                       scales=eng.scales)
        out = {"logits": _np(lg[:, -1]),
               "cushion": _cushion_view(cache, eng.prefix_len)}
        if eng.cushion is not None and "state" in eng.cushion:
            out["cushion_state"] = _state_view(eng.cushion, eng.api.cfg)
    return out


@contextlib.contextmanager
def recording_quant(records: List[Dict[str, np.ndarray]]):
    """Append every activation quantization made meanwhile (``quantize``
    with asymmetric codes, the per-token kernel, the int matmuls' static
    codes) to ``records`` as {"scale", "zero", "codes"}, in call order."""
    names = ("quantize", "act_quant_ptoken", "quant_w8a8_matmul",
             "quant_w4a8_matmul")
    saved = {k: getattr(Q, k) for k in names}

    def put(scale, zero, codes):
        records.append({"scale": _np(scale.reshape(-1)),
                        "zero": _np(zero.reshape(-1)), "codes": _np(codes)})

    def quantize(x, scale, zero, bits, symmetric):
        out = saved["quantize"](x, scale, zero, bits, symmetric)
        if not symmetric:               # an activation (weights: symmetric)
            put(scale, zero, out)
        return out

    def act_quant_ptoken(x, bits=8, rng=None):
        out = saved["act_quant_ptoken"](x, bits, rng=rng)
        put(out[1], out[2], out[0])
        return out

    def static(name):
        def run(x, w, s_x, z_x, *a, **kw):
            put(s_x, z_x, act_quant_static_plain(x, s_x, z_x))
            return saved[name](x, w, s_x, z_x, *a, **kw)
        return run
    wrap = dict(quantize=quantize, act_quant_ptoken=act_quant_ptoken,
                quant_w8a8_matmul=static("quant_w8a8_matmul"),
                quant_w4a8_matmul=static("quant_w4a8_matmul"))
    for k in names:
        setattr(Q, k, wrap[k])
    try:
        yield records
    finally:
        for k, f in saved.items():
            setattr(Q, k, f)


def served_view(eng, batch, logits) -> Dict[str, Any]:
    """``prefill_view`` of the request ``eng`` just served, from its own
    prefill's last ``logits`` and its decode state's cache (the cushion rows and
    blocks, which decoding never writes)."""
    cache = eng.states[batch["tokens"].shape[0]].cache
    out = {"logits": _np(logits),
           "cushion": _cushion_view(cache, eng.prefix_len)}
    if eng.cushion is not None and "state" in eng.cushion:
        with DC.use_tp(eng.mesh):
            out["cushion_state"] = _state_view(eng.cushion, eng.api.cfg)
    return out


def _in_turn(mesh, make):
    """``make()`` on each rank in turn (the ranks' other work waits at a
    barrier), the card's cache emptied after each; returns its result."""
    import torch.distributed as dist
    out = None
    _TREES.clear()
    gc.collect()
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    for turn in range(mesh.size):
        if turn == mesh.rank:
            out = make()
            _TREES.clear()
            gc.collect()
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
                torch.cuda.empty_cache()
        if mesh.size > 1:
            dist.barrier(group=mesh.group)
    return out


def run_collectives(mesh, case: Dict[str, Any]) -> Dict[str, Any]:
    """A "collectives" case: the all-reduces of the dry-run's rank program
    of a prefill and of a decode step, as this rank issues them."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import serving_program
    rep: Dict[str, Any] = {"rank": mesh.rank, "name": case.get("name")}
    params = convert.params_from_numpy(case["params"], mesh.device)
    for kind in ("prefill", "decode"):
        prog = serving_program(case["cfg"], kind, case["batch"], case["seq"],
                               mesh=mesh, qcfg=case["qcfg"],
                               prequant=case.get("prequant", False),
                               device=mesh.device, params=params)
        seen: List[int] = []
        real = dist.all_reduce

        def counted(t, *a, **kw):
            seen.append(t.numel() * t.element_size())
            return real(t, *a, **kw)
        dist.all_reduce = counted
        try:
            prog()
        finally:
            dist.all_reduce = real
        rep[kind] = {"all-reduce": len(seen), "bytes": sum(seen)}
    return rep


def run_train_collectives(mesh, case: Dict[str, Any]) -> Dict[str, Any]:
    """A "train_collectives" case: the all-reduces of the dry-run's rank
    program of one train step (``launch/dryrun.train_program`` on the
    mesh's ``("data", "model")`` form, from the whole tree ``params``), as
    this rank issues them."""
    from repro_torch.launch.dryrun import train_program
    from _dp_probe import counting_all_reduces
    mesh = make_mesh((mesh.data_size, mesh.size), ("data", "model"),
                     mesh.device)
    prog = train_program(case["cfg"], case["batch"], case["seq"], mesh=mesh,
                         device=mesh.device,
                         params=convert.params_from_numpy(case["params"],
                                                          mesh.device))
    with counting_all_reduces() as seen:
        prog()
    return {"rank": mesh.rank, "name": case.get("name"),
            "all-reduce": len(seen), "bytes": sum(seen)}


def run_case(mesh, case: Dict[str, Any]) -> Dict[str, Any]:
    if case["kind"] == "collectives":
        return run_collectives(mesh, case)
    if case["kind"] == "train_collectives":
        return run_train_collectives(mesh, case)
    if case["kind"] in ("train", "tune", "range_tie"):
        # tensor-parallel training and tuning: the data-parallel probe's
        # cases, which run on any (data, model) mesh
        from _dp_probe import run_case as training_case
        return training_case(mesh, case)
    dev = mesh.device
    if dev.type == "cuda":
        # the last case's engines (an engine and its decode states refer to
        # each other) go before this case builds
        gc.collect()
        torch.cuda.empty_cache()
    api = build(case["cfg"], dev)
    if case.get("in_turn") and case.get("mesh", True):
        def make():
            return _engine(mesh, api, case, defer_tree_check=True)
        eng = _in_turn(mesh, make)
        if mesh.size > 1:
            check_tree_sums(eng.tree_sum, mesh)
    else:
        eng = _engine(mesh, api, case)
    return _serve(mesh, api, eng, case)


def _engine(mesh, api, case, **extra):
    dev = mesh.device
    params = _params(api, case)
    cushion = _cushion(api, params, case)
    scales = case.get("scales")
    if scales is not None:
        scales = convert.scales_from_numpy(scales, dev)
    dt = C.dtype_of(api.cfg)
    calib = [_batch(t if isinstance(t, dict) else {"tokens": t}, dev, dt)
             for t in case.get("calib") or []]
    qcfg = case["qcfg"]
    kw = dict(cushion=cushion, scales=scales,
              max_seq=case.get("max_seq", 128), kv_dtype=case.get("kv_dtype"),
              calib_batches=calib or None,
              prequant=case.get("prequant", False),
              weight_bits=case.get("weight_bits", 8),
              mesh=mesh if case.get("mesh", True) else None, **extra)
    if case["kind"] == "static":
        return Engine(api, params, qcfg, **kw)
    rates = case.get("clock_rates")
    if rates:
        kw["clock"] = _Clock(rates[mesh.rank % len(rates)])
    return ContinuousEngine(api, params, qcfg,
                            n_slots=case.get("n_slots", 2),
                            paged=case.get("paged", False),
                            page_size=case.get("page_size", 32),
                            chunk_tokens=case.get("chunk_tokens"), **kw)


def _serve(mesh, api, eng, case: Dict[str, Any]) -> Dict[str, Any]:
    dev = mesh.device
    qcfg = case["qcfg"]
    rep: Dict[str, Any] = {"rank": mesh.rank, "backend": mesh.backend,
                           "name": case.get("name"), "held_bytes": 0}
    if dev.type == "cuda" and case.get("reset_peak", True):
        torch.cuda.reset_peak_memory_stats(dev)
        rep["held_bytes"] = int(torch.cuda.memory_allocated(dev))
    dt = C.dtype_of(api.cfg)
    if case["kind"] == "static":
        batch = _batch(case, dev, dt)
        if case.get("warmup"):
            eng.generate(batch, case["n_tokens"])
        seen: Dict[str, torch.Tensor] = {}
        if case.get("logits"):
            # the served request's own prefill: its logits, kept on the
            # device until the request is done (the method shadowed on
            # this engine's api only)
            prefill = eng.api.prefill

            def capture(*a, **kw):
                out = prefill(*a, **kw)
                lg = out[0]
                seen.setdefault("logits",
                                (lg[:, -1] if lg.dim() == 3 else lg).clone())
                return out
            eng.api.prefill = capture
        records: List[Dict[str, np.ndarray]] = []
        _lib.reset_launches()
        with (recording_quant(records) if case.get("record_quant")
              else contextlib.nullcontext()):
            res = eng.generate(batch, case["n_tokens"])
        rep["launches"] = dict(_lib.LAUNCHES)
        if case.get("logits"):
            del eng.api.prefill
            rep.update(served_view(eng, batch, seen["logits"]))
        if case.get("record_quant"):
            rep["quant_records"] = records
        rep.update(tokens=res.tokens, ttft_ms=res.ttft_ms,
                   tpot_ms=res.tpot_ms,
                   weight_bytes=(eng.weight_bytes_fp, eng.weight_bytes_int8))
        if case.get("margins"):
            rep["margins"] = _margins(eng, batch, res.tokens)
    else:
        reqs = [Request(uid=i, batch=_batch(r, dev, dt),
                        max_new_tokens=int(r["max_new_tokens"]),
                        arrival_s=float(r.get("arrival_s", 0.0)))
                for i, r in enumerate(case["requests"])]
        admissions: List = []
        book = eng._book_admission

        def logged(req, slot, first, tpf):
            admissions.append((req.uid, slot, eng.stats.steps))
            book(req, slot, first, tpf)
        eng._book_admission = logged
        at = case.get("interrupt")
        if at is not None and at[0] == mesh.rank:
            step = eng.step

            def step_then_interrupt():
                out = step()
                if eng.stats.steps == at[1]:
                    os.kill(os.getpid(), signal.SIGINT)
                return out
            eng.step = step_then_interrupt
        _lib.reset_launches()
        t0 = time.perf_counter()
        outs = eng.run(reqs)
        rep["seconds"] = time.perf_counter() - t0
        del eng._book_admission
        rep["launches"] = dict(_lib.LAUNCHES)
        m = eng.prefix_len
        rep.update(
            tokens={o.uid: o.tokens for o in outs},
            ttft_ms={o.uid: o.ttft_ms for o in outs},
            tpot_ms={o.uid: o.tpot_ms for o in outs},
            admissions=admissions, stats=eng.stats.as_dict(),
            cushion={k: _np(v) for k, v in eng.cushion_block.items()})
        c = eng.cache
        if "kc" in c:
            rep["cushion"].update(_cushion_view(c, m))
        elif not eng.paged and m:
            # every slot's rows [0:m), recycled slots included
            rep["slot_rows"] = _np(c["k"][:, :, :m])
        if "k_scale" in c:
            rep["k_scale_shape"] = tuple(c["k_scale"].shape)
    rep["peak_bytes"] = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        rep["peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    del eng
    if case.get("in_turn"):
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rep


def run_cases(mesh, cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Every case on this rank, in order (a ``spawn_tp`` target)."""
    return [run_case(mesh, c) for c in cases]


def _requests(case, dev, dt) -> List[Request]:
    return [Request(uid=i, batch=_batch(r, dev, dt),
                    max_new_tokens=int(r["max_new_tokens"]),
                    arrival_s=float(r.get("arrival_s", 0.0)))
            for i, r in enumerate(case["requests"])]


def run_router_case(world, case: Dict[str, Any]) -> Dict[str, Any]:
    """One "router" case on this rank of a ``spawn_mesh(run_router_cases,
    data=n_replicas, tp)`` (``world`` is the (data, tp) mesh)."""
    n = int(case["n_replicas"])
    meshes = make_replica_meshes(n, world.size, world.device.type)
    mine = meshes[world.data_rank]
    dev = mine.device
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
    api = build(case["cfg"], dev)
    params = _params(api, case)
    cushion = _cushion(api, params, case)
    scales = case.get("scales")
    if scales is not None:
        scales = convert.scales_from_numpy(scales, dev)
    dt = C.dtype_of(api.cfg)
    calib = [_batch(t if isinstance(t, dict) else {"tokens": t}, dev, dt)
             for t in case.get("calib") or []]
    wr = world.data_rank * world.size + world.rank
    rates = case.get("clock_rates")
    kw = {}
    if rates:
        rate = rates[wr % len(rates)]
        kw = dict(clock=_Clock(rate))
    router = ReplicaRouter(
        api, params, case["qcfg"], n_replicas=n,
        cfg=RouterConfig(**case.get("router_cfg", {})), meshes=meshes,
        cushion=cushion, scales=scales, calib_batches=calib or None,
        prequant=case.get("prequant", False),
        weight_bits=case.get("weight_bits", 8),
        n_slots=case.get("n_slots", 2), max_seq=case.get("max_seq", 128),
        kv_dtype=case.get("kv_dtype"), paged=case.get("paged", False),
        page_size=case.get("page_size", 32), **kw)
    if rates:
        # the engines read a clock of this rank's too
        router.replicas[world.data_rank].engine.engine._clock = \
            _Clock(rates[wr % len(rates)])
    del params
    # the wall of this rank's own replica steps (a step ends in its sync)
    own = router.replicas[world.data_rank].engine.engine
    walls: List[float] = []
    step = own.step

    def timed_step():
        t0 = time.perf_counter()
        out = step()
        walls.append(time.perf_counter() - t0)
        return out
    own.step = timed_step
    reqs = _requests(case, dev, dt)
    if case.get("warmup"):
        router.run(reqs)
    injector = (FaultInjector.parse(case["chaos"]) if case.get("chaos")
                else None)
    if dev.type == "cuda" and case.get("reset_peak", True):
        torch.cuda.reset_peak_memory_stats(dev)
    _lib.reset_launches()
    walls.clear()
    t0 = time.perf_counter()
    res = router.run(reqs, injector=injector)
    rep: Dict[str, Any] = {
        "rank": wr, "replica": world.data_rank, "backend": world.backend,
        "name": case.get("name"), "seconds": time.perf_counter() - t0,
        "step_s": sum(walls), "steps": len(walls),
        "launches": dict(_lib.LAUNCHES),
        "outputs": [(o.uid, o.replica, o.slot, np.asarray(o.tokens))
                    for o in res.outputs],
        "ttft_ms": {o.uid: o.ttft_ms for o in res.outputs},
        "tpot_ms": {o.uid: o.tpot_ms for o in res.outputs},
        "rejected": [(r.uid, r.reason) for r in res.rejected],
        "stats": res.stats.as_dict(), "peak_bytes": 0}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        rep["peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    del router
    gc.collect()
    return rep


def run_router_cases(world, cases: List[Dict[str, Any]]
                     ) -> List[Dict[str, Any]]:
    """Every "router" case on this rank, in order (a ``spawn_mesh``
    target); a "train" case runs ``shard_train_step`` on the world's
    ``(data, model)`` mesh (``_dp_probe.py``)."""
    return [run_router_case(world, c) if c["kind"] == "router"
            else run_case(world, c) for c in cases]
