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
  D), the same on every rank) and ``n_tokens`` through
  ``Engine.generate`` (``logits``: also the prefill's last logits, the
  cushion block as the cache holds it and, of a hybrid, the Mamba
  cushion state the rank's prefill starts from);
  ``warmup``: one ``generate`` first, outside the report (on the card a
  single rank captures its decode graph there, with two eager warm-up
  steps); ``margins``: the top-1 minus top-2 logit of every row at every
  generated token, teacher-forced (B, n_tokens); "continuous":
  ``requests`` (dicts of ``tokens`` (1, S), ``patches``, ``max_new_tokens``,
  ``arrival_s``) through ``ContinuousEngine.run`` with
  ``n_slots``, ``paged``, ``page_size``; ``clock_rates`` gives each rank a
  clock of its own (a tick of ``rate`` ms a read, the engine's ``clock``),
  to show that the ranks still agree; ``interrupt`` (rank, decode steps)
  sends that rank a SIGINT once it has run that many decode steps;
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
peak device memory and, for "continuous", every admission as (uid, slot,
decode steps so far) and each slot's cushion rows.
"""
from __future__ import annotations

import gc
import os
import signal
import time
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.distributed import collectives as DC
from repro_torch.kernels import _lib
from repro_torch.models import common as C
from repro_torch.models import convert
from repro_torch.models.registry import build
from repro_torch.serving.engine import Engine, check_tree_sums
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
    patches (numpy or a tensor) in the model dtype."""
    tok = d["tokens"]
    out = {"tokens": (tok.to(device, torch.int32)
                      if isinstance(tok, torch.Tensor)
                      else _tokens(tok, device))}
    p = d.get("patches")
    if p is not None:
        p = p if isinstance(p, torch.Tensor) else torch.from_numpy(
            np.array(p))
        out["patches"] = p.to(device, dtype)
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
            local = eng.api.mod.local_cushion(eng.cushion, eng.api.cfg)
            out["cushion_state"] = {k: _np(v)
                                    for k, v in local["state"].items()}
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


def run_case(mesh, case: Dict[str, Any]) -> Dict[str, Any]:
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
    if dev.type == "cuda" and case.get("reset_peak", True):
        torch.cuda.reset_peak_memory_stats(dev)
    rep: Dict[str, Any] = {"rank": mesh.rank, "backend": mesh.backend,
                           "name": case.get("name")}
    dt = C.dtype_of(api.cfg)
    if case["kind"] == "static":
        batch = _batch(case, dev, dt)
        if case.get("logits"):
            rep.update(prefill_view(eng, batch))
        if case.get("warmup"):
            eng.generate(batch, case["n_tokens"])
        _lib.reset_launches()
        res = eng.generate(batch, case["n_tokens"])
        rep["launches"] = dict(_lib.LAUNCHES)
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
