"""What one rank of a data-parallel run does, and what it saw: the
``launch/mesh.spawn_mesh`` target of the data-parallel parity tests
(``test_torch_data_parallel.py``, ``test_torch_cuda.py``) and of
``chip_smoke.py``'s phase 4l. It imports neither jax nor the JAX package:
a spawned rank imports this module (by the caller's ``sys.path``, which
the ranks inherit) to find its target.

``run_cases(mesh, cases)`` runs each case (a dict) on the calling rank and
returns one report a case (numpy arrays and numbers, and the case's wall
``seconds`` on the rank). ``kind``:

* "compressed": ``x`` (data, ...) f32; the rank's row through
  ``compressed_psum``: ``out``, the int32 code sum ``acc`` and ``scale``.
* "dp_step": ``dp_train_step_compressed`` of the reference test's
  quadratic ``grad_fn`` on ``params`` (K, N) and ``batch`` (B, K).
* "range_tie": ``x`` (data, ...) f32, the rank's row; the gradient of the
  activation-range penalty of ``site_stats`` of it under the data axis;
  with ``axis`` "tp", ``x`` (tp, ...), the rank's channels of a cut
  activation under the tp axis, and also the gradients of ``tp_extrema``
  (min + 2 max) and of the gathered channel maxima (weighted 1, 2, ...).
* "grad": the gradient of the tuning loss (``cushioncache.tune_loss_grads``)
  at ``cushion`` (a numpy tree, or ``cushion_ids`` extracted on the rank)
  on the global ``batch``, under the data axis; with ``one_rank`` the last
  data rank also computes it alone on the whole batch (``one``, with the
  cushion it started from), beside rank 0's ``profile`` of one
  data-parallel call.
* "tune": ``prefix_tune(mesh=)`` from ``cushion`` (or ``cushion_ids``
  extracted on the rank) on ``batches`` under ``qcfg`` / ``ccfg``: the
  log, the cushion it started from and the tuned one, the launches and the
  host syncs of the tuning, its wall ``ms`` a step; with ``one_rank`` the
  ranks of ``one_rank_tp`` (default all) also tune alone on the whole
  model and batches (``one``: its log, launches and ms a step);
  ``mesh_shape`` as "train" takes it.
* "train": ``shard_train_step`` on the mesh (its ``("data", "model")``
  form, ``make_mesh``; a model axis of more than one rank trains the
  rank's tensor-parallel tree), ``steps`` steps of the global
  ``batches`` from the ``params`` (a numpy tree) or the tree made from
  ``seed``, under ``qcfg`` with ``scales`` (a plain numpy tree): the
  metrics a step, the launches and the all-reduces a step, this rank's
  resident parameter and moment bytes beside the whole tree's
  (``leaves``: each leaf's spec, its ``engine.TPPart`` and element
  counts), the peak device memory, the final whole parameters over the
  data axis (``return_params``; the rank's tensor-parallel part; else on
  a model axis ``whole_digests``, the ``engine.tree_checksum`` of each
  leaf every rank holds whole), the
  first step's first moment (``first_moment``: ``mu1``), ``ms`` a step,
  ``profile`` (one more step, timed), and with ``one_rank`` the last
  data row's comparison with ``make_train_step`` alone on the whole tree
  and batches, cut to the rank's part (``one``: its metrics, each leaf's
  difference, the two runs' parameter updates and first moments, each of
  the tree as a vector, against each other, and its first step's first
  moment), made beside rank 0's profile. ``one_rank_first``: that rank
  runs the one-rank steps before the sharded ones and frees them, while
  the other ranks wait before making their shards (a model whose whole
  tree, gradients and moments would not fit on the card beside the
  ranks' shards); ``one`` then holds no comparison of the final
  parameters and moments (``diffs``, ``update``, ``moments``).
  ``donate``: the step writes the rank's new shards and moments into the
  old ones (``shard_train_step(donate=True)``; no ``profile`` then).
* "refuse": ``shard_train_step`` and ``prefix_tune`` over the mesh on
  ``cfg`` (a family with experts): the messages they raise.

A case names the model by ``cfg`` (the port's ``ModelConfig``) and either
``params`` (numpy) or ``seed`` (made on the rank's device), then restored
from the latest checkpoint of ``ckpt_dir`` if given.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import monitoring as MON
from repro_torch.configs.base import CushionConfig, QuantConfig, RunConfig
from repro_torch.core import cushioncache as CC
from repro_torch.core import outliers as OUT
from repro_torch.core import quantization as TQ
from repro_torch.distributed import collectives as DC
from repro_torch.kernels import _lib
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import convert
from repro_torch.models.registry import build
from repro_torch.models.common import as_tree
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_paths
from repro_torch.serving.engine import (shard_tree, tp_leaf_parts,
                                        tree_checksum)
from repro_torch.train import trainer as TR


@contextlib.contextmanager
def counting_all_reduces():
    """The ``torch.distributed.all_reduce`` calls inside, by their bytes."""
    import torch.distributed as dist
    seen, real = [], dist.all_reduce

    def counted(t, *a, **kw):
        seen.append(t.numel() * t.element_size())
        return real(t, *a, **kw)
    dist.all_reduce = counted
    try:
        yield seen
    finally:
        dist.all_reduce = real


def _np(t: torch.Tensor) -> np.ndarray:
    """An f32 copy (never a view: pickling a CPU tensor for another
    process moves its storage into shared memory)."""
    return t.detach().float().cpu().numpy().copy()


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return _np(tree)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _batch(b, dev):
    return {k: torch.as_tensor(np.array(v), device=dev) for k, v in b.items()}


def _params(api, case):
    if "params" in case:
        return convert.params_from_numpy(case["params"], api.device)
    params = api.init_params(torch.Generator(api.device).manual_seed(
        case.get("seed", 0)))
    if case.get("ckpt_dir"):
        from repro_torch.launch.serve import restore_params
        params = restore_params(case["ckpt_dir"], params)
    return params


def _cushion(api, params, case):
    if case.get("cushion") is not None:
        return convert.cushion_from_numpy(case["cushion"], api.device)
    ids = torch.as_tensor(np.asarray(case["cushion_ids"]), dtype=torch.int32)
    return api.extract_cushion(params, ids, None, QuantConfig())


def _profiled(fn, mesh) -> Dict[str, Any]:
    """``fn()`` once, on data rank 0 under the profiler (one process traces
    the card at a time): its wall ms (a sync at the end) and the device
    time of the kernels this process ran in it; the other ranks run it
    alone (its collectives need them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = mesh.device
    _sync(dev)
    if mesh.data_rank != 0:
        fn()
        _sync(dev)
        return {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    # the raw results: the profiler's events() list takes seconds to build
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e6
    return {"ms": wall, "device_ms": busy if busy else "not measured"}


def _compressed(mesh, case):
    x = torch.as_tensor(case["x"][mesh.data_rank], device=mesh.device)
    with DC.use_data(mesh):
        acc, scale, n = DC._compressed_parts(x, "data")
        out = DC.compressed_psum(x, "data")
    return {"out": _np(out), "acc": acc.cpu().numpy().copy(),
            "scale": float(scale), "n": n}


def _dp_step(mesh, case):
    dev = mesh.device
    p = torch.as_tensor(case["params"], device=dev)

    def grad_fn(params, batch):
        w = params.detach().requires_grad_()
        with torch.enable_grad():
            loss = ((batch @ w) ** 2).mean()
            (g,) = torch.autograd.grad(loss, [w])
        return loss.detach(), g
    fn = DC.dp_train_step_compressed(grad_fn, mesh)
    loss, g = fn(p, torch.as_tensor(case["batch"], device=dev))
    return {"loss": float(loss), "grads": _np(g)}


def _range_tie(mesh, case):
    if case.get("axis") == "tp":
        # the rank's channels of a cut activation: the statistics and the
        # extrema are the ranks'
        x = torch.as_tensor(case["x"][mesh.rank], device=mesh.device)
        ctx, cut = DC.use_tp(mesh), True
    else:
        x = torch.as_tensor(case["x"][mesh.data_rank], device=mesh.device)
        ctx, cut = DC.use_data(mesh), False
    x = x.requires_grad_()
    rep = {}
    with ctx, torch.enable_grad():
        stats = TQ.site_stats(x, cut=cut)
        pen = OUT.activation_range_penalty({"layers": {"qkv": stats}})
        (g,) = torch.autograd.grad(pen, [x], retain_graph=cut)
        if cut:
            ch = stats["absmax_ch"]
            w = torch.arange(1.0, ch.numel() + 1, device=x.device)
            (gc,) = torch.autograd.grad((ch * w).sum(), [x])
            mn, mx = DC.tp_extrema(x)
            (ge,) = torch.autograd.grad(mn + 2 * mx, [x])
            rep = {"extrema_grad": _np(ge), "channel_grad": _np(gc),
                   "absmax_ch": _np(ch)}
    return {"grad": _np(g), "penalty": float(pen.detach()),
            "amin": float(stats["amin"].detach()),
            "amax": float(stats["amax"].detach()), **rep}


def _grad(mesh, case):
    dev = mesh.device
    api = build(case["cfg"], dev)
    params = _params(api, case)
    cushion = _cushion(api, params, case)
    qcfg = case["qcfg"]
    ccfg = CushionConfig(lam=case["lam"])
    batch = _batch(case["batch"], dev)
    rep: Dict[str, Any] = {}

    def dp():
        with DC.use_data(mesh):
            return CC.tune_loss_grads(api, params, cushion,
                                      DC.rank_rows(batch, mesh), qcfg, ccfg)
    _lib.reset_launches()
    g, m = dp()
    _sync(dev)
    rep["launches"] = dict(_lib.LAUNCHES)
    rep["grads"] = _np_tree(g)
    rep["metrics"] = {k: float(v) for k, v in m.items()}
    if case.get("profile"):
        rep["profile"] = _profiled(dp, mesh)
    if case.get("one_rank") and mesh.data_rank == mesh.data_size - 1:
        g1, m1 = CC.tune_loss_grads(api, params, cushion, batch, qcfg, ccfg)
        rep["one"] = {"grads": _np_tree(g1),
                      "metrics": {k: float(v) for k, v in m1.items()},
                      "cushion": _np_tree(cushion)}
    return rep


def _tune(mesh, case):
    if "mesh_shape" in case:
        # another layout of the same world, as "train" takes it
        mesh = make_mesh(case["mesh_shape"], ("data", "model"), mesh.device)
    dev = mesh.device
    _free(dev)
    api = build(case["cfg"], dev)
    params = _params(api, case)
    cushion = _cushion(api, params, case)
    batches = [_batch(b, dev) for b in case["batches"]]
    n = min(len(batches), case["ccfg"].tune_steps)

    def tuned(m):
        _lib.reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        with MON.count_host_syncs() as hs:
            tr = CC.prefix_tune(api, params, cushion, iter(batches),
                                case["qcfg"], case["ccfg"], mesh=m,
                                verbose=False)
        _sync(dev)
        return tr, hs.count, dict(_lib.LAUNCHES), \
            (time.perf_counter() - t0) * 1e3 / max(n, 1)
    tr, syncs, launches, ms = tuned(mesh)
    rep = {"log": tr.log, "cushion": _np_tree(tr.cushion),
           "start": _np_tree(cushion),
           "fingerprint": CC.cushion_fingerprint(tr.cushion),
           "launches": launches, "host_syncs": syncs, "ms": ms}
    if case.get("one_rank") and mesh.data_rank == mesh.data_size - 1 \
            and mesh.rank in case.get("one_rank_tp", range(mesh.size)):
        one, _, launches, ms = tuned(None)
        rep["one"] = {"log": one.log, "launches": launches, "ms": ms}
    return rep


def _free(dev):
    """The last case's tensors and the caching allocator's free blocks
    given back before a case builds (the ranks share one card)."""
    if dev.type == "cuda":
        import gc
        gc.collect()
        torch.cuda.empty_cache()


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _train(mesh, case):
    # a training mesh names its axes ("data", "model"), as the reference's
    # make_mesh callers do; ``mesh_shape`` lays the same world out another
    # way (two ranks of a data axis as one model axis of two)
    mesh = make_mesh(case.get("mesh_shape", (mesh.data_size, mesh.size)),
                     ("data", "model"), mesh.device)
    dev = mesh.device
    _free(dev)
    api = build(case["cfg"], dev)
    full = as_tree(_params(api, case))
    run = RunConfig(model=case["cfg"], quant=case.get("qcfg", QuantConfig()),
                    seq_len=case["seq"], global_batch=case["batch_rows"],
                    lr=case.get("lr", 1e-3), train_steps=case["steps"],
                    warmup_steps=case.get("warmup", 2))
    opt = TR.make_optimizer(run)
    mb = case.get("microbatches", 1)
    scales = None if case.get("scales") is None else \
        convert.scales_from_numpy(case["scales"], dev)
    batches = [_batch(b, dev) for b in case["batches"]]
    if mesh.size > 1:
        # the rank's tensor-parallel tree, which the one-rank run is cut to
        rank_cut = lambda t: shard_tree(t, case["cfg"], mesh)  # noqa: E731
        parts = tree_leaves(tp_leaf_parts(full, case["cfg"], mesh.size))
    else:
        rank_cut, parts = (lambda t: t), None
    one_rank = case.get("one_rank") and mesh.data_rank == mesh.data_size - 1 \
        and mesh.rank in case.get("one_rank_tp", range(mesh.size))
    first = None
    if case.get("one_rank_first"):
        # alone first, then freed: the one-rank tree, its gradients and
        # moments go before any rank makes its shards (the others wait)
        if one_rank:
            first = _one_rank_steps(api, run, opt, mb, scales, full,
                                    batches, case, dev, rank_cut)
            first = {k: v for k, v in first.items()
                     if k not in ("p", "st", "keep")}
            _free(dev)
        import torch.distributed as dist
        dist.barrier()
    fn, p_specs, o_specs = TR.shard_train_step(
        api, run, opt, mesh, full, microbatches=mb, scales=scales,
        donate=case.get("donate", False))
    shards = TR.data_shards(full, p_specs, mesh, cfg=case["cfg"])
    state = opt.init(shards)
    paths = tree_leaves(tree_paths(full))
    rep: Dict[str, Any] = {
        "full_bytes": _bytes(full), "shard_bytes": _bytes(shards),
        "moment_bytes": _bytes(state.mu) + _bytes(state.nu),
        "specs": p_specs, "metrics": [], "launches": [], "ms": [],
        "collectives": [],
        "leaves": {p: {"spec": spec, "full": t.numel(),
                       "shard": s_.numel(), "moments": m.numel() * 2,
                       "moment_dtype": str(m.dtype),
                       "part": None if parts is None else tuple(parts[i])}
                   for i, (p, spec, t, s_, m) in enumerate(zip(
                       paths, tree_leaves(p_specs), tree_leaves(full),
                       tree_leaves(shards), tree_leaves(state.mu)))}}
    if one_rank and first is None:
        keep = tree_map(lambda t: t.clone(), full)
    del full
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(case["steps"]):
        b = batches[i % len(batches)]
        _lib.reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        with counting_all_reduces() as seen:
            shards, state, met = fn(shards, state, b)
        _sync(dev)
        rep["ms"].append((time.perf_counter() - t0) * 1e3)
        rep["launches"].append(dict(_lib.LAUNCHES))
        rep["collectives"].append(len(seen))
        rep["metrics"].append({k: float(v) for k, v in met.items()})
        if i == 0 and case.get("first_moment"):
            # 0.1 x the clipped gradient of the first step, the rank's
            # tensor-parallel part
            with DC.use_data(mesh):
                rep["mu1"] = _np_tree(TR._FSDP(p_specs, mesh).gather(
                    state.mu))
    rep["peak_bytes"] = (int(torch.cuda.max_memory_allocated(dev))
                         if dev.type == "cuda" else 0)
    fsdp = TR._FSDP(p_specs, mesh)
    with DC.use_data(mesh):
        whole = fsdp.gather(shards)
        whole_mu = fsdp.gather(state.mu)
    if case.get("profile"):
        # one more step (the step is functional: the run's state stays);
        # the last collective of the case, so that the one-rank run below
        # goes beside rank 0's profile
        rep["profile"] = _profiled(lambda: fn(shards, state, batches[0]),
                                   mesh)
    if case.get("return_params"):
        rep["params"] = _np_tree(whole)
    elif parts is not None:
        # the leaves every rank holds whole, to hold the ranks equal: each
        # one's digest (``engine.tree_checksum``: its 32-bit words summed,
        # and the odd ones), not its values, which a rank would send back
        # whole (internvl2-26b's embedding and head are 2.3 GB each in f32)
        rep["whole_digests"] = {p: tree_checksum(t).cpu().tolist()
                                for p, t, part in zip(
                                    paths, tree_leaves(whole), parts)
                                if part.own == 0}
    if first is not None:
        rep["one"] = first
    elif one_rank:
        one = _one_rank_steps(api, run, opt, mb, scales, keep, batches,
                              case, dev, rank_cut)
        p, st, keep = one.pop("p"), one.pop("st"), one.pop("keep")
        diffs = {}
        num = den = dot = nd = 0.0
        p, keep, st_mu = rank_cut(p), rank_cut(keep), rank_cut(st.mu)
        for path, a, w, k0 in zip(paths, tree_leaves(whole), tree_leaves(p),
                                  tree_leaves(keep)):
            # the resume bar (rtol 1e-5, atol 1e-6) of test_torch_train.py
            a, w, k0 = a.float(), w.float(), k0.float()
            d = (a - w).abs()
            past = d > 1e-6 + 1e-5 * w.abs()
            diffs[path] = {"max": float(d.max()),
                           "past": float(past.float().mean()),
                           "worst_past": float(d[past].max()) if past.any()
                           else 0.0}
            # the two runs' updates of the whole tree, as vectors
            n_, d_, t_, a_ = _sums([a - k0], [w - k0])
            num, den, dot, nd = num + n_, den + d_, dot + t_, nd + a_
        rep["one"] = {**one, "diffs": diffs,
                      "update": _compare(num, den, dot, nd),
                      "moments": _compare(*_sums(tree_leaves(whole_mu),
                                                 tree_leaves(st_mu)))}
    return rep


def _one_rank_steps(api, run, opt, mb, scales, keep, batches, case, dev,
                    rank_cut):
    """``make_train_step`` alone on the whole tree ``keep`` for the case's
    steps: its metrics, ms and launches a step, its first step's first
    moment cut to the rank's part (``mu1``), its peak device memory above
    what was held before, its parameter and moment bytes, and the final
    ``p`` and ``st`` beside ``keep``."""
    step = TR.make_train_step(api, run, opt, microbatches=mb, scales=scales)
    p, st = keep, opt.init(keep)
    losses, mu1, one_ms, one_launches = [], None, [], []
    _sync(dev)
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(case["steps"]):
        _lib.reset_launches()
        t0 = time.perf_counter()
        p, st, met = step(p, st, batches[i % len(batches)])
        _sync(dev)
        one_ms.append((time.perf_counter() - t0) * 1e3)
        one_launches.append(dict(_lib.LAUNCHES))
        losses.append({k: float(v) for k, v in met.items()})
        if i == 0 and case.get("first_moment"):
            mu1 = _np_tree(rank_cut(st.mu))
    peak = (int(torch.cuda.max_memory_allocated(dev)) - held
            if dev.type == "cuda" else 0)
    return {"metrics": losses, "mu1": mu1, "ms": one_ms,
            "launches": one_launches, "peak_bytes": peak,
            "bytes": {"params": _bytes(keep),
                      "moments": _bytes(st.mu) + _bytes(st.nu)},
            "p": p, "st": st, "keep": keep}


def _sums(got, want):
    """(|got - want|^2, |want|^2, got . want, |got|^2) over leaf pairs."""
    num = den = dot = nd = 0.0
    for a, w in zip(got, want):
        a, w = a.float(), w.float()
        num += float((a - w).square().sum())
        den += float(w.square().sum())
        dot += float((a * w).sum())
        nd += float(a.square().sum())
    return num, den, dot, nd


def _compare(num, den, dot, nd):
    """Two trees as vectors: {relative L2, cosine}."""
    return {"rel_l2": (num / den) ** 0.5 if den else 0.0,
            "cosine": dot / (nd * den) ** 0.5 if nd * den else 1.0}


def _refuse(mesh, case):
    api = build(case["cfg"], mesh.device)
    params = api.init_params(torch.Generator(mesh.device).manual_seed(0))
    run = RunConfig(model=case["cfg"], quant=QuantConfig(), seq_len=8,
                    global_batch=2, train_steps=1)
    out = {}
    try:
        TR.shard_train_step(api, run, TR.make_optimizer(run), mesh,
                            params.tree())
        out["train"] = None
    except ValueError as e:
        out["train"] = str(e)
    try:
        CC.prefix_tune(api, params, {"kv": {}}, iter(()), QuantConfig(),
                       CushionConfig(tune_steps=1), mesh=mesh, verbose=False)
        out["tune"] = None
    except ValueError as e:
        out["tune"] = str(e)
    return out


_KINDS = {"compressed": _compressed, "dp_step": _dp_step,
          "range_tie": _range_tie, "grad": _grad, "tune": _tune,
          "train": _train, "refuse": _refuse}


def run_case(mesh, case: Dict[str, Any]) -> Dict[str, Any]:
    t0 = time.perf_counter()
    rep = _KINDS[case["kind"]](mesh, case)
    rep.update(rank=mesh.data_rank, tp_rank=mesh.rank, backend=mesh.backend,
               name=case.get("name"), seconds=time.perf_counter() - t0)
    return rep


def run_cases(mesh, cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Every case on this rank, in order (a ``spawn_mesh`` target)."""
    return [run_case(mesh, c) for c in cases]
