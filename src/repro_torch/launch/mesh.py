"""Rank meshes over ``torch.distributed``, ported from
``repro/launch/mesh.py``.

The reference builds a ``(data, tp)`` device mesh in one process and lets
GSPMD place the shards. The port runs one process a rank:

* ``spawn_mesh(fn, data, tp, *args, device=...)`` starts ``data * tp``
  processes (the ``spawn`` start method), joins them into one process group
  through a ``file://`` store in a fresh temporary directory (no port to
  collide on when tests run in parallel), calls ``fn(mesh, *args)`` on
  every rank and returns rank 0's result (every rank's with
  ``every_rank=True``). A rank that raises stops them all, and the
  traceback is raised in the caller. ``fn`` must be importable by the
  child: a module-level function of a module that does not import jax.
  ``spawn_tp(fn, tp, ...)`` is ``spawn_mesh(fn, 1, tp, ...)``.
* ``make_tp_mesh(tp, data)`` is the calling rank's ``TPMesh``: its place
  on both axes, one process group an axis (the ranks of its data row, the
  ``tp`` group, and of its tp column, the ``data`` group), its device and
  the backend. World rank ``d * tp + t`` sits at ``(d, t)``, the
  reference's ``reshape(data, tp)``. ``make_mesh(shape, axes)`` names the
  axes as the caller asks (a training mesh: ``("data", "model")``),
  ``single_device_mesh()`` is the one-rank ``("data",)`` mesh.

Rank r runs on ``cuda:{r % device_count}``. Where every rank has a card of
its own the backend is NCCL by default; where ranks share a card (NCCL
refuses two ranks on one device) it is gloo, which takes CUDA tensors for
``all_reduce`` and ``broadcast`` and stages them through the host: that
proves the mechanism and the kernels on each rank's part, not the speed of
tensor or data parallelism. The CPU always uses gloo. ``spawn_mesh(...,
backend="gloo")`` asks for gloo on separate cards too (NCCL on a shared
card or the CPU raises). A mesh of one rank needs no process group: the
whole sharded code path runs with no collective.

The kernels are built once in the caller (``_lib.build()``) before the
ranks start, so two ranks never both run nvcc.

``make_replica_meshes(n, tp)``, called in a rank of ``spawn_mesh(fn,
data=n, tp=tp)``, gives the serving router its ``n`` replicas: replica i
is data row i, a ``(data=1, tp)`` mesh over that row's own process group
(replicas never share a tp group). The calling rank gets its own row's
live ``TPMesh`` and a ``ReplicaGroup`` (the world ranks) for every other
row.

The reference's ``make_production_mesh`` needs 256 or 512 devices and
raises its ``RuntimeError`` with fewer ranks. Its dry-run's meshes, which
the reference fakes with 512 host devices, are ``dryrun_mesh``'s here:
one rank's view of a mesh of any size with no process group, on ``meta``
(``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
import os
import queue as _queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch

# how long spawn_mesh waits for the ranks' results
RESULT_TIMEOUT_S = 3600.0
# the axis names a mesh may carry: the data axis, then the tensor-parallel
# one ("tp" at serving, "model" in training, as the reference's callers)
_TP_AXES = ("tp", "model")


@dataclasses.dataclass
class TPMesh:
    """One rank's view of a ``(data, tp)`` mesh. ``rank`` / ``size`` /
    ``group`` are the tensor-parallel axis (the ranks of this rank's data
    row), ``data_rank`` / ``data_size`` / ``data_group`` the data axis (the
    ranks of its tp column); a group is None on an axis of one rank, and
    the world group where the axis spans every rank. ``shape`` and
    ``axis_names`` are the reference mesh's, which the sharding rules
    (``distributed/sharding.py``) read. ``base`` is the world rank of the
    mesh's first rank: a replica's mesh (``make_replica_meshes``) is a row
    of a larger world."""
    rank: int
    size: int
    group: Any
    device: torch.device
    backend: Optional[str]
    data_rank: int = 0
    data_size: int = 1
    data_group: Any = None
    axes: Tuple[str, ...] = ("data", "tp")
    base: int = 0

    @property
    def world_ranks(self) -> Tuple[int, ...]:
        """The world ranks of this mesh, data row by data row."""
        return tuple(range(self.base,
                           self.base + self.data_size * self.size))

    @property
    def shape(self) -> Dict[str, int]:
        sizes = {"data": self.data_size}
        if len(self.axes) > 1:
            sizes[self.axes[1]] = self.size
        return sizes

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.axes


def rank_device(rank: int, device="cuda") -> torch.device:
    """Rank ``rank``'s device: ``cuda:{rank % device_count}`` or the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but is not available; pass "
                           "device='cpu' to run the plain versions")
    return torch.device("cuda", rank % torch.cuda.device_count())


def choose_backend(tp: int, device="cuda",
                   backend: Optional[str] = None) -> str:
    """``backend`` if given (checked), else NCCL where every rank has a card
    of its own and gloo where ranks share one or run on the CPU."""
    dev = torch.device(device)
    nccl_ok = dev.type == "cuda" and torch.cuda.device_count() >= tp
    if backend is None:
        return "nccl" if nccl_ok else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and not nccl_ok:
        raise ValueError(
            f"NCCL needs a card a rank: {tp} ranks on "
            f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} "
            f"card(s) of {dev.type}")
    return backend


# the calling rank's process groups by (data, tp): dist.new_group is a
# collective of the whole world, made once a spawn (_rank_main clears it)
_GROUPS: Dict[Tuple[int, int], Tuple[Any, Any]] = {}


def _axis_groups(data: int, tp: int, rank: int) -> Tuple[Any, Any]:
    """(tp group, data group) of world rank ``rank``. Every rank makes
    every group, in the same order, as ``new_group`` requires."""
    import torch.distributed as dist
    if (data, tp) not in _GROUPS:
        if data == 1:
            groups = (dist.group.WORLD, None)
        elif tp == 1:
            groups = (None, dist.group.WORLD)
        else:
            rows = [dist.new_group([d * tp + t for t in range(tp)])
                    for d in range(data)]
            cols = [dist.new_group([d * tp + t for d in range(data)])
                    for t in range(tp)]
            groups = (rows, cols)
        _GROUPS[(data, tp)] = groups
    tp_g, data_g = _GROUPS[(data, tp)]
    if isinstance(tp_g, list):
        return tp_g[rank // tp], data_g[rank % tp]
    return tp_g, data_g


def make_tp_mesh(tp: int, data: int = 1, device="cuda",
                 axes: Tuple[str, ...] = ("data", "tp")) -> TPMesh:
    """The calling rank's ``(data, tp)`` mesh. One rank works in any
    process (no group); more need the process group that ``spawn_mesh``
    made, of ``data * tp`` ranks."""
    if tp < 1 or data < 1:
        raise ValueError(f"a (data={data}, tp={tp}) mesh needs both >= 1")
    import torch.distributed as dist
    n = data * tp
    if n == 1 and not dist.is_initialized():
        return TPMesh(0, 1, None, rank_device(0, device), None, axes=axes)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"make_tp_mesh({tp}, data={data}) runs inside a rank of "
            f"spawn_mesh(fn, {data}, {tp}, ...), which makes the process "
            f"group")
    rank = dist.get_rank()
    tp_g, data_g = _axis_groups(data, tp, rank)
    return TPMesh(rank % tp, tp, tp_g, rank_device(rank, device),
                  dist.get_backend(), data_rank=rank // tp, data_size=data,
                  data_group=data_g, axes=axes)


def make_mesh(shape, axes, device="cuda") -> TPMesh:
    """The calling rank's mesh of ``shape`` over ``axes``: ``("data",)``,
    or ``("data", "tp")`` / ``("data", "model")`` (the reference's training
    meshes name the second axis ``model``)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or axes[0] != "data" or len(axes) > 2 or (
            len(axes) == 2 and axes[1] not in _TP_AXES):
        raise ValueError(f"a mesh of axes {axes} and shape {shape}: the "
                         f"port's meshes are ('data',) and ('data', X) "
                         f"with X in {_TP_AXES}")
    tp = shape[1] if len(shape) == 2 else 1
    return make_tp_mesh(tp, data=shape[0], device=device, axes=axes)


def single_device_mesh(device="cuda") -> TPMesh:
    """The one-rank ``("data",)`` mesh."""
    return make_mesh((1,), ("data",), device)


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axes) of the reference's production meshes."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production meshes, (data=16, model=16) or (pod=2,
    data=16, model=16): they need 256 or 512 ranks."""
    import numpy as np
    import torch.distributed as dist
    shape, axes = production_shape(multi_pod)
    n = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}; have {have}. The dry-run "
            f"runs one rank of it on meta tensors: "
            f"dryrun_mesh({shape}, {axes}) (launch/dryrun.py).")
    return make_mesh(shape, axes)


@dataclasses.dataclass
class DryRunMesh(TPMesh):
    """One rank's view of a mesh of any ``sizes`` over ``axes`` for the
    dry-run: rank 0 of the tensor-parallel axis (the last), no process
    group, device ``meta``. ``shape`` and ``axis_names`` are the
    reference mesh's, which ``distributed/sharding.py`` resolves; the
    collectives record what the rank would issue
    (``distributed/collectives.py``); ``data_size`` is the ranks of the
    batch axes (``("pod", "data")`` or ``"data"``)."""
    sizes: Tuple[int, ...] = ()

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.sizes))


def dryrun_mesh(shape, axes) -> DryRunMesh:
    """The dry-run's view of rank 0 of a ``shape`` mesh over ``axes``
    (``("data",)``, ``("data", X)`` or ``("pod", "data", X)`` with X in
    ``("tp", "model")``)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    batch_axes = axes[:-1] if axes[-1] in _TP_AXES else axes
    if len(shape) != len(axes) or batch_axes not in (("data",),
                                                     ("pod", "data")):
        raise ValueError(f"a dry-run mesh of axes {axes} and shape {shape}")
    tp = shape[-1] if axes[-1] in _TP_AXES else 1
    data = 1
    for s in shape[:len(batch_axes)]:
        data *= s
    return DryRunMesh(0, tp, None, torch.device("meta"), None,
                      data_size=data, axes=axes, sizes=shape)


@dataclasses.dataclass(frozen=True)
class ReplicaGroup:
    """Another replica's ``(data=1, tp)`` mesh as a rank outside it sees
    it: its world ranks, the first of which speaks for it."""
    ranks: Tuple[int, ...]

    @property
    def world_ranks(self) -> Tuple[int, ...]:
        return self.ranks


def make_replica_meshes(n: int, tp: int = 1, device="cuda") -> list:
    """The serving router's ``n`` replica meshes of ``tp`` ranks each (the
    reference's disjoint ``(data=1, tp)`` meshes): entry i is data row i of
    the ``(data=n, tp)`` world, this rank's own row as its live ``TPMesh``
    (``data_size`` 1, ``base`` the row's first world rank) and every other
    row as a ``ReplicaGroup``. Runs inside a rank of ``spawn_mesh(fn, n,
    tp, ...)``; one replica of one rank needs no process group."""
    if n < 1 or tp < 1:
        raise ValueError(f"{n} replicas of tp={tp}: both must be >= 1")
    import torch.distributed as dist
    if n * tp == 1 and not dist.is_initialized():
        return [make_tp_mesh(1, device=device)]
    if not dist.is_initialized() or dist.get_world_size() != n * tp:
        raise RuntimeError(
            f"make_replica_meshes({n}, {tp}) runs inside a rank of "
            f"spawn_mesh(fn, {n}, {tp}, ...), which makes the process "
            f"group")
    world = make_tp_mesh(tp, data=n, device=device)
    out: list = []
    for i in range(n):
        ranks = tuple(range(i * tp, (i + 1) * tp))
        if i == world.data_rank:
            out.append(TPMesh(world.rank, tp, world.group, world.device,
                              world.backend, base=i * tp))
        else:
            out.append(ReplicaGroup(ranks))
    return out


def _rank_main(fn: Callable, rank: int, data: int, tp: int, init_file: str,
               device: str, backend: str, args: tuple, results) -> None:
    import torch.distributed as dist
    try:
        dev = rank_device(rank, device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        # one host: gloo's sockets stay on the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=data * tp)
        out = fn(make_tp_mesh(tp, data=data, device=device), *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        _GROUPS.clear()
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_mesh(fn: Callable, data: int, tp: int, *args, device="cuda",
               every_rank: bool = False, backend: Optional[str] = None,
               timeout_s: float = RESULT_TIMEOUT_S):
    """Run ``fn(mesh, *args)`` on ``data * tp`` ranks (see the module
    docstring) over ``backend`` (default: ``choose_backend``). Returns rank
    0's result, or the list of every rank's in world-rank order; raises
    when a rank fails or the ranks have not all returned within
    ``timeout_s``."""
    if tp < 1 or data < 1:
        raise ValueError(f"a (data={data}, tp={tp}) mesh needs both >= 1")
    n = data * tp
    backend = choose_backend(n, device, backend)
    if torch.device(device).type == "cuda":
        rank_device(0, device)              # raises without a card
        from repro_torch.kernels import _lib
        _lib.build()
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_mesh_")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, data, tp, os.path.join(tmp, "store"),
                               str(device), backend, args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    failure = None
    waited = 0.0
    try:
        while len(got) < n and failure is None:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except _queue.Empty:
                waited += 1.0
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode} and no result")
                elif waited > timeout_s:
                    failure = f"no result within {timeout_s:.0f} s"
                continue
            if ok:
                got[rank] = out
            else:
                failure = f"rank {rank} raised:\n{out}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"spawn_mesh({getattr(fn, '__name__', fn)}, "
                           f"data={data}, tp={tp}): {failure}")
    return [got[r] for r in range(n)] if every_rank else got[0]


def spawn_tp(fn: Callable, tp: int, *args, device="cuda",
             every_rank: bool = False, backend: Optional[str] = None,
             timeout_s: float = RESULT_TIMEOUT_S):
    """``spawn_mesh(fn, 1, tp, ...)``: a serving mesh of ``tp`` ranks."""
    return spawn_mesh(fn, 1, tp, *args, device=device, every_rank=every_rank,
                      backend=backend, timeout_s=timeout_s)
