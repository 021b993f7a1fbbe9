"""Serving meshes over ``torch.distributed``, ported from
``repro/launch/mesh.py``.

The reference builds a ``(data, tp)`` device mesh in one process and lets
GSPMD place the shards. The port runs one process a rank:

* ``spawn_tp(fn, tp, *args, device=...)`` starts ``tp`` processes (the
  ``spawn`` start method), joins them into one process group through a
  ``file://`` store in a fresh temporary directory (no port to collide on
  when tests run in parallel), calls ``fn(mesh, *args)`` on every rank and
  returns rank 0's result (every rank's with ``every_rank=True``). A rank
  that raises stops them all, and the traceback is raised in the caller.
  ``fn`` must be importable by the child: a module-level function of a
  module that does not import jax.
* ``make_tp_mesh(tp)`` is the calling rank's ``TPMesh``: its rank, the
  group's size, the process group, its device and the backend.

Rank r runs on ``cuda:{r % device_count}``. Where every rank has a card of
its own the backend is NCCL by default; where ranks share a card (NCCL
refuses two ranks on one device) it is gloo, which takes CUDA tensors for
``all_reduce`` and ``broadcast`` and stages them through the host: that
proves the mechanism and the kernels on each rank's shard, not the speed of
tensor parallelism. The CPU always uses gloo. ``spawn_tp(...,
backend="gloo")`` asks for gloo on separate cards too (NCCL on a shared
card or the CPU raises). ``tp = 1`` needs no process group: the whole
sharded code path runs with no collective.

The kernels are built once in the caller (``_lib.build()``) before the
ranks start, so two ranks never both run nvcc.

Data parallelism (``data > 1``), the training meshes
(``make_production_mesh``) and the router's per-replica meshes
(``make_replica_meshes``) are not ported yet (ROADMAP queue 1, items 6.1
and 6.2).
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

_NOT_YET = "is not ported yet (ROADMAP queue 1, item {})"
# how long spawn_tp waits for the ranks' results
RESULT_TIMEOUT_S = 3600.0


@dataclasses.dataclass
class TPMesh:
    """One rank's view of a ``(data=1, tp)`` serving mesh. ``shape`` and
    ``axis_names`` are the reference mesh's, which the sharding rules
    (``distributed/sharding.py``) read."""
    rank: int
    size: int
    group: Any
    device: torch.device
    backend: Optional[str]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": 1, "tp": self.size}

    @property
    def axis_names(self) -> Tuple[str, str]:
        return ("data", "tp")


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


def make_tp_mesh(tp: int, data: int = 1, device="cuda") -> TPMesh:
    """The calling rank's mesh. ``tp = 1`` works in any process (no group);
    ``tp > 1`` needs the process group that ``spawn_tp`` made."""
    if data != 1:
        raise ValueError(f"a (data={data}, tp={tp}) mesh: data parallelism "
                         + _NOT_YET.format("6.1"))
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    import torch.distributed as dist
    if tp == 1 and not dist.is_initialized():
        return TPMesh(0, 1, None, rank_device(0, device), None)
    if not dist.is_initialized() or dist.get_world_size() != tp:
        raise RuntimeError(
            f"make_tp_mesh({tp}) runs inside a rank of spawn_tp(fn, {tp}, "
            f"...), which makes the process group")
    rank = dist.get_rank()
    return TPMesh(rank, tp, dist.group.WORLD, rank_device(rank, device),
                  dist.get_backend())


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError("the training mesh " + _NOT_YET.format("6.1"))


def make_replica_meshes(n: int, tp: int = 1):
    raise NotImplementedError(f"{n} replica meshes of tp={tp}: per-replica "
                              "meshes " + _NOT_YET.format("6.2"))


def _rank_main(fn: Callable, rank: int, tp: int, init_file: str, device: str,
               backend: str, args: tuple, results) -> None:
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
                                rank=rank, world_size=tp)
        out = fn(make_tp_mesh(tp, device=device), *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_tp(fn: Callable, tp: int, *args, device="cuda",
             every_rank: bool = False, backend: Optional[str] = None,
             timeout_s: float = RESULT_TIMEOUT_S):
    """Run ``fn(mesh, *args)`` on ``tp`` ranks (see the module docstring)
    over ``backend`` (default: ``choose_backend``). Returns rank 0's
    result, or the list of every rank's; raises when a rank fails or the
    ranks have not all returned within ``timeout_s``."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    backend = choose_backend(tp, device, backend)
    if torch.device(device).type == "cuda":
        rank_device(0, device)              # raises without a card
        from repro_torch.kernels import _lib
        _lib.build()
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_tp_")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, tp, os.path.join(tmp, "store"),
                               str(device), backend, args, results))
             for r in range(tp)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    failure = None
    waited = 0.0
    try:
        while len(got) < tp and failure is None:
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
        raise RuntimeError(f"spawn_tp({getattr(fn, '__name__', fn)}, "
                           f"tp={tp}): {failure}")
    return [got[r] for r in range(tp)] if every_rank else got[0]
