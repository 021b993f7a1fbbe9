"""The collectives of tensor-parallel serving over ``torch.distributed``
(the reference's module name, ``repro/distributed/collectives.py``).

The reference leaves its collectives to GSPMD, which inserts them where a
sharded layout meets a replicated one. The port calls them where the model
code needs them: ``psum`` after a row-parallel linear (``wo``, ``w_down``)
and after the vocabulary-sharded embedding, ``pmax`` for the whole weight's
range when a sharded weight is quantized per call, ``gather_last`` for the
vocabulary-sharded logits.

``use_tp(mesh)`` makes a ``launch/mesh.TPMesh`` the active group for the
model calls inside it (the engines enter it around their prefill and decode
calls); with no active mesh, or a mesh of one rank, every collective is a
no-op and returns its input. Every rank gets the same bits: a sum of
integers, a max, and a gather that adds zeros are exact in any order.

The reference's ``compressed_psum`` and ``dp_train_step_compressed`` belong
to data-parallel training, which is not ported yet (ROADMAP queue 1, item
6.1).
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

_ACTIVE = None      # the TPMesh of the model calls in progress, or None


@contextlib.contextmanager
def use_tp(mesh) -> Iterator[None]:
    """Run the model calls inside on ``mesh`` (None: unsharded)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield
    finally:
        _ACTIVE = prev


def active():
    """The active TPMesh, or None."""
    return _ACTIVE


def tp_size() -> int:
    return 1 if _ACTIVE is None else int(_ACTIVE.size)


def tp_rank() -> int:
    return 0 if _ACTIVE is None else int(_ACTIVE.rank)


def _all_reduce(x: torch.Tensor, op) -> torch.Tensor:
    import torch.distributed as dist
    # a fresh contiguous buffer: the reduction runs in place, and gloo takes
    # no 0-dim tensors
    buf = x.reshape(-1).clone()
    dist.all_reduce(buf, op=op, group=_ACTIVE.group)
    return buf.reshape(x.shape)


def psum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (in ``x``'s dtype: callers pass f32
    or int32)."""
    if tp_size() == 1:
        return x
    import torch.distributed as dist
    return _all_reduce(x, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks."""
    if tp_size() == 1:
        return x
    import torch.distributed as dist
    return _all_reduce(x, dist.ReduceOp.MAX)


def gather_last(x: torch.Tensor) -> torch.Tensor:
    """The ranks' slices of the last axis, in rank order: (..., n) per rank
    -> (..., n * tp). Each rank writes its slice into a zero-filled f32
    buffer of the whole width and the buffers are summed: adding zeros is
    exact, and only ``all_reduce`` is needed (gloo takes it on CUDA
    tensors). Returns ``x``'s dtype."""
    tp = tp_size()
    if tp == 1:
        return x
    n = x.shape[-1]
    full = x.new_zeros((*x.shape[:-1], n * tp), dtype=torch.float32)
    r = tp_rank()
    full[..., r * n:(r + 1) * n] = x.float()
    return psum(full).to(x.dtype)


def broadcast_ints(values, mesh=None, src: int = 0) -> list:
    """Rank ``src``'s list of ints on every rank of ``mesh`` (default: the
    active one): the host decisions the ranks must take together
    (admissions, expiries). A no-op at one rank."""
    mesh = _ACTIVE if mesh is None else mesh
    if mesh is None or mesh.size == 1:
        return [int(v) for v in values]
    import torch.distributed as dist
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=mesh.device)
    dist.broadcast(t, src=src, group=mesh.group)
    return [int(v) for v in t.tolist()]


def max_ints(values, mesh=None) -> list:
    """The elementwise max of every rank's list of ints, on every rank of
    ``mesh`` (default: the active one): a flag any rank may raise (drain),
    or rank 0's count where the other ranks pass -1. A no-op at one
    rank."""
    mesh = _ACTIVE if mesh is None else mesh
    if mesh is None or mesh.size == 1:
        return [int(v) for v in values]
    import torch.distributed as dist
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return [int(v) for v in t.tolist()]
