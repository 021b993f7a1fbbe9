"""The collectives of the port over ``torch.distributed`` (the reference's
module name, ``repro/distributed/collectives.py``): over the ``tp`` axis
for tensor-parallel serving and training, over the ``data`` axis for
data-parallel tuning and training.

The reference leaves its collectives to GSPMD, which inserts them where a
sharded layout meets a replicated one, and differentiates through them.
The port calls them where the model code needs them: ``psum`` after a
row-parallel linear (``wo``, ``w_down``) and after the vocabulary-sharded
embedding, ``pmax`` for the whole weight's range when a sharded weight is
quantized per call, ``gather_last`` for the vocabulary-sharded logits;
and, with a data axis active, every reduction over the batch:
``global_sum`` (CE's sum, L_q), ``global_extrema`` (the per-tensor
ranges) and ``global_site_stats`` (the sites' statistics).

``use_tp(mesh)`` makes a ``launch/mesh.TPMesh``'s tp axis, ``use_data(mesh)``
its data axis, the active group for the model calls inside it (the engines
enter ``use_tp`` around their prefill and decode calls,
``train/trainer.shard_update_step`` enters ``use_data``, and ``use_tp``
where the mesh's model axis has more than one rank, around a step).
With no active mesh, or an axis of one rank, every collective is a no-op
and returns its input, and the model code takes the one-rank path. Every
rank gets the same bits: a sum of integers, a max, and a gather that adds
zeros are exact in any order, and an all-reduce hands every rank the one
result.

The gradients over the tp axis (Megatron's rules; the ranks compute the
same loss, and the gradient of a replicated activation is the whole one on
every rank):

* ``psum`` (reduce-from-tp, after a row-parallel site or the cut
  embedding): the sum forward, the identity backward;
* ``copy_to_tp`` (where a replicated activation enters a site whose output
  columns are cut: ``wqkv``, ``w_gate`` / ``w_up``, the head): the
  identity forward, the sum of the ranks' partial gradients backward;
* ``gather_last``: the gather forward, the rank's slice of the gradient
  backward;
* ``tp_extrema`` and ``global_site_stats(..., cut=True)`` (the ranks'
  min and max of a cut activation): the gradient goes to the elements
  equal to the global value, divided by the global count of such elements
  (JAX's ``reduce_max`` rule, and ``torch.amax``'s within one rank).

Under a data axis a reduction's value is the global one on every rank and
its gradient is the rank's share: ``global_sum``'s backward is the
identity, and a global max or min follows the rule above over the axis.
The gradients of replicated leaves summed over the axis
(``sum_over_data``) are then the global loss's.

``compressed_psum`` and ``dp_train_step_compressed`` are the reference's
int8-payload all-reduce mean and its data-parallel gradient step.

On the dry-run mesh (``launch/mesh.DryRunMesh``: one rank's view of a
mesh of any size, no process group) the tensors are on ``meta``: every
all-reduce, the backward's too, calls no ``torch.distributed`` and records
its result's bytes and one ``all-reduce`` in the dry-run's tally
(``launch/cost``), the collective a real rank issues for the same call
(``gather_last`` is an all-reduce of the whole width, as it runs).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator

import torch

_ACTIVE = None      # the TPMesh of the tensor-parallel calls, or None
_DATA = None        # the TPMesh whose data axis is active, or None


@contextlib.contextmanager
def use_tp(mesh) -> Iterator[None]:
    """Run the model calls inside on ``mesh``'s tp axis (None:
    unsharded)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def use_data(mesh) -> Iterator[None]:
    """Run the model calls inside on ``mesh``'s data axis: each rank holds
    its rows of the batch, and every reduction over the batch is global
    (None: one rank's batch)."""
    global _DATA
    prev, _DATA = _DATA, mesh
    try:
        yield
    finally:
        _DATA = prev


def active():
    """The active TPMesh (tp axis), or None."""
    return _ACTIVE


def tp_size() -> int:
    return 1 if _ACTIVE is None else int(_ACTIVE.size)


def tp_rank() -> int:
    return 0 if _ACTIVE is None else int(_ACTIVE.rank)


def data_size() -> int:
    return 1 if _DATA is None else int(_DATA.data_size)


def axis_size(axis: str = "tp") -> int:
    if axis == "data":
        return data_size()
    if axis == "tp":
        return tp_size()
    raise ValueError(f"axis must be 'tp' or 'data', got {axis!r}")


def _group(axis: str):
    return _DATA.data_group if axis == "data" else _ACTIVE.group


def _all_reduce(x: torch.Tensor, op, axis: str = "tp") -> torch.Tensor:
    # a fresh contiguous buffer: the reduction runs in place, and gloo takes
    # no 0-dim tensors
    buf = x.reshape(-1).clone()
    if buf.device.type == "meta":
        from repro_torch.launch import cost
        cost.collective("all-reduce", buf)
    else:
        import torch.distributed as dist
        dist.all_reduce(buf, op=op, group=_group(axis))
    return buf.reshape(x.shape)


def _sum(x: torch.Tensor, axis: str) -> torch.Tensor:
    import torch.distributed as dist
    return _all_reduce(x, dist.ReduceOp.SUM, axis)


class _ReduceFromTP(torch.autograd.Function):
    """The sum over tp; the gradient of each rank's term is the sum's."""

    @staticmethod
    def forward(ctx, x):
        return _sum(x, "tp")

    @staticmethod
    def backward(ctx, g):
        return g


class _CopyToTP(torch.autograd.Function):
    """The identity; the gradient is the sum of the ranks' partials."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, "tp")


def _grad_path(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def psum(x: torch.Tensor, axis: str = "tp") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (in ``x``'s dtype:
    callers pass f32 or int32). Over tp its gradient is the identity
    (reduce-from-tp)."""
    if axis_size(axis) == 1:
        return x
    if axis == "tp" and _grad_path(x):
        return _ReduceFromTP.apply(x)
    return _sum(x, axis)


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """``x``, a replicated activation entering a site whose output columns
    are the rank's part: its gradient, each rank's part of the whole one,
    is summed over tp (copy-to-tp). Without a gradient to take, or at one
    rank, ``x`` itself."""
    if tp_size() == 1 or not _grad_path(x):
        return x
    return _CopyToTP.apply(x)


def pmax(x: torch.Tensor, axis: str = "tp") -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of ``axis`` (no
    gradient: the quantizers' ranges, which they detach)."""
    if axis_size(axis) == 1:
        return x
    import torch.distributed as dist
    return _all_reduce(x, dist.ReduceOp.MAX, axis)


def pmin(x: torch.Tensor, axis: str = "tp") -> torch.Tensor:
    """The elementwise min of ``x`` over the ranks of ``axis``."""
    if axis_size(axis) == 1:
        return x
    import torch.distributed as dist
    return _all_reduce(x, dist.ReduceOp.MIN, axis)


def pmean(x: torch.Tensor, axis: str = "tp") -> torch.Tensor:
    """``psum(x) / n`` over the ranks of ``axis``."""
    n = axis_size(axis)
    return x if n == 1 else psum(x, axis) / n


class _GlobalSum(torch.autograd.Function):
    """The sum over the data axis; the gradient is each rank's share."""

    @staticmethod
    def forward(ctx, x):
        return psum(x, "data")

    @staticmethod
    def backward(ctx, g):
        return g


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """A rank's partial sum summed over the data axis; its gradient flows
    to the rank's own terms (identity), so the gradients summed over the
    axis are the global sum's. ``x`` on one rank."""
    return x if data_size() == 1 else _GlobalSum.apply(x)


def global_extrema(x: torch.Tensor):
    """``(x.amin(), x.amax())`` over the data axis: a per-tensor range,
    which the quantizers detach (one all-reduce: the max of (-min, max));
    on one rank torch's, gradient and all."""
    if data_size() == 1:
        return x.amin(), x.amax()
    with torch.no_grad():
        both = pmax(torch.stack([-x.amin(), x.amax()]), "data")
    return -both[0], both[1]


def _axes(cut: bool):
    """The axes a reduction of an activation spans: data where it is
    active, tp where the activation's last axis is the rank's slice of a
    cut one (``cut``)."""
    return tuple(a for a, on in (("data", data_size() > 1),
                                 ("tp", cut and tp_size() > 1)) if on)


def _psum_axes(x: torch.Tensor, axes) -> torch.Tensor:
    for a in axes:
        x = _sum(x, a)
    return x


class _Extrema(torch.autograd.Function):
    """(min, max) of every element of x over ``axes``: one all-reduce
    forward (the max of (-min, max)) and, for the outputs that carry a
    gradient, one backward (their elements' counts)."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.set_materialize_grads(False)
        # in f32, which holds any bf16 value exactly
        both = torch.stack([-x.amin(), x.amax()]).float()
        for a in axes:
            both = pmax(both, a)
        mn, mx = (-both[0]).to(x.dtype), both[1].to(x.dtype)
        ctx.axes = axes
        ctx.save_for_backward(x, mn, mx)
        return mn, mx

    @staticmethod
    def backward(ctx, g_mn, g_mx):
        x, mn, mx = ctx.saved_tensors
        pairs = [(g, (x == v).to(g.dtype)) for g, v in ((g_mn, mn),
                                                         (g_mx, mx))
                 if g is not None]
        if not pairs:
            return None, None
        counts = _psum_axes(torch.stack([m.sum() for _, m in pairs]),
                            ctx.axes)
        grad = torch.zeros_like(x)
        for i, (g, m) in enumerate(pairs):
            grad = grad + m * (g / counts[i])
        return grad, None


def tp_extrema(x: torch.Tensor):
    """``(x.amin(), x.amax())`` of a cut activation over the tp ranks (and
    the data axis where it is active); on one rank torch's, gradient and
    all (see the module docstring for the gradient)."""
    axes = _axes(True)
    if not axes:
        return x.amin(), x.amax()
    return _Extrema.apply(x, axes)


class _GlobalSiteStats(torch.autograd.Function):
    """(min, max, per-channel max of |x| over every axis but the last) of
    x over the data axis, and the min and max over tp where x's channels
    are the rank's slice of a cut axis (the channel maxima then gathered
    in rank order): one all-reduce forward an axis (the max of (-min, max,
    channel maxima)) and, for the outputs that carry a gradient, one
    backward an axis (their counts; a channel's over the data axis
    only)."""

    @staticmethod
    def forward(ctx, x, cut):
        ctx.set_materialize_grads(False)
        dims = tuple(range(x.dim() - 1))
        local = torch.cat([torch.stack([-x.amin(), x.amax()]),
                           x.abs().amax(dim=dims)])
        if data_size() > 1:
            local = pmax(local, "data")
        mn, mx, ch = -local[0], local[1], local[2:]
        ctx.cut = cut and tp_size() > 1
        ctx.axes = (_axes(ctx.cut), _axes(False))
        if ctx.cut:
            both = pmax(torch.stack([-mn, mx]), "tp")
            mn, mx = -both[0], both[1]
        ctx.save_for_backward(x, mn, mx, ch)
        return mn, mx, (_gather(ch) if ctx.cut else ch)

    @staticmethod
    def backward(ctx, g_mn, g_mx, g_ch):
        x, mn, mx, ch = ctx.saved_tensors
        dims = tuple(range(x.dim() - 1))
        masks, sums = [], []
        for g, m in ((g_mn, x == mn), (g_mx, x == mx)):
            if g is not None:
                masks.append((g, m.to(g.dtype)))
                sums.append(masks[-1][1].sum().reshape(1))
        if masks:
            counts = _psum_axes(torch.cat(sums), ctx.axes[0])
        if g_ch is not None:
            if ctx.cut:
                g_ch = _rank_slice(g_ch, ch.shape[-1])
            m_ch = (x.abs() == ch).to(g_ch.dtype)
            n_ch = _psum_axes(m_ch.sum(dim=dims), ctx.axes[1])
        if not masks and g_ch is None:
            return None, None
        grad = torch.zeros_like(x)
        for i, (g, m) in enumerate(masks):
            grad = grad + m * (g / counts[i])
        if g_ch is not None:
            # through |x|: the sign of x, 0 at 0 (torch's abs rule)
            grad = grad + torch.sign(x) * m_ch * (g_ch / n_ch)
        return grad, None


def global_site_stats(x: torch.Tensor, cut: bool = False):
    """``(x.amin(), x.amax(), x.abs().amax(all axes but the last))`` over
    the data axis and, with ``cut`` (x's last axis is the rank's slice of a
    tensor-parallel cut), over tp, the channel maxima gathered whole (see
    the module docstring for the gradient)."""
    if not _axes(cut):
        return x.amin(), x.amax(), x.abs().amax(dim=tuple(range(
            x.dim() - 1)))
    return _GlobalSiteStats.apply(x, cut)


def sum_over_data(grads: Any) -> Any:
    """The gradients of replicated leaves summed over the active data axis
    (each rank's share of the global loss's gradient -> the global
    gradient), floating leaves in f32, which the optimizer computes in; a
    tree of tensors, as it is with no data axis."""
    if data_size() == 1:
        return grads
    from repro_torch.optim.adamw import tree_map
    return tree_map(lambda g: psum(g.float() if g.is_floating_point()
                                   else g, "data"), grads)


def _compressed_parts(x: torch.Tensor, axis: str):
    """(int32 sum of the codes, the f32 scale, the rank count) of
    ``compressed_psum``."""
    n = axis_size(axis)
    xf = x.float()
    amax = pmax(xf.abs().amax(), axis)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    xq = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return psum(xq.to(torch.int32), axis), scale, n


def compressed_psum(x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """All-reduce mean with an int8 payload and one f32 scale, the
    reference's arithmetic in its order: the max of |x| over the ranks,
    ``scale = max(amax, 1e-12) / 127``, codes ``clip(round(x / scale),
    -127, 127)`` as int8, their int32 sum, ``* scale / n`` in x's dtype
    (on one rank: x through its int8 codes, as the reference's)."""
    acc, scale, n = _compressed_parts(x, axis)
    return (acc.float() * scale / n).to(x.dtype)


def dp_train_step_compressed(grad_fn: Callable, mesh,
                             axis_name: str = "data") -> Callable:
    """Data-parallel gradients with the compressed all-reduce:
    ``grad_fn(params, batch) -> (loss, grads)`` on the rank's rows (params
    replicated); returns ``(params, global_batch) -> (loss mean, grads
    mean)``, the loss ``pmean``'d and every gradient ``compressed_psum``'d
    over the data axis. The batch's leading axis must divide by it."""
    if axis_name != "data":
        raise ValueError(f"the port's data axis is 'data', got "
                         f"{axis_name!r}")
    from repro_torch.optim.adamw import tree_map

    def step(params, batch):
        rows = rank_rows(batch, mesh)
        loss, grads = grad_fn(params, rows)
        with use_data(mesh):
            return (pmean(loss.float().reshape(()), "data").to(loss.dtype),
                    tree_map(lambda g: compressed_psum(g, "data"), grads))
    return step


def rank_rows(batch: Any, mesh) -> Any:
    """This rank's rows of a global batch (dicts of tensors): the leading
    axis split in ``mesh.data_size`` equal parts, in data-rank order (the
    reference's batch sharding over "data")."""
    d, r = int(mesh.data_size), int(mesh.data_rank)
    if d == 1:
        return batch
    if isinstance(batch, dict):
        return {k: rank_rows(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(rank_rows(v, mesh) for v in batch)
    if batch.dim() == 0:
        return batch
    if batch.shape[0] % d:
        raise ValueError(f"a batch of {batch.shape[0]} rows does not split "
                         f"over data={d}")
    n = batch.shape[0] // d
    return batch[r * n:(r + 1) * n]


def _gather(x: torch.Tensor) -> torch.Tensor:
    n, r = x.shape[-1], tp_rank()
    full = x.new_zeros((*x.shape[:-1], n * tp_size()))
    full[..., r * n:(r + 1) * n] = x
    return _sum(full, "tp")


def _rank_slice(g: torch.Tensor, n: int) -> torch.Tensor:
    return g.narrow(-1, tp_rank() * n, n)


class _GatherLast(torch.autograd.Function):
    """The gather; the gradient is the rank's slice of the whole one."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[-1]
        return _gather(x)

    @staticmethod
    def backward(ctx, g):
        return _rank_slice(g, ctx.n)


def gather_last(x: torch.Tensor) -> torch.Tensor:
    """The ranks' slices of the last axis, in rank order: (..., n) per rank
    -> (..., n * tp). Each rank writes its slice into a zero-filled buffer
    of the whole width, in x's dtype, and the buffers are summed: adding
    zeros is exact in any dtype, and only ``all_reduce`` is needed (gloo
    takes it on CUDA tensors, bf16 too). The gradient is the rank's
    slice."""
    if tp_size() == 1:
        return x
    if _grad_path(x):
        return _GatherLast.apply(x)
    return _gather(x)


def broadcast_ints(values, mesh=None, src: int = 0, axis: str = "tp"
                   ) -> list:
    """The list of ints of rank ``src`` of ``mesh``'s ``axis`` (default:
    the active tp mesh) on every rank of the axis: the host decisions the
    ranks must take together (admissions, expiries; a searched prefix). A
    no-op at one rank."""
    mesh = _ACTIVE if mesh is None else mesh
    if mesh is None:
        return [int(v) for v in values]
    base = int(getattr(mesh, "base", 0))
    if axis == "data":
        n, group = int(mesh.data_size), mesh.data_group
        world_src = base + src * int(mesh.size) + int(mesh.rank)
    else:
        n, group = int(mesh.size), mesh.group
        world_src = base + int(mesh.data_rank) * int(mesh.size) + src
    if n == 1:
        return [int(v) for v in values]
    import torch.distributed as dist
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=mesh.device)
    dist.broadcast(t, src=world_src, group=group)
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
