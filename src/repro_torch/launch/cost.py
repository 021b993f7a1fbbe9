"""The dry-run's accounting, the counterpart of ``repro/launch/hlo_cost.py``.

The reference compiles a cell and reads its optimized HLO: the FLOPs of
every dot and convolution, the operand-plus-output bytes of every top-level
instruction, and the result bytes and count of five collective kinds, each
multiplied by the trip counts of the loops around it. The port has no HLO
and no compiler between the model code and the card: its dry-run
(``launch/dryrun.py``) runs one rank's program eagerly on ``meta`` tensors,
which carry shapes and dtypes and no data. So this module counts the ops as
they run, not instructions:

* ``flops``: the matrix products PyTorch runs itself (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, ``_int_mm``, ``convolution``), 2 x the output's
  elements x the contracted length (``_dot_flops`` / ``_conv_flops``'s
  rule), and what each hand-written kernel's wrapper records on meta
  tensors (``kernel``): the FLOPs of the jnp oracle that the reference's
  dry-run lowers in its place (2 M N K for the int matmuls, 4 B H S T hd
  over the whole key range for attention, none for the quantizers).
* ``bytes``: the operand-plus-output bytes of every op that is not a view
  (no fusion: each op's traffic counts), an in-place write counted at the
  size it writes; each kernel's inputs read once and outputs written once
  (PERF.md §6's bound arithmetic).
* ``collective_bytes`` / ``collective_counts``: the result bytes and the
  count of every collective that the dry-run mesh's rank issues
  (``distributed/collectives.py``), by the reference's five kinds.
* ``launches``: one a kernel launch, by the names of ``_lib.LAUNCHES``
  (``FUSED`` included), which the card's counts must equal.
* ``temp``: the peak of the bytes allocated during the run and still live
  (the arguments excluded), each allocation rounded up to 512 bytes as the
  CUDA caching allocator rounds it; the kernels' workspaces are allocated
  on meta where the card allocates them.

The reference multiplies a loop body by its trip count. ``scan`` does so
for the port's loops over positions: under a tally on meta tensors it runs
one step and counts it ``n`` times; elsewhere it is a plain loop.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# the caching allocator's granule
ALLOC_ROUND = 512


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {c: 0 for c in COLLECTIVES})

    def __iadd__(self, o: "Cost"):
        self.flops += o.flops
        self.bytes += o.bytes
        self.collective_bytes += o.collective_bytes
        for c in COLLECTIVES:
            self.collective_counts[c] += o.collective_counts[c]
        return self

    def __sub__(self, o: "Cost") -> "Cost":
        return Cost(self.flops - o.flops, self.bytes - o.bytes,
                    self.collective_bytes - o.collective_bytes,
                    {c: self.collective_counts[c] - o.collective_counts[c]
                     for c in COLLECTIVES})

    def scaled(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k,
                    self.collective_bytes * k,
                    {c: int(self.collective_counts[c] * k)
                     for c in COLLECTIVES})

    def copy(self) -> "Cost":
        return self.scaled(1)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _alloc(n: int) -> int:
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


@dataclasses.dataclass
class Tally:
    """What one dry-run counted: the cost, the kernel launches by name,
    and the live and peak bytes allocated during the run."""
    cost: Cost = dataclasses.field(default_factory=Cost)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    # the FLOPs of integer products (at the card's int8 rate)
    int8_flops: float = 0.0
    live: int = 0
    peak: int = 0
    # storage key -> [allocated bytes, tensors that hold it]
    _held: Dict[int, List[int]] = dataclasses.field(default_factory=dict)

    def launch(self, name: str) -> None:
        self.launches[name] = self.launches.get(name, 0) + 1

    def _hold(self, t: torch.Tensor, fresh: bool) -> None:
        key = storage_key(t)
        entry = self._held.get(key)
        if entry is None:
            if not fresh:
                return              # an argument's storage: not temp
            entry = self._held[key] = [_alloc(
                t.untyped_storage().nbytes()), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key, entry)

    def _release(self, key: int, entry: List[int]) -> None:
        entry[1] -= 1
        if entry[1] == 0 and self._held.get(key) is entry:
            del self._held[key]
            self.live -= entry[0]


_ACTIVE: Optional[Tally] = None


def active() -> Optional[Tally]:
    """The tally of the dry-run in progress, or None."""
    return _ACTIVE


def storage_key(t: torch.Tensor) -> int:
    """What identifies ``t``'s storage while it is alive (views share
    it)."""
    return t.untyped_storage()._cdata


_MM = {"mm", "_int_mm", "addmm", "bmm", "baddbmm"}
# allocations that write nothing
_EMPTY = {"empty", "empty_strided", "empty_like", "new_empty",
          "new_empty_strided"}
# in-place writes of a source of their own size into (part of) the first
# operand: the traffic is the source read and written, not the destination
_SCATTERS = {"copy_", "index_put_", "_index_put_impl_", "index_copy_",
             "scatter_", "masked_scatter_", "slice_scatter"}


def _dot_flops(name: str, args, out: torch.Tensor) -> float:
    """2 x the output's elements x the contracted length."""
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2.0 * out.numel() * a.shape[-1]


def _conv_flops(args, out: torch.Tensor) -> float:
    """2 x the output's elements x the weight's elements per output
    channel (the weight is (out_ch, in_ch / groups, *kernel))."""
    w = args[1]
    return 2.0 * out.numel() * (w.numel() // max(1, w.shape[0]))


class _Counter(TorchDispatchMode):
    """Counts every op on meta tensors that runs while it is active into
    ``tally``."""

    def __init__(self, tally: Tally):
        super().__init__()
        self.tally = tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(t.device.type != "meta" for t in (*ins, *outs)):
            return out              # the dry-run counts meta tensors only
        keys = {storage_key(t) for t in ins}
        fresh = [storage_key(t) not in keys for t in outs]
        cost = self.tally.cost
        if name in _MM and outs:
            f = _dot_flops(name, args, outs[0])
            cost.flops += f
            if name == "_int_mm":
                self.tally.int8_flops += f
        elif name == "convolution" and outs:
            cost.flops += _conv_flops(args, outs[0])
        if name in _EMPTY:
            pass
        elif name in _SCATTERS and ins:
            cost.bytes += 2 * sum(nbytes(t) for t in ins[1:])
        elif any(fresh) or func._schema.is_mutable:
            # an in-place op writes its first operand back
            cost.bytes += sum(nbytes(t) for t in ins) + sum(
                nbytes(t) for t, f in zip(outs, fresh) if f) + (
                nbytes(ins[0]) if ins and not any(fresh) else 0)
        for t, f in zip(outs, fresh):
            self.tally._hold(t, f)
        return out


@contextlib.contextmanager
def counting() -> Iterator[Tally]:
    """Count every op, kernel and collective run inside into a fresh
    ``Tally`` (one at a time)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a dry-run tally is already counting")
    tally = Tally()
    _ACTIVE = tally
    try:
        with _Counter(tally):
            yield tally
    finally:
        _ACTIVE = None


def kernel(name: str, flops: float, reads: Iterable[Any],
           writes: Iterable[Any], fused: Iterable[str] = (),
           extra_bytes: int = 0, int8: bool = False) -> None:
    """One launch of kernel ``name`` on meta tensors: its FLOPs, each
    input read once and each output written once (None entries skipped)
    and ``extra_bytes`` read beside them (a part of an operand), one
    launch, and one of each ``fused`` name (the work done inside the
    launch that ``_lib.FUSED`` counts beside it). ``int8``: the FLOPs are
    an integer product's. Nothing without an active tally."""
    tally = _ACTIVE
    if tally is None:
        return
    tally.cost.flops += float(flops)
    if int8:
        tally.int8_flops += float(flops)
    tally.cost.bytes += extra_bytes + sum(
        nbytes(t) for t in (*reads, *writes) if t is not None)
    tally.launch(name)
    for f in fused:
        tally.launch(f)


def collective(kind: str, result: torch.Tensor) -> None:
    """One collective of ``kind`` (one of ``COLLECTIVES``) whose result is
    ``result``, as the reference counts it: its bytes and one count."""
    if kind not in COLLECTIVES:
        raise ValueError(f"collective kind {kind!r} not in {COLLECTIVES}")
    tally = _ACTIVE
    if tally is None:
        return
    tally.cost.collective_bytes += nbytes(result)
    tally.cost.collective_counts[kind] += 1


def scan(n: int, step: Callable[[int, Any], Any], carry: Any):
    """``for t in range(n): y_t, carry = step(t, carry)``; returns
    (``[y_0, ..., y_{n-1}]``, carry). Under a dry-run tally on meta
    tensors one step runs and its cost and launches count ``n`` times (the
    reference's trip count): the ys are that step's result ``n`` times
    over (meta tensors hold no values)."""
    tally = _ACTIVE
    leaves = [t for t in tree_leaves(carry) if isinstance(t, torch.Tensor)]
    if tally is None or n < 2 or not leaves \
            or leaves[0].device.type != "meta":
        ys = []
        for t in range(n):
            y, carry = step(t, carry)
            ys.append(y)
        return ys, carry
    before, launches = tally.cost.copy(), dict(tally.launches)
    int8 = tally.int8_flops
    y, carry = step(0, carry)
    one = tally.cost - before
    tally.cost += one.scaled(n - 1)
    tally.int8_flops += (tally.int8_flops - int8) * (n - 1)
    for k, v in tally.launches.items():
        tally.launches[k] = v + (v - launches.get(k, 0)) * (n - 1)
    return [y] * n, carry
