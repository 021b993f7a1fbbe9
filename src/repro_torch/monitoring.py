"""Counters (``repro/monitoring.py``): ``resident_weight_bytes``, the
continuous scheduler's ``ServeStats``, the replica router's
``RouterStats``, and the host-sync accounting of the prefix-tuning loop
(``host_sync``, ``count_host_syncs``)."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Tuple

import torch


def _leaves(tree: Any, path=()):
    """(path, tensor) of every leaf under dicts and lists; any other node
    raises, so no weight goes uncounted."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif isinstance(tree, torch.Tensor):
        yield path, tree
    else:
        raise TypeError(f"cannot count the bytes of a "
                        f"{type(tree).__name__} at {path!r}")


def resident_weight_bytes(params: Any) -> Tuple[int, int, int]:
    """(fp_bytes, int8_bytes, int4_bytes) of a served parameter tree: int8
    ``w_int`` leaves stream 1 byte per weight, nibble-packed ``w_packed``
    leaves 0.5; everything else (embeddings, norms, scales, the MoE
    experts, which stay fp under prequantization) counts as fp.
    ``w_scale`` keeps the weight's dtype, as in the reference, so the three
    counts equal the reference's."""
    if hasattr(params, "tree"):
        params = params.tree()
    fp = i8 = i4 = 0
    for path, leaf in _leaves(params):
        n = leaf.numel() * leaf.element_size()
        if path and path[-1] == "w_packed":
            i4 += n
        elif leaf.dtype == torch.int8:
            i8 += n
        else:
            fp += n
    return fp, i8, i4


@dataclasses.dataclass
class ServeStats:
    """Continuous-batching scheduler counters (serving/scheduler.py).

    ``steps`` counts lock-step decode iterations over the slot pool;
    ``live_slot_steps`` accumulates how many slots held a live request at
    each step, so ``occupancy()`` is the mean fraction of decode compute
    spent on real tokens (retired or empty slots still run, compute-masked).

    ``weight_bytes_*`` (``resident_weight_bytes``), ``pool_bytes`` and
    ``pages_total`` are facts of the engine's load and pool layout, kept
    across ``reset()``. ``canceled`` counts live slots freed without a
    result; ``interrupted`` records a graceful drain (ctrl-C / SIGTERM).

    Page-pool gauges (zero on contiguous pools): ``pages_free`` /
    ``pages_shared`` / ``cushion_page_refs`` mirror the allocator after
    every admission and retirement (shared = refcount > 1; cushion refs =
    the pool's pinned reference + one per live slot). ``prefix_hits`` /
    ``prefix_misses`` count prefix-cache lookups at admission,
    ``positions_exhausted`` requests rejected because prompt + budget
    exceeds the pool, ``page_table_syncs`` host-to-device table copies."""
    n_slots: int = 0
    steps: int = 0              # lock-step decode iterations
    live_slot_steps: int = 0    # sum over steps of live slots that step
    admitted: int = 0           # requests prefilled into a slot
    finished: int = 0           # requests retired (EOS or budget)
    recycles: int = 0           # admissions into a previously-used slot
    canceled: int = 0           # live slots freed without a result
    interrupted: bool = False   # run ended by graceful drain
    weight_bytes_fp: int = 0    # resident fp param bytes (engine load)
    weight_bytes_int8: int = 0  # resident int8 (prequantized) param bytes
    weight_bytes_int4: int = 0  # resident int4-packed param bytes (W4A8)
    pool_bytes: int = 0         # KV pool bytes (pages or dense rows)
    pages_total: int = 0        # page count incl. the reserved scratch page
    pages_free: int = 0         # allocator free-list size
    pages_shared: int = 0       # pages with refcount > 1 (prefix sharing)
    cushion_page_refs: int = 0  # shared cushion block: pool pin + live slots
    prefix_hits: int = 0        # admissions that mapped cached stem pages
    prefix_misses: int = 0      # eligible admissions with no cached stem
    positions_exhausted: int = 0  # requests rejected: prompt+budget > pool
    prefill_chunks: int = 0     # chunked-admission prefill chunks run
    deadline_prefill: int = 0   # streams aborted between chunks (deadline)
    page_table_syncs: int = 0   # host->device page-table mirrors (paged)

    def reset(self) -> None:
        """Zero every per-run counter, keeping ``n_slots``, the resident
        weight bytes and the pool layout facts (``pool_bytes``,
        ``pages_total``)."""
        self.steps = self.live_slot_steps = 0
        self.admitted = self.finished = self.recycles = self.canceled = 0
        self.interrupted = False
        self.pages_free = self.pages_shared = self.cushion_page_refs = 0
        self.prefix_hits = self.prefix_misses = 0
        self.positions_exhausted = 0
        self.prefill_chunks = self.deadline_prefill = 0
        self.page_table_syncs = 0

    def occupancy(self) -> float:
        return self.live_slot_steps / max(1, self.steps * self.n_slots)

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self), "occupancy": self.occupancy()}


@dataclasses.dataclass
class RouterStats:
    """Replica-router counters (serving/router.py).

    ``retries`` counts re-enqueues of a request after a failed attempt
    (admission error, replica crash); ``failovers`` counts requests moved
    off a dying replica specifically. ``rejections`` buckets explicit
    backpressure/deadline rejections by reason string. ``queue_depth_peak``
    is the high-water mark of the bounded admission queue — the
    backpressure signal. ``per_replica`` snapshots each replica's
    ``ServeStats`` (and health state) at collection time."""
    n_replicas: int = 0
    submitted: int = 0          # requests accepted into the admission queue
    completed: int = 0          # requests finished with a result
    retries: int = 0            # re-enqueues after a failed attempt
    failovers: int = 0          # live requests moved off a dying replica
    replica_deaths: int = 0     # replicas transitioned to DEAD
    queue_depth_peak: int = 0   # admission-queue high-water mark
    drained: bool = False       # run ended via graceful drain
    rejections: Dict[str, int] = dataclasses.field(default_factory=dict)
    per_replica: List[dict] = dataclasses.field(default_factory=list)

    def reject(self, reason: str) -> None:
        self.rejections[reason] = self.rejections.get(reason, 0) + 1

    @property
    def rejected(self) -> int:
        return sum(self.rejections.values())

    def reset(self) -> None:
        self.submitted = self.completed = 0
        self.retries = self.failovers = self.replica_deaths = 0
        self.queue_depth_peak = 0
        self.drained = False
        self.rejections = {}
        self.per_replica = []

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self), "rejected": self.rejected}


@dataclasses.dataclass
class HostSyncCounter:
    count: int = 0


_sync_active: List[HostSyncCounter] = []


@contextlib.contextmanager
def count_host_syncs() -> Iterator[HostSyncCounter]:
    """Count the blocking device-to-host transfers made through
    ``host_sync`` inside the ``with`` block. Accounting works by
    convention: host-loop code that must wait for device values (the
    prefix-tuning metric drain) fetches them through ``host_sync``, and
    tests bound the count. Counters nest."""
    c = HostSyncCounter()
    _sync_active.append(c)
    try:
        yield c
    finally:
        _sync_active.remove(c)


def host_sync(tree: Any) -> Any:
    """One blocking device-to-host transfer of every tensor leaf of a tree
    of dicts, lists and tuples: the leaves are flattened, cast to float64
    (exact for f32 and int32 values) and stacked into one tensor, which
    crosses with one ``.cpu()``; the tree comes back with each leaf a
    float64 numpy array of its shape."""
    for c in _sync_active:
        c.count += 1
    leaves: List[torch.Tensor] = []

    def collect(t):
        if isinstance(t, dict):
            for v in t.values():
                collect(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                collect(v)
        elif isinstance(t, torch.Tensor):
            leaves.append(t)
    collect(tree)
    if not leaves:
        return tree
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in leaves]).cpu().numpy()
    pos = [0]

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        if isinstance(t, torch.Tensor):
            n = t.numel()
            a = flat[pos[0]:pos[0] + n].reshape(tuple(t.shape))
            pos[0] += n
            return a
        return t
    return rebuild(tree)
