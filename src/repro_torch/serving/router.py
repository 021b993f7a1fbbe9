"""Fault-tolerant multi-replica serving router, ported from
``repro/serving/router.py`` with the same policy, line for line.

``ReplicaRouter`` fronts N data-parallel ``ContinuousEngine`` replicas on
the API's device and owns everything the single-engine scheduler
deliberately does not:

* **Least-loaded dispatch.** A single bounded admission queue feeds
  replicas as slots free up; among candidates with capacity, HEALTHY
  replicas are preferred over DEGRADED ones, then the fewest live and
  prefilling slots, then the lowest index. DEAD replicas are never
  dispatched.
* **Health tracking.** Each replica carries a
  ``distributed.fault_tolerance.HealthTracker``: heartbeat age,
  consecutive-error count and straggler detection fold into
  HEALTHY / DEGRADED / DEAD. A crash (``InjectedFault`` or any engine
  exception classified as fatal) marks the replica DEAD immediately; a
  corrupted heartbeat gets there via heartbeat-age timeout.
* **Backpressure.** The admission queue is bounded: when arrivals outrun
  the slot pools, new submissions get an explicit ``Rejected("queue_full")``
  instead of unbounded buffering. Deadline expiry is rejected from the
  queue (``deadline-queued``), cancels the live slot
  (``deadline-decoding``), or, for a chunked stream, is retired by the
  engine between chunks (``deadline-prefill``).
* **Retry with capped exponential backoff.** A request on a dying replica
  is failed over: canceled on the dead engine, re-enqueued with
  ``backoff_base_s * 2**(attempts-1)`` (capped) and re-admitted on a
  survivor, from scratch. The cushion prefix KV is the same fp block on
  every replica and a greedy row decodes independently of the rest of its
  pool (``none``, ``pt_static``, ``ptoken_dynamic``; not ``pt_dynamic``,
  whose per-tensor range spans the batch), so a retried request gives the
  tokens of the no-fault run.
* **Graceful drain.** ``KeyboardInterrupt`` (ctrl-C, or the launcher's
  SIGTERM handler) stops admission: queued and unarrived requests are
  rejected with reason ``draining``, every live slot finishes, and the
  completed outputs come back with ``stats.drained`` set.
* **AllReplicasDead.** When every replica is DEAD and non-rejected work
  remains, the router raises instead of spinning forever.

Fault injection: pass a ``distributed.fault_injection.FaultInjector`` to
``run`` and the router fires the sites ``replica{i}.step`` /
``replica{i}.admit`` around every unit of replica work; the schedules count
visits, not seconds, so failure-path runs compare token streams.

Single-threaded: replicas are stepped round-robin in one host loop, which
keeps the chaos schedules reproducible and the failover logic free of
locking. On one card the replicas' decode graphs replay one after another
on the same device, and they share one fault domain: a device fault (an
illegal address, a sticky CUDA error) fails every replica, and the router
ends in ``AllReplicasDead``. The weights are shared: the quantization plan
runs once and every engine serves the same parameter tensors; each replica
owns its slot pool, its captured decode graph and its kernels' per-stream
workspaces.

Differences from the reference: no per-replica device meshes (the
reference's ``meshes``, tensor-parallel replicas, are ROADMAP queue 1
item 6.2 and raise here); every replica lives on ``api.device``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import QuantConfig
from repro_torch.distributed.fault_injection import (FaultInjector,
                                                     InjectedFault)
from repro_torch.distributed.fault_tolerance import (DEAD, DEGRADED,
                                                     HEALTHY, HealthTracker)
from repro_torch.models.registry import ModelAPI
from repro_torch.monitoring import RouterStats, ServeStats
from repro_torch.serving.engine import plan_quantization
from repro_torch.serving.scheduler import ContinuousEngine, Request


class AllReplicasDead(RuntimeError):
    """Every replica is DEAD while non-rejected requests remain."""


@dataclasses.dataclass
class RouterConfig:
    """Router policy knobs (see module docstring for semantics)."""
    max_queue: int = 64             # bounded admission queue (new submits)
    max_retries: int = 2            # extra attempts after the first
    backoff_base_s: float = 0.02    # retry backoff: base * 2**(attempts-1)
    backoff_cap_s: float = 0.5
    heartbeat_timeout_s: float = 30.0
    dead_after_errors: int = 3      # consecutive errors -> DEAD
    straggler_factor: float = 3.0
    straggler_history: int = 8      # steps before the detector arms


@dataclasses.dataclass
class Rejected:
    """Explicit non-service outcome: backpressure (``queue_full``),
    deadline expiry (``deadline-queued`` / ``deadline-decoding``), retry
    exhaustion (``retries_exhausted``), shutdown (``draining``) or an
    invalid request (``invalid``)."""
    uid: int
    reason: str


@dataclasses.dataclass
class RoutedOutput:
    """A completed request as the router saw it: the engine's tokens and
    latency split plus which replica served it and how many admission
    attempts (1 = no retry) it took."""
    uid: int
    tokens: np.ndarray
    ttft_ms: float
    tpot_ms: float
    replica: int
    slot: int
    attempts: int
    latency_s: float
    finished_s: float


@dataclasses.dataclass
class RouterResult:
    outputs: List[RoutedOutput]     # uid-sorted completed requests
    rejected: List[Rejected]
    stats: RouterStats


@dataclasses.dataclass
class _QEntry:
    req: Request
    attempts: int = 0               # admissions attempted so far
    not_before: float = 0.0         # backoff gate (router clock)


class _Replica:
    def __init__(self, idx: int, engine: ContinuousEngine,
                 cfg: RouterConfig):
        self.idx = idx
        self.engine = engine
        self.cfg = cfg
        self.reset()

    def reset(self) -> None:
        """Fresh health state for a new serving session (``run`` resets
        every replica, so a replica killed in one trace replay serves the
        next — each run models an independent deployment)."""
        self.health = HealthTracker(
            heartbeat_timeout_s=self.cfg.heartbeat_timeout_s,
            dead_after_errors=self.cfg.dead_after_errors,
            straggler_factor=self.cfg.straggler_factor,
            min_history=self.cfg.straggler_history)
        self.heartbeat_suppressed = False   # chaos: corrupted heartbeat
        self.dead_handled = False           # failover ran for this death

    def state(self, now: float) -> str:
        return self.health.state(now)


class ReplicaRouter:
    """Multi-replica front-end over ``ContinuousEngine`` (see module
    docstring). Engine construction kwargs (``n_slots``, ``max_seq``,
    ``cushion``, ``kv_dtype``, ...) pass through; the quantization plan
    (``plan_quantization``) runs ONCE here, so every replica serves the
    same calibrated scales and the same (optionally prequantized) weight
    tensors: N replicas hold one copy of the weights.

    ``meshes``: per-replica device meshes are not ported (tensor-parallel
    replicas, ROADMAP queue 1 item 6.2); anything but ``None`` raises. Every
    replica is built on ``api.device``, and on the card each captures its
    decode step at construction, so ``run`` builds and captures nothing.

    ``paged=True`` (with ``page_size``/``n_pages``/``prefix_cache``) rides
    through like any engine kwarg: replicas share the quantization plan but
    each owns its page pool, page table and prefix-cache registry. Page
    exhaustion in one replica backpressures like a full slot pool and the
    router retries elsewhere, while an over-capacity request raises at
    admission and is rejected as invalid (``positions_exhausted``)."""

    def __init__(self, api: ModelAPI, params, qcfg: QuantConfig,
                 n_replicas: int = 2, cfg: Optional[RouterConfig] = None,
                 stats: Optional[RouterStats] = None,
                 meshes: Optional[Sequence[Any]] = None,
                 cushion=None, scales=None, calib_batches=None,
                 prequant: bool = False, weight_bits: int = 8,
                 **engine_kwargs):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if meshes is not None:
            raise NotImplementedError(
                "per-replica device meshes (tensor-parallel replicas) are "
                "not ported yet: ROADMAP queue 1 item 6.2")
        self.cfg = cfg if cfg is not None else RouterConfig()
        self.stats = stats if stats is not None else RouterStats()
        # one shared plan: calibrate/prequantize once, replicate everywhere
        params, scales = plan_quantization(
            api, params, qcfg, cushion=cushion, scales=scales,
            calib_batches=calib_batches, prequant=prequant,
            weight_bits=weight_bits)
        self.replicas = [
            _Replica(i, ContinuousEngine(
                api, params, qcfg, cushion=cushion, scales=scales,
                stats=ServeStats(), **engine_kwargs), self.cfg)
            for i in range(n_replicas)]
        self._queue: collections.deque = collections.deque()
        self._inflight: Dict[int, Tuple[_QEntry, _Replica]] = {}
        self._draining = False
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------------
    # Clock / bookkeeping helpers
    # ------------------------------------------------------------------

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def states(self, now: Optional[float] = None) -> List[str]:
        now = self.now() if now is None else now
        return [r.state(now) for r in self.replicas]

    def _all_dead(self, now: float) -> bool:
        return all(r.state(now) == DEAD for r in self.replicas)

    def _snapshot_stats(self, now: float) -> None:
        self.stats.n_replicas = len(self.replicas)
        self.stats.per_replica = [
            {"replica": r.idx, "state": r.state(now),
             "consecutive_errors": r.health.consecutive_errors,
             "heartbeat_age_s": r.health.heartbeat_age(now),
             "stragglers": len(r.health.stragglers),
             **r.engine.stats.as_dict()}
            for r in self.replicas]

    # ------------------------------------------------------------------
    # Admission queue (bounded; backpressure)
    # ------------------------------------------------------------------

    def submit(self, req: Request, now: Optional[float] = None
               ) -> Optional[Rejected]:
        """Accept ``req`` into the bounded admission queue, or return an
        explicit ``Rejected`` (queue full / draining / already past its
        deadline). The bound applies to *new* submissions only — failover
        requeues always fit, so a replica death never drops work that was
        already accepted."""
        now = self.now() if now is None else now
        if self._draining:
            return self._reject(req.uid, "draining")
        if req.deadline_s is not None and now > req.deadline_s:
            return self._reject(req.uid, "deadline-queued")
        if len(self._queue) >= self.cfg.max_queue:
            return self._reject(req.uid, "queue_full")
        self._queue.append(_QEntry(req=req))
        self.stats.submitted += 1
        self.stats.queue_depth_peak = max(self.stats.queue_depth_peak,
                                          len(self._queue))
        return None

    def _reject(self, uid: int, reason: str) -> Rejected:
        self.stats.reject(reason)
        return Rejected(uid=uid, reason=reason)

    def _requeue(self, entry: _QEntry, now: float) -> Optional[Rejected]:
        """Re-enqueue after a failed attempt, with capped exponential
        backoff; rejects once the retry budget is exhausted."""
        if entry.attempts > self.cfg.max_retries:
            return self._reject(entry.req.uid, "retries_exhausted")
        self.stats.retries += 1
        entry.not_before = now + min(
            self.cfg.backoff_cap_s,
            self.cfg.backoff_base_s * 2 ** max(0, entry.attempts - 1))
        self._queue.append(entry)
        self.stats.queue_depth_peak = max(self.stats.queue_depth_peak,
                                          len(self._queue))
        return None

    # ------------------------------------------------------------------
    # Replica lifecycle
    # ------------------------------------------------------------------

    def _kill_replica(self, rep: _Replica, now: float, reason: str,
                      rejected: List[Rejected],
                      outputs: Dict[int, RoutedOutput]) -> None:
        """Terminal transition: mark DEAD, harvest results it already
        finished, fail its live requests over to the queue."""
        if rep.dead_handled:
            return
        rep.health.mark_dead(reason)
        rep.dead_handled = True
        self.stats.replica_deaths += 1
        self._collect_replica(rep, now, outputs)    # finished work is valid
        self._harvest_expired(rep, rejected)        # so are its expirations
        for req in list(rep.engine.live_requests()):
            entry, _ = self._inflight.pop(req.uid, (None, None))
            rep.engine.cancel(req.uid)
            if entry is None:       # defensive: untracked live request
                entry = _QEntry(req=req, attempts=1)
            self.stats.failovers += 1
            rej = self._requeue(entry, now)
            if rej is not None:
                rejected.append(rej)

    def _pick_replica(self, now: float) -> Optional[_Replica]:
        """Least-loaded dispatch: HEALTHY replicas with a free slot first,
        DEGRADED only when no healthy peer has capacity, DEAD never."""
        ranked: List[Tuple[int, int, int, _Replica]] = []
        for rep in self.replicas:
            st = rep.state(now)
            if st == DEAD or not rep.engine.free_slots():
                continue
            ranked.append((0 if st == HEALTHY else 1,
                           rep.engine.live_count + rep.engine.prefilling,
                           rep.idx, rep))
        return min(ranked)[3] if ranked else None

    # ------------------------------------------------------------------
    # Event-loop stages
    # ------------------------------------------------------------------

    def _dispatch(self, now: float, injector: Optional[FaultInjector],
                  rejected: List[Rejected],
                  outputs: Dict[int, RoutedOutput]) -> None:
        i = 0
        while i < len(self._queue):
            entry = self._queue[i]
            if (entry.req.deadline_s is not None
                    and now > entry.req.deadline_s):
                del self._queue[i]
                rejected.append(self._reject(entry.req.uid,
                                             "deadline-queued"))
                continue
            if entry.not_before > now:      # backing off; try later ones
                i += 1
                continue
            rep = self._pick_replica(now)
            if rep is None:                 # no capacity anywhere
                break
            del self._queue[i]
            self._admit_on(rep, entry, now, injector, rejected, outputs)

    def _admit_on(self, rep: _Replica, entry: _QEntry, now: float,
                  injector: Optional[FaultInjector],
                  rejected: List[Rejected],
                  outputs: Dict[int, RoutedOutput]) -> None:
        entry.attempts += 1
        try:
            if injector is not None:
                for act in injector.fire(f"replica{rep.idx}.admit"):
                    if act == "heartbeat":
                        rep.heartbeat_suppressed = True
            ok = rep.engine.try_admit(entry.req)
        except KeyboardInterrupt:
            raise
        except InjectedFault as e:
            self._kill_replica(rep, now, str(e), rejected, outputs)
            rej = self._requeue(entry, now)
            if rej is not None:
                rejected.append(rej)
            return
        except ValueError as e:
            # request-shaped failure (e.g. needs more positions than the
            # pool holds) — retrying elsewhere cannot help
            rejected.append(self._reject(entry.req.uid, f"invalid: {e}"))
            return
        except Exception as e:  # noqa: BLE001 — replica-side failure
            rep.health.record_error(now)
            rej = self._requeue(entry, now)
            if rej is not None:
                rejected.append(rej)
            return
        if not ok:                          # raced out of the free slot
            entry.attempts -= 1
            self._queue.appendleft(entry)
            return
        self._inflight[entry.req.uid] = (entry, rep)

    def _step_replica(self, rep: _Replica, now: float,
                      injector: Optional[FaultInjector],
                      rejected: List[Rejected],
                      outputs: Dict[int, RoutedOutput]) -> None:
        t0 = time.perf_counter()
        try:
            if injector is not None:
                for act in injector.fire(f"replica{rep.idx}.step"):
                    if act == "heartbeat":
                        rep.heartbeat_suppressed = True
            rep.engine.step()
        except KeyboardInterrupt:
            raise
        except InjectedFault as e:
            self._kill_replica(rep, now, str(e), rejected, outputs)
            return
        except Exception as e:  # noqa: BLE001 — decode-step failure
            rep.health.record_error(now)
            if rep.state(now) == DEAD:
                self._kill_replica(rep, now, f"step failed: {e}",
                                   rejected, outputs)
            return
        dt = time.perf_counter() - t0
        rep.health.record_step(dt, now + dt,
                               beat=not rep.heartbeat_suppressed)

    def _expire_live(self, now: float, rejected: List[Rejected]) -> None:
        """Cancel live requests whose deadline passed mid-decode.
        PREFILLING streams are left alone: the engine enforces their
        deadline between chunks itself, and ``_harvest_expired`` maps those
        to ``deadline-prefill`` so the rejection reason says which phase
        blew the budget."""
        for uid in list(self._inflight):
            entry, rep = self._inflight[uid]
            if (entry.req.deadline_s is not None
                    and now > entry.req.deadline_s):
                if rep.engine.is_prefilling(uid):
                    continue
                if rep.engine.cancel(uid):      # still decoding: cut it
                    del self._inflight[uid]
                    rejected.append(self._reject(uid, "deadline-decoding"))
                # else: already finished, result collected normally

    def _harvest_expired(self, rep: _Replica,
                         rejected: List[Rejected]) -> None:
        """Collect uids the engine retired *between prefill chunks* for
        blowing their deadline (chunked admission). No result exists;
        clearing the inflight entry here is what lets ``run()`` terminate."""
        for uid in rep.engine.pop_expired():
            self._inflight.pop(uid, None)
            rejected.append(self._reject(uid, "deadline-prefill"))

    def _collect_replica(self, rep: _Replica, now: float,
                         outputs: Dict[int, RoutedOutput]) -> None:
        for o in rep.engine.pop_finished():
            entry, _ = self._inflight.pop(o.uid, (None, None))
            attempts = entry.attempts if entry is not None else 1
            arrival = entry.req.arrival_s if entry is not None else 0.0
            outputs[o.uid] = RoutedOutput(
                uid=o.uid, tokens=o.tokens, ttft_ms=o.ttft_ms,
                tpot_ms=o.tpot_ms, replica=rep.idx, slot=o.slot,
                attempts=attempts, latency_s=now - arrival, finished_s=now)
            self.stats.completed += 1

    def _live_total(self) -> int:
        return sum(r.engine.live_count for r in self.replicas)

    # ------------------------------------------------------------------
    # Trace replay
    # ------------------------------------------------------------------

    def run(self, requests: Sequence[Request],
            injector: Optional[FaultInjector] = None) -> RouterResult:
        """Replay a trace through the replica set. Returns every completed
        output (uid-sorted), the explicit rejections, and the router
        counters with per-replica health/occupancy snapshots. Raises
        ``AllReplicasDead`` when no replica survives while non-rejected
        work remains. ``KeyboardInterrupt`` drains gracefully (see module
        docstring). Every replica's ``start()`` (a pool reset: the card's
        graphs were captured at construction) runs before the router clock
        starts, so no heartbeat ages during it."""
        self.stats.reset()
        self._queue.clear()
        self._inflight.clear()
        self._draining = False
        for rep in self.replicas:
            rep.reset()
            rep.engine.start()
        self._t0 = time.perf_counter()
        pending = collections.deque(
            sorted(requests, key=lambda r: (r.arrival_s, r.uid)))
        outputs: Dict[int, RoutedOutput] = {}
        rejected: List[Rejected] = []

        while pending or self._queue or self._inflight:
            try:
                now = self.now()
                if self._draining:
                    while pending:
                        rejected.append(self._reject(
                            pending.popleft().uid, "draining"))
                    while self._queue:
                        rejected.append(self._reject(
                            self._queue.popleft().req.uid, "draining"))
                else:
                    while pending and pending[0].arrival_s <= now:
                        rej = self.submit(pending.popleft(), now)
                        if rej is not None:
                            rejected.append(rej)
                    self._dispatch(now, injector, rejected, outputs)
                if self._all_dead(now):
                    if self._queue or pending or self._inflight:
                        self._snapshot_stats(now)
                        raise AllReplicasDead(
                            f"all {len(self.replicas)} replicas DEAD with "
                            f"{len(self._queue) + len(pending) + len(self._inflight)} "
                            f"request(s) outstanding")
                    break
                stepped = False
                for rep in self.replicas:
                    if rep.state(now) == DEAD:
                        # health-driven death (heartbeat timeout, error
                        # budget): run failover once
                        self._kill_replica(rep, now, rep.health.dead_reason
                                           or "health: " + rep.state(now),
                                           rejected, outputs)
                        continue
                    if rep.engine.live_count == 0 \
                            and rep.engine.prefilling == 0:
                        continue
                    self._step_replica(rep, now, injector, rejected, outputs)
                    stepped = True
                now = self.now()
                self._expire_live(now, rejected)
                for rep in self.replicas:
                    self._harvest_expired(rep, rejected)
                    self._collect_replica(rep, now, outputs)
                if not stepped and (pending or self._queue):
                    # idle: wait out backoff gates / future arrivals
                    time.sleep(1e-3)
            except KeyboardInterrupt:
                if self._draining:
                    raise               # second interrupt: stop for real
                self._draining = True
                self.stats.drained = True

        self._snapshot_stats(self.now())
        return RouterResult(
            outputs=[outputs[u] for u in sorted(outputs)],
            rejected=rejected, stats=self.stats)
