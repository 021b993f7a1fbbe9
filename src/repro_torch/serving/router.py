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

Tensor-parallel replicas (``meshes``, the reference's per-replica
meshes; ``launch/mesh.make_replica_meshes`` inside a ``spawn_mesh(fn,
data=N, tp=T)``): every world rank runs the same router loop and builds
only its own replica's ``ContinuousEngine(mesh=row)``; another replica is
a handle (``_WorldEngine``) whose state comes from that replica's first
rank. The decisions are one router's: world rank 0 takes every decision
that reads the clock or the fault injector (arrivals, dispatch, deadlines,
heartbeat ages, fault firings) and broadcasts it as small int tensors over
the world group; each call into a replica (an admission, a cancel, a
session start) runs on that replica's ranks and its result and the
engine's state after it are broadcast; a round of decode steps runs on
every replica at once, and its outcomes (tokens emitted, slots freed,
expiries, the step's time) are exchanged. So ``RouterStats``, health
states and failovers are the same on every rank. A crash injected at
``replica{i}.step`` kills replica i on all of its ranks at the same
visit; they stop engine work but stay in the world's collectives until
the run ends. The world group is one fault domain, as one card is: a real
(non-injected) exception on one rank ends the spawn with its traceback
(``spawn_mesh``), and ctrl-C on any rank drains every rank (read at the
top of the loop, where no collective is open). Every rank calls ``run``
with the same trace; rank 0's clock and injector decide.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.distributed import collectives as DC
from repro_torch.distributed.fault_injection import (FaultInjector,
                                                     InjectedFault)
from repro_torch.distributed.fault_tolerance import (DEAD, DEGRADED,
                                                     HEALTHY, HealthTracker)
from repro_torch.models.registry import ModelAPI
from repro_torch.monitoring import RouterStats, ServeStats
from repro_torch.serving.engine import plan_quantization
from repro_torch.serving.scheduler import (ContinuousEngine, Request,
                                           _DeferredInterrupts)


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


class _WorldEngine:
    """Replica ``idx``'s engine as every world rank sees it, with the
    router's view of a ``ContinuousEngine`` (slots, live and prefilling
    requests, finished outputs, expiries, stats). Its own ranks hold the
    engine (``engine``), every other rank None. ``call(fn)`` is a
    collective of the whole world, made in the same order on every rank:
    the replica's ranks run ``fn(engine)``, and its first rank broadcasts
    the result with the engine's state after it, which every rank keeps.
    Outputs and expiries are drained into the handle as they appear, so
    ``pop_finished`` / ``pop_expired`` read the same lists everywhere."""

    def __init__(self, idx: int, engine: Optional[ContinuousEngine],
                 leader: int, world_rank: int,
                 requests: Dict[int, Request]):
        self.idx = idx
        self.engine = engine
        self.leader = leader
        self.is_leader = world_rank == leader
        self._requests = requests
        self._finished: List[Any] = []
        self._expired: List[int] = []
        self._free: List[int] = []
        self._live: List[int] = []
        self._streams: List[int] = []
        self.live_count = 0
        self.stats: Optional[ServeStats] = None
        self.call(lambda e: None)       # every rank learns the state

    def snapshot(self) -> dict:
        """The engine's state as the router reads it (drains its outputs
        and expiries)."""
        e = self.engine
        return dict(free=e.free_slots(),
                    live=[r.uid for r in e.live_requests()],
                    streams=[st.req.uid for st in e._streams],
                    live_count=e.live_count, finished=e.pop_finished(),
                    expired=e.pop_expired(), stats=e.stats)

    def apply(self, snap: dict) -> None:
        self._free, self._live = snap["free"], snap["live"]
        self._streams, self.live_count = snap["streams"], snap["live_count"]
        self._finished += snap["finished"]
        self._expired += snap["expired"]
        self.stats = snap["stats"]

    def call(self, fn: Callable[[ContinuousEngine], Any]) -> Any:
        import torch.distributed as dist
        box = [None]
        if self.engine is not None:
            out = fn(self.engine)
            box[0] = (out, self.snapshot())
        dist.broadcast_object_list(box, src=self.leader)
        out, snap = box[0]
        self.apply(snap)
        return out

    # the router's view ------------------------------------------------
    def free_slots(self) -> List[int]:
        return list(self._free)

    @property
    def prefilling(self) -> int:
        return len(self._streams)

    def is_prefilling(self, uid: int) -> bool:
        return uid in self._streams

    def live_requests(self) -> List[Request]:
        return [self._requests[u] for u in self._live]

    def pop_finished(self) -> list:
        out, self._finished = self._finished, []
        return sorted(out, key=lambda o: o.uid)

    def pop_expired(self) -> List[int]:
        out, self._expired = self._expired, []
        return out

    def start(self) -> None:
        self._finished, self._expired = [], []
        self.call(lambda e: e.start())

    def cancel(self, uid: int) -> bool:
        return self.call(lambda e: e.cancel(uid))

    def try_admit(self, req: Request, stall_s: float = 0.0) -> bool:
        """The engine's ``try_admit`` on the replica's ranks; a ValueError
        there (a request that can never fit) is raised on every rank."""
        def admit(e):
            if stall_s:
                time.sleep(stall_s)
            try:
                return ("ok", e.try_admit(req))
            except ValueError as err:
                return ("invalid", str(err))
        kind, out = self.call(admit)
        if kind == "invalid":
            raise ValueError(out)
        return out


class ReplicaRouter:
    """Multi-replica front-end over ``ContinuousEngine`` (see module
    docstring). Engine construction kwargs (``n_slots``, ``max_seq``,
    ``cushion``, ``kv_dtype``, ...) pass through; the quantization plan
    (``plan_quantization``) runs ONCE here, so every replica serves the
    same calibrated scales and the same (optionally prequantized) weight
    tensors: N replicas hold one copy of the weights.

    ``meshes``: per-replica device meshes, one a replica
    (``launch/mesh.make_replica_meshes``): this rank's own replica as its
    live ``(data=1, tp)`` mesh and every other as a ``ReplicaGroup``, the
    whole world running this router (the module docstring). ``None`` (or
    ``None`` entries) builds every replica on ``api.device``; on the card a
    replica of one rank captures its decode step at construction, so
    ``run`` builds and captures nothing. ``clock``: the router's clock
    (seconds; the host's ``time.perf_counter`` when None), world rank 0's
    deciding for all.

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
                 clock: Optional[Callable[[], float]] = None,
                 **engine_kwargs):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if meshes is not None and len(meshes) != n_replicas:
            raise ValueError(f"got {len(meshes)} meshes for "
                             f"{n_replicas} replicas")
        meshes = list(meshes) if meshes is not None else [None] * n_replicas
        self.cfg = cfg if cfg is not None else RouterConfig()
        self.stats = stats if stats is not None else RouterStats()
        self._clock = clock if clock is not None else self._host_clock
        # one shared plan: calibrate/prequantize once, replicate everywhere
        params, scales = plan_quantization(
            api, params, qcfg, cushion=cushion, scales=scales,
            calib_batches=calib_batches, prequant=prequant,
            weight_bits=weight_bits)

        def engine(mesh):
            return ContinuousEngine(api, params, qcfg, cushion=cushion,
                                    scales=scales, mesh=mesh,
                                    stats=ServeStats(), **engine_kwargs)
        self._world = None
        self._requests: Dict[int, Request] = {}
        groups = [getattr(m, "world_ranks", None) for m in meshes]
        if any(g is not None and len(g) > 1 for g in groups) or (
                sum(g is not None for g in groups) > 1):
            self._world = self._world_mesh(meshes)
            wr = self._world.rank
            self.replicas = [
                _Replica(i, _WorldEngine(
                    i, engine(m) if wr in g else None, g[0], wr,
                    self._requests), self.cfg)
                for i, (m, g) in enumerate(zip(meshes, groups))]
        else:
            self.replicas = [_Replica(i, engine(m), self.cfg)
                             for i, m in enumerate(meshes)]
        self._queue: collections.deque = collections.deque()
        self._inflight: Dict[int, Tuple[_QEntry, _Replica]] = {}
        self._draining = False
        self._t0 = self._clock()

    @staticmethod
    def _host_clock() -> float:
        """The host's clock, read through this module's ``time`` at each
        call (a test may swap it)."""
        return time.perf_counter()

    @staticmethod
    def _world_mesh(meshes):
        """The whole world as one mesh (its group and this rank's place),
        over which the router's decisions are broadcast: host ints, on
        the CPU where the backend is gloo (no copy to the card and back,
        no sync of it), on the rank's card under NCCL."""
        import torch.distributed as dist
        from repro_torch.launch.mesh import TPMesh
        ranks = sorted(r for m in meshes for r in m.world_ranks)
        if not dist.is_initialized() or ranks != list(
                range(dist.get_world_size())):
            raise ValueError(
                f"replica meshes over world ranks {ranks}: they must cover "
                f"the process group of a spawn_mesh(fn, data=n, tp=t) "
                f"(launch/mesh.make_replica_meshes)")
        own = [m for m in meshes if isinstance(m, TPMesh)]
        if len(own) != 1:
            raise ValueError("replica meshes: this rank's own replica must "
                             "be its one live TPMesh")
        dev = (torch.device("cpu") if own[0].backend == "gloo"
               else own[0].device)
        return TPMesh(dist.get_rank(), dist.get_world_size(),
                      dist.group.WORLD, dev, own[0].backend)

    # ------------------------------------------------------------------
    # Clock / bookkeeping helpers
    # ------------------------------------------------------------------

    def now(self) -> float:
        """Seconds on the router's clock; with replica meshes world rank
        0's reading on every rank (a collective)."""
        t = self._clock() - self._t0
        if self._world is None:
            return t
        return DC.broadcast_ints([round(t * 1e9)], self._world)[0] * 1e-9

    def _fire(self, injector: FaultInjector, site: str
              ) -> Tuple[List[str], float]:
        """``injector.fire(site)``: the kinds fired and a stall's seconds
        (slept here on one process; with replica meshes rank 0 fires, every
        rank raises or returns the same, and the replica's ranks sleep the
        stall inside the work it delays)."""
        if self._world is None:
            return injector.fire(site), 0.0
        codes = [0, 0, 0, 0]        # raised (1 crash, 2 interrupt), visit,
        if self._world.rank == 0:   # heartbeat, stall in microseconds
            stalls: List[float] = []
            try:
                acts = injector.fire(site, sleep=stalls.append)
                codes = [0, 0, int("heartbeat" in acts),
                         round(sum(stalls) * 1e6)]
            except InjectedFault as e:
                codes = [1, e.step, 0, 0]
            except KeyboardInterrupt:
                codes = [2, 0, 0, 0]
        raised, visit, beat, stall = DC.broadcast_ints(codes, self._world)
        if raised == 1:
            raise InjectedFault(site, visit)
        if raised == 2:
            raise KeyboardInterrupt(f"injected interrupt at {site}")
        return ["heartbeat"] if beat else [], stall * 1e-6

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
            stall = 0.0
            if injector is not None:
                acts, stall = self._fire(injector, f"replica{rep.idx}.admit")
                if "heartbeat" in acts:
                    rep.heartbeat_suppressed = True
            ok = (rep.engine.try_admit(entry.req) if self._world is None
                  else rep.engine.try_admit(entry.req, stall))
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
            if self._world is not None:
                raise               # one fault domain: the spawn ends
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
        t0 = self._clock()
        try:
            if injector is not None:
                acts, _ = self._fire(injector, f"replica{rep.idx}.step")
                if "heartbeat" in acts:
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
        dt = self._clock() - t0
        rep.health.record_step(dt, now + dt,
                               beat=not rep.heartbeat_suppressed)

    def _step_all(self, now: float, injector: Optional[FaultInjector],
                  rejected: List[Rejected],
                  outputs: Dict[int, RoutedOutput]) -> bool:
        """One round: fail over replicas found DEAD, step every other
        replica with work. True when any replica was visited."""
        if self._world is not None:
            return self._step_world(now, injector, rejected, outputs)
        stepped = False
        for rep in self.replicas:
            if rep.state(now) == DEAD:
                # health-driven death (heartbeat timeout, error budget):
                # run failover once
                self._kill_replica(rep, now, rep.health.dead_reason
                                   or "health: " + rep.state(now),
                                   rejected, outputs)
                continue
            if rep.engine.live_count == 0 and rep.engine.prefilling == 0:
                continue
            self._step_replica(rep, now, injector, rejected, outputs)
            stepped = True
        return stepped

    def _step_world(self, now: float, injector: Optional[FaultInjector],
                    rejected: List[Rejected],
                    outputs: Dict[int, RoutedOutput]) -> bool:
        """``_step_all`` over replica meshes: the same decisions in the same
        order (rank 0 fires the injector at each replica in turn; a crash
        kills that replica, an interrupt ends the round after the replicas
        before it), then every replica to step steps at once on its ranks
        and the round's outcomes are exchanged."""
        import torch.distributed as dist
        plan: List[Tuple[_Replica, float]] = []
        interrupted = stepped = False
        for rep in self.replicas:
            if rep.state(now) == DEAD:
                self._kill_replica(rep, now, rep.health.dead_reason
                                   or "health: " + rep.state(now),
                                   rejected, outputs)
                continue
            if rep.engine.live_count == 0 and rep.engine.prefilling == 0:
                continue
            stepped = True
            stall = 0.0
            if injector is not None:
                try:
                    acts, stall = self._fire(injector,
                                             f"replica{rep.idx}.step")
                except InjectedFault as e:
                    self._kill_replica(rep, now, str(e), rejected, outputs)
                    continue
                except KeyboardInterrupt:
                    interrupted = True
                    break
                if "heartbeat" in acts:
                    rep.heartbeat_suppressed = True
            plan.append((rep, stall))
        if plan:
            mine = None
            for rep, stall in plan:
                h = rep.engine
                if h.engine is None:
                    continue
                t0 = self._clock()
                if stall:
                    time.sleep(stall)
                h.engine.step()
                dt = self._clock() - t0
                if h.is_leader:
                    mine = (rep.idx, dt, h.snapshot())
            got: List[Any] = [None] * self._world.size
            dist.all_gather_object(got, mine)
            dts = {}
            for item in got:
                if item is not None:
                    idx, dt, snap = item
                    self.replicas[idx].engine.apply(snap)
                    dts[idx] = dt
            for rep, _ in plan:
                dt = dts[rep.idx]
                rep.health.record_step(dt, now + dt,
                                       beat=not rep.heartbeat_suppressed)
        if interrupted:
            raise KeyboardInterrupt("injected interrupt")
        return stepped

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
        self._requests.clear()
        self._requests.update({r.uid: r for r in requests})
        for rep in self.replicas:
            rep.reset()
            rep.engine.start()
        self._t0 = self._clock()
        pending = collections.deque(
            sorted(requests, key=lambda r: (r.arrival_s, r.uid)))
        outputs: Dict[int, RoutedOutput] = {}
        rejected: List[Rejected] = []
        with _DeferredInterrupts(self._world is not None) as interrupts:
            self._loop(pending, injector, outputs, rejected, interrupts)
        self._snapshot_stats(self.now())
        return RouterResult(
            outputs=[outputs[u] for u in sorted(outputs)],
            rejected=rejected, stats=self.stats)

    def _loop(self, pending, injector, outputs, rejected, interrupts
              ) -> None:
        """``run``'s event loop. With replica meshes a ctrl-C on any rank
        is counted and read at the top of the loop, where no collective is
        open (a max over the world), and starts the drain on every rank."""
        while pending or self._queue or self._inflight:
            if self._world is not None and not self._draining:
                if DC.max_ints([interrupts.count], self._world)[0]:
                    self._draining = True
                    self.stats.drained = True
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
                stepped = self._step_all(now, injector, rejected, outputs)
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
