"""Fault tolerance: health tracking shared by the training supervisor and
the serving replica router, ported from
``repro/distributed/fault_tolerance.py`` with the same behaviour.

At 1000+ nodes (training) or N replicas (serving), failures are routine.
Two consumers share the machinery here:

* ``Supervisor`` wraps training-step execution with (a) retry +
  restore-from-checkpoint on failure — counting *consecutive* failures
  (a long run accumulating occasional recovered incidents must not exhaust
  the budget) with capped exponential backoff between restore attempts,
  (b) per-step heartbeat timing with straggler detection, and
  (c) deterministic data-pipeline replay from the checkpointed step.
* ``HealthTracker`` is the per-worker health-state machine the serving
  router (serving/router.py) keeps per replica: heartbeat age + consecutive
  error count + straggler detection fold into one of three states —

      HEALTHY   fresh heartbeat, no outstanding errors, normal step times
      DEGRADED  recoverable trouble: an error since the last success, a
                straggling step, or a heartbeat older than half the
                timeout — still dispatchable, but only when no healthy
                peer has capacity
      DEAD      crash (``mark_dead``), ``dead_after_errors`` consecutive
                errors, or heartbeat age past the timeout — never
                dispatched again; its in-flight work fails over

  States are *computed* from the counters (except ``mark_dead``, which is
  sticky), so a replica whose heartbeat resumes before the timeout recovers
  to HEALTHY without special-case code.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.store import CheckpointManager

HEALTHY = "HEALTHY"
DEGRADED = "DEGRADED"
DEAD = "DEAD"


class HealthTracker:
    """Per-worker health-state machine (see module docstring).

    ``record_step(dt, now)`` reports a successful unit of work: it clears
    the consecutive-error count, refreshes the heartbeat, and feeds the
    straggler detector (step time > ``straggler_factor`` x rolling median
    over ``window`` steps, armed after ``min_history`` observations).
    ``record_error(now)`` reports a recoverable failure. ``mark_dead`` is
    the terminal transition (crash / injected kill) and is sticky.
    """

    def __init__(self, heartbeat_timeout_s: float = 10.0,
                 dead_after_errors: int = 3, straggler_factor: float = 3.0,
                 window: int = 32, min_history: int = 8):
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.dead_after_errors = dead_after_errors
        self.straggler_factor = straggler_factor
        self.min_history = min_history
        self.times: deque = deque(maxlen=window)
        self.stragglers: List[Any] = []     # labels passed to record_step
        self.consecutive_errors = 0
        self.errors = 0                      # lifetime (reporting only)
        self.last_beat: Optional[float] = None
        self.dead_reason: Optional[str] = None
        self._straggling = False             # last step was flagged

    # -- reporting ------------------------------------------------------

    def beat(self, now: float) -> None:
        self.last_beat = now

    def record_step(self, dt: float, now: float, label: Any = None,
                    beat: bool = True) -> bool:
        """Report a successful step taking ``dt`` seconds. Returns True if
        the step was flagged as a straggler. ``beat=False`` records the
        timing without refreshing the heartbeat — the router uses it for a
        replica whose liveness signal is corrupted (chaos ``heartbeat``
        faults): the engine still answers, but its heartbeat ages until the
        timeout declares it DEAD."""
        self.consecutive_errors = 0
        flagged = False
        if len(self.times) >= self.min_history:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.straggler_factor * med:
                self.stragglers.append(label)
                flagged = True
        self._straggling = flagged
        self.times.append(dt)
        if beat:
            self.beat(now)
        return flagged

    def record_error(self, now: float) -> None:
        self.consecutive_errors += 1
        self.errors += 1
        self.beat(now)      # an error is still a sign of life

    def mark_dead(self, reason: str) -> None:
        self.dead_reason = reason

    # -- state ----------------------------------------------------------

    def heartbeat_age(self, now: float) -> float:
        return 0.0 if self.last_beat is None else max(0.0,
                                                      now - self.last_beat)

    def state(self, now: float) -> str:
        if (self.dead_reason is not None
                or self.consecutive_errors >= self.dead_after_errors
                or self.heartbeat_age(now) > self.heartbeat_timeout_s):
            return DEAD
        if (self.consecutive_errors > 0 or self._straggling
                or self.heartbeat_age(now) > self.heartbeat_timeout_s / 2):
            return DEGRADED
        return HEALTHY


@dataclasses.dataclass
class SupervisorReport:
    completed_steps: int
    failures: int
    restores: int
    stragglers: List[int]
    step_times: List[float]


class Supervisor:
    """Training-loop retry/restore wrapper. ``state`` is a tree of tensors
    (nested dicts, lists, tuples); a restore brings it back with the
    dtypes and devices of the state it replaces
    (``CheckpointManager.restore(step, like=state)``).

    The retry budget is *consecutive*: ``failures`` stays a lifetime
    counter for the report, but only ``max_retries`` failures in a row
    (without an intervening successful step) exhaust the budget — a long
    run with occasional recovered incidents never raises. Between restore
    attempts the supervisor sleeps ``backoff_base_s * 2**(k-1)`` (capped at
    ``backoff_cap_s``) so a flapping node is not hammered with restores.
    """

    def __init__(self, ckpt: CheckpointManager, save_every: int = 50,
                 max_retries: int = 3, straggler_factor: float = 3.0,
                 window: int = 32, backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0):
        self.ckpt = ckpt
        self.save_every = save_every
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.health = HealthTracker(straggler_factor=straggler_factor,
                                    window=window)
        self.failures = 0        # lifetime (reported)
        self.restores = 0

    @property
    def times(self) -> deque:
        return self.health.times

    @property
    def stragglers(self) -> List[int]:
        return self.health.stragglers

    def run(self, state: Any, step0: int, n_steps: int,
            do_step: Callable[[Any, int], Any],
            make_fresh_state: Optional[Callable[[], Any]] = None,
            on_metrics: Optional[Callable[[int, Dict], None]] = None
            ) -> tuple:
        """Run steps [step0, step0+n_steps) with retry/restore. `do_step`
        may raise; we back off, restore the latest checkpoint and replay."""
        step = step0
        end = step0 + n_steps
        while step < end:
            t0 = time.perf_counter()
            try:
                state, metrics = do_step(state, step)
            except Exception:  # noqa: BLE001 — any step failure
                self.failures += 1
                self.health.record_error(time.perf_counter())
                latest = self.ckpt.latest_step()
                if (latest is None
                        or self.health.consecutive_errors > self.max_retries):
                    raise
                # capped exponential backoff: 1st retry waits base, then 2x
                backoff = min(self.backoff_cap_s, self.backoff_base_s
                              * 2 ** (self.health.consecutive_errors - 1))
                if backoff > 0:
                    time.sleep(backoff)
                state = self.ckpt.restore(latest, like=state)
                self.restores += 1
                step = latest  # deterministic pipeline replays from here
                continue
            dt = time.perf_counter() - t0
            self.health.record_step(dt, time.perf_counter(), label=step)
            if on_metrics:
                on_metrics(step, metrics)
            step += 1
            if step % self.save_every == 0 or step == end:
                self.ckpt.save(step, state, extra={"metrics": {
                    k: float(v) for k, v in metrics.items()}})
        report = SupervisorReport(
            completed_steps=step - step0, failures=self.failures,
            restores=self.restores, stragglers=list(self.stragglers),
            step_times=list(self.times))
        return state, report
