"""Deterministic, seedable fault injection for the serving stack, a copy
of ``repro/distributed/fault_injection.py`` (numpy only there too; the port
keeps its own so that it imports nothing of the JAX package).

The router (serving/router.py) threads every unit of replica work through
named *sites* — ``replica{i}.step``, ``replica{i}.admit``,
``replica{i}.heartbeat`` — and calls ``FaultInjector.fire(site)`` at each.
A ``FailPoint`` arms one site at a specific visit count, so a chaos test
can say "kill replica 1 on its 12th decode step" and get the *same*
failure on every run: the chaos suites assert token-for-token parity
against a no-fault run, which is only meaningful when the fault schedule
is reproducible.

Kinds
-----
``crash``      raise ``InjectedFault`` at the site (the router treats it
               as a replica death: mark DEAD, fail the in-flight requests
               over to survivors)
``stall``      sleep ``stall_s`` at the site (trips the router's
               straggler detector -> DEGRADED without killing anything)
``heartbeat``  corrupt the replica's liveness signal: the router stops
               refreshing that replica's heartbeat from this firing on
               (sticky), so heartbeat age grows until the health tracker
               declares it DEAD even though the engine still answers
``interrupt``  raise ``KeyboardInterrupt`` at the site — exercises the
               graceful-drain path (stop admitting, finish live slots)
               deterministically in tests

``at_step`` counts *visits to that site* (the injector keeps a counter per
site), so schedules are independent of wall clock. ``at_step=None`` draws
the firing step uniformly from [0, max_step) with the injector's seeded
RNG — randomized chaos that is still reproducible run-to-run.

CLI specs (``launch/serve.py --chaos``, comma-separated)::

    crash@replica1.step:12            kill replica 1 at its 12th step
    stall@replica0.step:5:0.25        0.25 s stall at step 5
    heartbeat@replica2.heartbeat:8    corrupt replica 2's heartbeat
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

KINDS = ("crash", "stall", "heartbeat", "interrupt")


class InjectedFault(RuntimeError):
    """Raised by a ``crash`` fail-point; carries the site it fired at."""

    def __init__(self, site: str, step: int):
        super().__init__(f"injected crash at {site} (visit {step})")
        self.site = site
        self.step = step


@dataclasses.dataclass
class FailPoint:
    """One armed fault. Fires when ``site``'s visit counter reaches
    ``at_step`` (and every ``every`` visits after that, up to ``count``
    total firings, for recurring faults)."""
    site: str
    kind: str = "crash"
    at_step: Optional[int] = 0      # None -> drawn from the injector's RNG
    stall_s: float = 0.1
    every: Optional[int] = None     # recurring period after first firing
    count: int = 1                  # max total firings
    max_step: int = 64              # RNG range when at_step is None
    fired: int = dataclasses.field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fail-point kind {self.kind!r}; "
                             f"expected one of {KINDS}")

    def should_fire(self, step: int) -> bool:
        if self.fired >= self.count or self.at_step is None:
            return False
        if step == self.at_step:
            return True
        return (self.every is not None and step > self.at_step
                and (step - self.at_step) % self.every == 0)


class FaultInjector:
    """Holds armed ``FailPoint``s and per-site visit counters.

    ``fire(site)`` increments the site's counter, then applies every
    matching point: ``crash``/``interrupt`` raise, ``stall`` sleeps, and
    non-raising kinds are returned as a list of kind strings for the
    caller to interpret (the router uses ``"heartbeat"`` to stop
    refreshing that replica's liveness signal). A fresh injector (or
    ``reset()``) replays the identical schedule — determinism is the whole
    point."""

    def __init__(self, points: Sequence[FailPoint] = (), seed: int = 0):
        self.points = list(points)
        self.seed = seed
        rng = np.random.RandomState(seed)
        for p in self.points:
            if p.at_step is None:   # seeded randomized schedule
                p.at_step = int(rng.randint(0, max(1, p.max_step)))
        self.counters: Dict[str, int] = {}
        self.log: List[tuple] = []      # (site, visit, kind) firing history

    def add(self, point: FailPoint) -> "FaultInjector":
        if point.at_step is None:
            rng = np.random.RandomState(self.seed + len(self.points))
            point.at_step = int(rng.randint(0, max(1, point.max_step)))
        self.points.append(point)
        return self

    def reset(self) -> None:
        """Rearm every point and zero the visit counters (replay the same
        schedule in a second run)."""
        self.counters = {}
        self.log = []
        for p in self.points:
            p.fired = 0

    def fire(self, site: str, sleep=time.sleep) -> List[str]:
        """Visit ``site``: apply every armed point that matches. Raises for
        ``crash``/``interrupt``; returns the non-raising kinds fired."""
        step = self.counters.get(site, 0)
        self.counters[site] = step + 1
        actions: List[str] = []
        for p in self.points:
            if p.site != site or not p.should_fire(step):
                continue
            p.fired += 1
            self.log.append((site, step, p.kind))
            if p.kind == "crash":
                raise InjectedFault(site, step)
            if p.kind == "interrupt":
                raise KeyboardInterrupt(f"injected interrupt at {site}")
            if p.kind == "stall":
                sleep(p.stall_s)
            actions.append(p.kind)
        return actions

    @staticmethod
    def parse(spec: str, seed: int = 0) -> "FaultInjector":
        """Build an injector from a ``--chaos`` CLI spec: comma-separated
        ``kind@site:step[:stall_s]`` entries (see module docstring)."""
        points = []
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            try:
                kind, rest = entry.split("@", 1)
                parts = rest.split(":")
                site = parts[0]
                at_step = int(parts[1]) if len(parts) > 1 else 0
                stall = float(parts[2]) if len(parts) > 2 else 0.1
            except (ValueError, IndexError) as e:
                raise ValueError(
                    f"bad --chaos entry {entry!r} (want "
                    f"kind@site:step[:stall_s]): {e}") from None
            points.append(FailPoint(site=site, kind=kind, at_step=at_step,
                                    stall_s=stall))
        return FaultInjector(points, seed=seed)
