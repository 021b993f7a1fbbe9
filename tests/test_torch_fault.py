"""Port parity, fault handling: ``repro_torch.distributed``'s fault
injector, health tracker and training supervisor, and
``CheckpointManager.restore(step, like=)``, against the JAX package's on
the same inputs.

* ``FaultInjector``: the same visits give the same firings, raises, stall
  sleeps and log, before and after ``reset``; seeded random steps and the
  ``--chaos`` grammar (``parse``) give the same points and the same errors.
* ``HealthTracker``: seeded sequences of beats, steps (``dt``, ``now``,
  label, suppressed beat), errors and kills give the same state, heartbeat
  age, counters and stragglers after every call.
* ``Supervisor``: the behaviours of ``tests/test_distributed.py`` and
  ``tests/test_substrate.py`` on toy steps (stragglers, retries exhausted,
  the consecutive budget, backoff, metrics, restore and replay, no
  checkpoint), with the same report, sleeps, metrics and final state. Both
  supervisors read a clock the test owns (a step moves it, so do the
  backoff sleeps), never the wall clock.
* ``restore``: dtypes and devices of ``like``, nested lists and tuples, the
  structure check, corruption, and artifacts crossing between the packages.
"""
import collections
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.store import CheckpointManager as JCM  # noqa: E402
from repro.distributed import fault_injection as JFI  # noqa: E402
from repro.distributed import fault_tolerance as JFT  # noqa: E402
from repro_torch.checkpoint.store import CheckpointManager as TCM  # noqa: E402
from repro_torch.distributed import fault_injection as TFI  # noqa: E402
from repro_torch.distributed import fault_tolerance as TFT  # noqa: E402


# ---------------------------------------------------------------------------
# FaultInjector
# ---------------------------------------------------------------------------

def _visit(FI, points, sites):
    """Visit ``sites`` in order; each visit's outcome (returned kinds, or
    the exception's type and message), the stall sleeps and the log."""
    inj = FI.FaultInjector([FI.FailPoint(**p) for p in points])
    outcomes = []
    for rnd in range(2):                # the second round replays: reset()
        slept = []
        for site in sites:
            try:
                outcomes.append(inj.fire(site, sleep=slept.append))
            except (FI.InjectedFault, KeyboardInterrupt) as e:
                outcomes.append((type(e).__name__, str(e),
                                 getattr(e, "site", None),
                                 getattr(e, "step", None)))
        outcomes.append((slept, list(inj.log), dict(inj.counters)))
        inj.reset()
    return outcomes


SCHEDULES = {
    "crash": ([dict(site="a.step", kind="crash", at_step=2)],
              ["a.step", "b.step", "a.step", "a.step", "a.step"]),
    "recurring": ([dict(site="r.step", kind="stall", at_step=1, every=2,
                        count=3, stall_s=0.25),
                   dict(site="r.step", kind="heartbeat", at_step=2),
                   dict(site="r.admit", kind="interrupt", at_step=1)],
                  ["r.step"] * 9 + ["r.admit"] * 3),
    "mixed": ([dict(site="replica0.step", kind="crash", at_step=0),
               dict(site="replica1.step", kind="heartbeat", at_step=1,
                    every=1, count=2),
               dict(site="replica1.admit", kind="crash", at_step=3)],
              ["replica0.step", "replica1.step", "replica1.admit"] * 5),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_injector_schedules_match_jax(name):
    points, sites = SCHEDULES[name]
    assert _visit(TFI, points, sites) == _visit(JFI, points, sites)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_seeded_random_steps_match_jax(seed):
    def draw(FI):
        inj = FI.FaultInjector(
            [FI.FailPoint(site=f"s{i}", at_step=None, max_step=m)
             for i, m in enumerate((32, 64, 5, 1))], seed=seed)
        inj.add(FI.FailPoint(site="late", at_step=None, max_step=17))
        return [p.at_step for p in inj.points]
    got = draw(TFI)
    assert got == draw(JFI)
    assert all(0 <= s < m for s, m in zip(got, (32, 64, 5, 1, 17)))


@pytest.mark.parametrize("spec", [
    "crash@replica1.step:12, stall@replica0.step:5:0.25,"
    "heartbeat@replica2.heartbeat:8",
    "interrupt@replica0.step:10",
    "crash@replica1.step,,stall@replica3.admit:0:1e-3",
    "crash-replica1",
    "explode@replica0.step:1",
    "stall@replica0.step:x",
])
def test_chaos_spec_parse_matches_jax(spec):
    def parse(FI):
        try:
            inj = FI.FaultInjector.parse(spec, seed=3)
        except ValueError as e:
            return ("ValueError", str(e))
        return [(p.site, p.kind, p.at_step, p.stall_s, p.every, p.count)
                for p in inj.points]
    assert parse(TFI) == parse(JFI)


# ---------------------------------------------------------------------------
# HealthTracker
# ---------------------------------------------------------------------------

def _health_trace(HT, seed):
    """A seeded sequence of calls on a tracker, and everything observable
    after each."""
    rs = np.random.RandomState(seed)
    h = HT.HealthTracker(heartbeat_timeout_s=1.0, dead_after_errors=3,
                         straggler_factor=3.0, window=6, min_history=3)
    now, seen = 0.0, []
    for i in range(60):
        now += float(rs.choice([0.01, 0.1, 0.3, 0.6]))
        op = rs.choice(["beat", "step", "step", "step", "error", "dead"],
                       p=[0.1, 0.25, 0.25, 0.25, 0.13, 0.02])
        if op == "beat":
            h.beat(now)
        elif op == "step":
            dt = float(rs.choice([0.01, 0.012, 0.05, 0.2]))
            seen.append(h.record_step(dt, now, label=i,
                                      beat=bool(rs.rand() > 0.2)))
        elif op == "error":
            h.record_error(now)
        else:
            h.mark_dead(f"killed at {i}")
        later = now + float(rs.choice([0.0, 0.4, 0.7, 1.2]))
        seen.append((op, h.state(now), h.state(later),
                     h.heartbeat_age(later), h.consecutive_errors, h.errors,
                     list(h.stragglers), h.dead_reason, list(h.times)))
    return seen


@pytest.mark.parametrize("seed", range(6))
def test_health_tracker_matches_jax(seed):
    got = _health_trace(TFT, seed)
    assert got == _health_trace(JFT, seed)
    states = {s[1] for s in got if isinstance(s, tuple)}
    assert states >= {TFT.HEALTHY, TFT.DEGRADED} or TFT.DEAD in states


def test_health_states_are_the_references():
    assert (TFT.HEALTHY, TFT.DEGRADED, TFT.DEAD) == \
        (JFT.HEALTHY, JFT.DEGRADED, JFT.DEAD)


# ---------------------------------------------------------------------------
# Supervisor on toy steps
# ---------------------------------------------------------------------------

STEP_S = 0.01


class Clock:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def perf_counter(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def _scenario(name):
    """(Supervisor kwargs, step0, n_steps, {failing step: how many times
    it fails, None: always}, {slow step: its seconds})."""
    return {
        "stragglers": (dict(save_every=100, straggler_factor=3.0), 0, 14,
                       {}, {10: 0.25}),
        "retries_exhausted": (dict(save_every=2, max_retries=3), 0, 8,
                              {4: None}, {}),
        "consecutive_budget": (dict(save_every=2, max_retries=3,
                                    backoff_base_s=0.0), 0, 20,
                               {3: 1, 7: 1, 11: 1, 15: 1}, {}),
        "backoff": (dict(save_every=2, max_retries=3, backoff_base_s=0.1,
                         backoff_cap_s=0.15), 0, 8, {4: 3}, {}),
        "metrics": (dict(save_every=100), 3, 5, {}, {}),
        "restore_replay": (dict(save_every=5, max_retries=3), 0, 10,
                           {7: 1}, {}),
        "no_checkpoint": (dict(save_every=100), 0, 5, {0: None}, {}),
    }[name]


def _supervise(FT, CM, zeros, tmp, name, monkeypatch):
    kw, step0, n, fails, slow = _scenario(name)
    clock = Clock()
    monkeypatch.setattr(FT, "time", types.SimpleNamespace(
        perf_counter=clock.perf_counter, sleep=clock.sleep))
    left = dict(fails)
    seen = []

    def do_step(state, step):
        clock.t += slow.get(step, STEP_S)
        if step in left and (left[step] is None or left[step] > 0):
            if left[step] is not None:
                left[step] -= 1
            raise RuntimeError(f"node failure at {step}")
        return {"x": state["x"] + 1}, {"loss": float(step)}

    sup = FT.Supervisor(CM(str(tmp)), **kw)
    try:
        state, rep = sup.run({"x": zeros()}, step0, n, do_step,
                             on_metrics=lambda s, m: seen.append((s, m)))
        out = (float(state["x"]), rep.completed_steps, rep.failures,
               rep.restores, rep.stragglers, rep.step_times)
    except RuntimeError as e:
        out = ("raised", str(e))
    return (out, sup.failures, sup.restores, sup.health.consecutive_errors,
            clock.sleeps, seen, CM(str(tmp)).steps())


@pytest.mark.parametrize("name", ["stragglers", "retries_exhausted",
                                  "consecutive_budget", "backoff", "metrics",
                                  "restore_replay", "no_checkpoint"])
def test_supervisor_matches_jax(tmp_path, monkeypatch, name):
    got = _supervise(TFT, TCM, lambda: torch.zeros(()), tmp_path / "t",
                     name, monkeypatch)
    want = _supervise(JFT, JCM, lambda: jnp.zeros(()), tmp_path / "j",
                      name, monkeypatch)
    assert got == want
    out, failures, restores, consecutive, sleeps, seen, _ = got
    if name == "stragglers":
        assert 10 in out[4] and failures == 0
    elif name == "retries_exhausted":
        assert out[0] == "raised" and failures == 4 and restores == 3
    elif name == "consecutive_budget":
        assert out[1] == 20 and failures == 4 and consecutive == 0
    elif name == "backoff":
        assert out[1] == 8
        assert sleeps == [pytest.approx(0.1), pytest.approx(0.15),
                          pytest.approx(0.15)]
    elif name == "metrics":
        assert out[1] == 5 and [s for s, _ in seen] == [3, 4, 5, 6, 7]
    elif name == "restore_replay":
        assert out[0] == 10.0 and failures == restores == 1
    else:
        assert out == ("raised", "node failure at 0") and restores == 0


# ---------------------------------------------------------------------------
# CheckpointManager.restore(step, like=)
# ---------------------------------------------------------------------------

Moments = collections.namedtuple("Moments", "mu nu")   # as AdamWState


def _tree():
    return {"a": torch.arange(6, dtype=torch.int64).reshape(2, 3),
            "b": {"c": torch.linspace(-2, 2, 4).to(torch.bfloat16)},
            "l": [torch.ones(3), (torch.tensor([-3, 7], dtype=torch.int8),
                                  torch.zeros((), dtype=torch.float64))],
            "opt": Moments(mu=torch.full((2,), 0.5), nu=torch.ones(2))}


def test_restore_like_keeps_structure_dtypes_and_devices(tmp_path):
    cm = TCM(str(tmp_path))
    tree = _tree()
    cm.save(3, tree)
    out = cm.restore(3, like=tree)
    assert isinstance(out["l"], list) and isinstance(out["l"][1], tuple)
    assert isinstance(out["opt"], Moments)
    assert torch.equal(out["opt"].mu, tree["opt"].mu)
    flat = [(out["a"], tree["a"]), (out["b"]["c"], tree["b"]["c"]),
            (out["l"][0], tree["l"][0]), (out["l"][1][0], tree["l"][1][0]),
            (out["l"][1][1], tree["l"][1][1])]
    for got, want in flat:
        assert got.dtype == want.dtype and got.device == want.device
        assert torch.equal(got, want)
    # the like tree's dtypes decide: bf16 stored, f32 asked
    like = dict(tree, b={"c": torch.zeros(4)})
    assert cm.restore(3, like=like)["b"]["c"].dtype == torch.float32
    assert torch.equal(cm.restore(3, like=like)["b"]["c"],
                       tree["b"]["c"].float())


def test_restore_like_refuses_other_structures_and_corruption(tmp_path):
    cm = TCM(str(tmp_path))
    tree = _tree()
    path = cm.save(1, tree)
    with pytest.raises(ValueError, match="structure mismatch"):
        cm.restore(1, like={"a": tree["a"]})
    with pytest.raises(ValueError, match="structure mismatch"):
        cm.restore(1, like=dict(tree, extra=torch.zeros(1)))
    with open(f"{path}/arrays.npz", "r+b") as f:
        f.seek(100)
        f.write(b"\x00corrupt\x00")
    with pytest.raises(IOError):
        cm.restore(1, like=tree)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_restore_like_across_packages(tmp_path, direction):
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "opt": {"m": np.linspace(0, 1, 5).astype(np.float32),
                    "step": np.asarray(7, np.int32)}}
    jtree = {"w": jnp.asarray(tree["w"]),
             "opt": {"m": jnp.asarray(tree["opt"]["m"]),
                     "step": jnp.asarray(tree["opt"]["step"])}}
    ttree = {"w": torch.from_numpy(tree["w"]),
             "opt": {"m": torch.from_numpy(tree["opt"]["m"]),
                     "step": torch.from_numpy(tree["opt"]["step"])}}
    if direction == "jax_to_port":
        JCM(str(tmp_path)).save(5, jtree)
        out = TCM(str(tmp_path)).restore(5, like=ttree)
        got = {"w": out["w"].numpy(), "m": out["opt"]["m"].numpy(),
               "step": out["opt"]["step"].numpy()}
    else:
        TCM(str(tmp_path)).save(5, ttree)
        out = JCM(str(tmp_path)).restore(5, like=jtree)
        got = {"w": np.asarray(out["w"]), "m": np.asarray(out["opt"]["m"]),
               "step": np.asarray(out["opt"]["step"])}
    np.testing.assert_array_equal(got["w"], tree["w"])
    np.testing.assert_array_equal(got["m"], tree["opt"]["m"])
    assert got["step"] == 7 and got["step"].dtype == np.int32
