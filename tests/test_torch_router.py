"""Port parity, the fault-tolerant replica router: ``repro_torch``'s
``ReplicaRouter`` against the JAX one on ``paper_tiny``, on the same
weights, cushion and numpy prompts, under the same fault schedules.

The cases mirror ``tests/test_router.py``: kill 1 of 3 (tokens equal to the
no-fault run), every replica dead, ``queue_full`` backpressure, deadlines
mid-decode, mid-queue and mid-prefill (the engine's ``pop_expired``),
chunked streams, drain under load, heartbeat corruption, a stall flagged
as a straggler, ``retries_exhausted`` and a kill on paged pools. Each holds
the uids, tokens, replica, slot and attempts of every output, the
rejections with their reasons, and the ``RouterStats`` counters (and every
replica's health and ``ServeStats`` snapshot) equal to the JAX router's.

No wall clock decides anything: both routers and both schedulers read a
clock the test owns, which moves only when a replica steps (``STEP_S``) or
the router sleeps, so deadlines, heartbeat ages and step times are counted
in steps. A stall advances that clock too (the injector's ``sleep``).
"""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving.router as JR  # noqa: E402
import repro.serving.scheduler as JS  # noqa: E402
from repro.configs import QuantConfig, get_config  # noqa: E402
from repro.distributed import fault_injection as JFI  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
import repro_torch.serving.router as TR  # noqa: E402
import repro_torch.serving.scheduler as TS  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.distributed import fault_injection as TFI  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402

QN = QuantConfig(mode="none")
STEP_S = 0.01           # clock advance of one replica step


class Clock:
    """A test-owned ``time``: ``perf_counter`` reads it, ``sleep`` moves
    it. A router loop that never ends (work it can no longer reach, as
    with an expired stream nobody pops) reads it without end: past
    ``MAX_READS`` reads in one run the test fails instead of hanging."""

    MAX_READS = 200_000

    def __init__(self):
        self.t = 0.0
        self.reads = 0

    def perf_counter(self):
        self.reads += 1
        if self.reads > self.MAX_READS:
            raise RuntimeError("the router loop does not end")
        return self.t

    def sleep(self, s):
        self.t += s


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    jcfg = get_config("paper_tiny")
    japi = j_build(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(0))
    jcushion = japi.extract_cushion(jparams, jnp.asarray([1, 2, 3],
                                                         jnp.int32), None, QN)
    return dict(japi=japi, jparams=jparams, jcushion=jcushion,
                api=build(t_get_config("paper_tiny"), "cpu"),
                params=convert.params_from_numpy(np_tree(jparams)),
                cushion=convert.cushion_from_numpy(np_tree(jcushion)),
                vocab=jcfg.vocab_size)


class Pair:
    """A JAX router and the port's, built alike, each stepping its own
    ``Clock``."""

    def __init__(self, s, n_replicas, **kw):
        self.clocks = {"jax": Clock(), "torch": Clock()}
        self.j = JR.ReplicaRouter(
            s["japi"], s["jparams"], QN, n_replicas=n_replicas,
            cfg=JR.RouterConfig(**self.CFG), cushion=s["jcushion"], **kw)
        self.t = TR.ReplicaRouter(
            s["api"], s["params"], QN, n_replicas=n_replicas,
            cfg=TR.RouterConfig(**self.CFG), cushion=s["cushion"], **kw)
        for side, router in (("jax", self.j), ("torch", self.t)):
            for rep in router.replicas:
                rep.engine.step = functools.partial(
                    self._step, self.clocks[side], rep.engine.step)
        self.vocab = s["vocab"]
        self.run(self.requests(n_replicas, budget=2))  # warm every replica

    # backoff 0: a retried request's order never waits on the clock
    CFG = dict(max_queue=64, max_retries=2, backoff_base_s=0.0)

    @staticmethod
    def _step(clock, step):
        clock.sleep(STEP_S)
        return step()

    def requests(self, n, budget=8, deadline=None, lens=(20,), seed=100):
        rs = np.random.RandomState(seed)
        toks = [rs.randint(0, self.vocab, (1, lens[i % len(lens)]))
                .astype(np.int32) for i in range(n)]
        return ([JS.Request(uid=i, batch={"tokens": jnp.asarray(t)},
                            max_new_tokens=budget, deadline_s=deadline)
                 for i, t in enumerate(toks)],
                [TS.Request(uid=i, batch={"tokens": torch.from_numpy(t)},
                            max_new_tokens=budget, deadline_s=deadline)
                 for i, t in enumerate(toks)])

    def run(self, reqs, chaos=None, raises=None, **cfg):
        """Both routers on ``reqs`` (a (jax, torch) pair), under the same
        ``--chaos`` spec and policy overrides, each on its own clock from
        0. Returns (jax result, torch result), or the two exceptions when
        ``raises`` is given."""
        out = []
        for side, router, FI, mods, r in (
                ("jax", self.j, JFI, (JR, JS), reqs[0]),
                ("torch", self.t, TFI, (TR, TS), reqs[1])):
            clock = self.clocks[side]
            clock.t, clock.reads = 0.0, 0
            saved = [m.time for m in mods]
            for m in mods:
                m.time = types.SimpleNamespace(
                    perf_counter=clock.perf_counter, sleep=clock.sleep)
            policy = dict(vars(JR.RouterConfig(**self.CFG)), **cfg)
            for k, v in policy.items():
                setattr(router.cfg, k, v)
            inj = None
            if chaos:
                inj = FI.FaultInjector.parse(chaos)
                inj.fire = functools.partial(inj.fire, sleep=clock.sleep)
            try:
                if raises is None:
                    out.append(router.run(r, injector=inj))
                else:
                    with pytest.raises(raises) as e:
                        router.run(r, injector=inj)
                    out.append(e.value)
            finally:
                for m, t in zip(mods, saved):
                    m.time = t
        return tuple(out)


def _same(jres, tres):
    """Outputs, rejections and router counters equal to the JAX router's."""
    key = lambda o: (o.uid, o.replica, o.slot, o.attempts)  # noqa: E731
    assert [key(o) for o in tres.outputs] == [key(o) for o in jres.outputs]
    for a, b in zip(jres.outputs, tres.outputs):
        np.testing.assert_array_equal(b.tokens, a.tokens)
    assert [(r.uid, r.reason) for r in tres.rejected] == \
        [(r.uid, r.reason) for r in jres.rejected]
    assert tres.stats.as_dict() == jres.stats.as_dict()


@pytest.fixture(scope="module")
def pair(tiny):
    """K=3 replicas of one slot each, as ``tests/test_router.py``."""
    return Pair(tiny, 3, n_slots=1, max_seq=128)


@pytest.fixture(scope="module")
def chunked(tiny):
    """One replica, two slots, 8-token prefill chunks."""
    return Pair(tiny, 1, n_slots=2, max_seq=128, chunk_tokens=8)


@pytest.fixture(scope="module")
def paged(tiny):
    """K=3 replicas of two paged slots (16-position pages)."""
    return Pair(tiny, 3, n_slots=2, max_seq=128, paged=True, page_size=16)


def test_kill_one_of_three_token_parity(pair):
    reqs = pair.requests(9, budget=8)
    base = pair.run(reqs)
    _same(*base)
    jres, tres = pair.run(reqs, chaos="crash@replica1.step:2")
    _same(jres, tres)
    want = {o.uid: o.tokens for o in base[1].outputs}
    assert len(tres.outputs) == 9 and not tres.rejected
    for o in tres.outputs:
        np.testing.assert_array_equal(o.tokens, want[o.uid])
    st = tres.stats
    assert st.replica_deaths == 1 and st.failovers >= 1 and st.retries >= 1
    assert [p["state"] for p in st.per_replica] == \
        ["HEALTHY", "DEAD", "HEALTHY"]
    assert any(o.attempts > 1 for o in tres.outputs)


def test_all_replicas_dead_raises(pair):
    chaos = ",".join(f"crash@replica{i}.step:0" for i in range(3))
    je, te = pair.run(pair.requests(6), chaos=chaos,
                      raises=(JR.AllReplicasDead, TR.AllReplicasDead))
    assert isinstance(te, TR.AllReplicasDead)
    assert str(te) == str(je) and "3 replicas DEAD" in str(te)
    assert pair.t.stats.as_dict() == pair.j.stats.as_dict()
    assert pair.t.stats.replica_deaths == 3


def test_backpressure_queue_full(pair):
    jres, tres = pair.run(pair.requests(8, budget=4), max_queue=2)
    _same(jres, tres)
    assert tres.stats.rejections == {"queue_full": 6}
    assert [o.uid for o in tres.outputs] == [0, 1]
    assert tres.stats.queue_depth_peak <= 2


def test_deadline_mid_decode(pair):
    jres, tres = pair.run(pair.requests(1, budget=60, deadline=0.035))
    _same(jres, tres)
    assert not tres.outputs
    assert tres.stats.rejections == {"deadline-decoding": 1}


def test_deadline_mid_queue(pair):
    long_ = pair.requests(3, budget=60)
    victim = pair.requests(4, budget=4, deadline=0.035)
    reqs = (long_[0] + victim[0][3:], long_[1] + victim[1][3:])
    jres, tres = pair.run(reqs)
    _same(jres, tres)
    assert [o.uid for o in tres.outputs] == [0, 1, 2]
    assert [(r.uid, r.reason) for r in tres.rejected] == \
        [(3, "deadline-queued")]


def test_chunked_streams_through_router(chunked):
    jres, tres = chunked.run(chunked.requests(4, budget=3, lens=(48, 12)))
    _same(jres, tres)
    assert [o.uid for o in tres.outputs] == [0, 1, 2, 3]
    assert tres.stats.per_replica[0]["prefill_chunks"] >= 6


def test_deadline_mid_prefill_pops_expired(chunked):
    """A stream that misses its deadline between chunks ends as a
    ``deadline-prefill`` rejection and ``run()`` returns: the engine's
    ``pop_expired`` clears the router's inflight entry."""
    jres, tres = chunked.run(chunked.requests(1, budget=4, lens=(96,),
                                              deadline=0.02))
    _same(jres, tres)
    assert not tres.outputs
    assert [(r.uid, r.reason) for r in tres.rejected] == \
        [(0, "deadline-prefill")]
    rep = tres.stats.per_replica[0]
    assert rep["deadline_prefill"] == 1 and rep["canceled"] == 0
    assert chunked.t.replicas[0].engine.pop_expired() == []


def test_drain_under_load(pair):
    reqs = pair.requests(6, budget=16)
    base = pair.run(reqs)
    jres, tres = pair.run(reqs, chaos="interrupt@replica0.step:2")
    _same(jres, tres)
    assert tres.stats.drained
    assert [o.uid for o in tres.outputs] == [0, 1, 2]
    want = {o.uid: o.tokens for o in base[1].outputs}
    for o in tres.outputs:
        np.testing.assert_array_equal(o.tokens, want[o.uid])
    assert [(r.uid, r.reason) for r in tres.rejected] == \
        [(u, "draining") for u in (3, 4, 5)]


def test_heartbeat_corruption_kills_via_timeout(pair):
    """The engine still answers, its heartbeat stops refreshing: the
    replica dies by heartbeat age, counted in steps of the test's clock,
    and its work fails over with the no-fault tokens."""
    reqs = pair.requests(6, budget=24)
    base = pair.run(reqs)
    jres, tres = pair.run(reqs, chaos="heartbeat@replica1.step:1",
                          heartbeat_timeout_s=0.05)
    _same(jres, tres)
    assert tres.stats.replica_deaths == 1
    assert [p["state"] for p in tres.stats.per_replica][1] == "DEAD"
    assert len(tres.outputs) == 6 and not tres.rejected
    want = {o.uid: o.tokens for o in base[1].outputs}
    for o in tres.outputs:
        np.testing.assert_array_equal(o.tokens, want[o.uid])


def test_stall_flags_straggler_without_killing(pair):
    jres, tres = pair.run(pair.requests(3, budget=12),
                          chaos="stall@replica0.step:4:0.3",
                          straggler_history=2)
    _same(jres, tres)
    assert len(tres.outputs) == 3 and not tres.rejected
    assert tres.stats.replica_deaths == 0
    assert tres.stats.per_replica[0]["stragglers"] == 1
    assert pair.t.replicas[0].health.stragglers == \
        pair.j.replicas[0].health.stragglers


def test_retries_exhausted(pair):
    jres, tres = pair.run(pair.requests(3, budget=4),
                          chaos="crash@replica0.admit:0", max_retries=0)
    _same(jres, tres)
    assert tres.stats.replica_deaths == 1
    assert tres.stats.rejections == {"retries_exhausted": 1}
    assert len(tres.outputs) == 2


@pytest.mark.parametrize("chaos", ["", "crash@replica1.step:3"],
                         ids=["no-fault", "kill"])
def test_paged_pools(paged, chaos):
    reqs = paged.requests(10, budget=6, lens=(20, 28))
    jres, tres = paged.run(reqs, chaos=chaos or None)
    _same(jres, tres)
    assert len(tres.outputs) == 10 and not tres.rejected
    assert tres.stats.replica_deaths == (1 if chaos else 0)


def test_shared_weights_and_tp_refused(tiny, pair):
    """One copy of the weights behind every replica; per-replica meshes of
    ``None`` build every replica on the default device, as the reference
    (tensor-parallel replicas: ``test_torch_replica_tp.py``), and a mesh
    count other than the replicas' is refused."""
    ptrs = {rep.engine.params.tree()["embed"]["w"].data_ptr()
            for rep in pair.t.replicas}
    assert ptrs == {tiny["params"].tree()["embed"]["w"].data_ptr()}
    r = TR.ReplicaRouter(tiny["api"], tiny["params"], QN, n_replicas=2,
                         meshes=[None, None], n_slots=1, max_seq=128)
    assert [rep.engine.mesh for rep in r.replicas] == [None, None]
    assert {rep.engine.params.tree()["embed"]["w"].data_ptr()
            for rep in r.replicas} == ptrs
    with pytest.raises(ValueError, match="3 meshes for 2 replicas"):
        TR.ReplicaRouter(tiny["api"], tiny["params"], QN, n_replicas=2,
                         meshes=[None] * 3, n_slots=1, max_seq=128)


def test_serve_cli_router_on_cpu(capsys):
    res = serve.main(["--arch", "paper_tiny", "--device", "cpu",
                      "--mode", "continuous", "--replicas", "3",
                      "--chaos", "crash@replica1.step:6",
                      "--quant", "pt_static", "--prequant",
                      "--kv-dtype", "int8", "--cushion-len", "3",
                      "--rate", "0", "--n-requests", "8",
                      "--prompt-len", "16", "--tokens", "8"])
    out = capsys.readouterr().out
    st = res.stats
    assert st.replica_deaths == 1 and st.completed == st.submitted == 8
    assert "[serve] router: 8/8 completed, 0 rejected" in out
    assert "1 deaths" in out and "'DEAD'" in out
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--replicas", "2"])
