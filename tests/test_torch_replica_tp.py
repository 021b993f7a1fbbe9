"""Port parity, the router over tensor-parallel replicas and the dynamic
modes and W4A8 under tensor parallelism, on ``paper_tiny`` in f32 on the
CPU, each world size in one spawn (gloo ranks).

* ``ReplicaRouter`` over ``launch/mesh.make_replica_meshes(2, 2)`` (four
  ranks, ``spawn_mesh(..., data=2, tp=2)``), pt_static with int8-resident
  weights and an int8 paged pool, against the JAX package's
  ``ReplicaRouter`` with ``meshes=None`` and 2 replicas (its one host
  device: no mesh; its tokens do not depend on one) on the same weights,
  cushion, scales, trace and fault schedule, once without faults and once
  with ``crash@replica1.step:4``: every request's tokens, replica and slot
  and the ``RouterStats`` counts equal. The JAX router reads a clock the
  test owns (a replica step moves it), the port's ranks clocks that run at
  rates that differ by rank, whose readings decide nothing but on rank 0.
  With backoff 0 no decision waits on a clock.
* tp = 2 under ``pt_dynamic`` and ``ptoken_dynamic`` (fake quant, and
  true int8 where the reference has it) and W4A8 (prequantized, int8 KV):
  every activation scale, zero point and code of the prefill equal to the
  unsharded port's (a row-parallel site's codes are that rank's slice of
  the whole row's); prefill logits within 2e-4 of JAX's unsharded
  ``Engine`` (the reference's tp bar in f32) and its tokens, up to the
  first near tie; W4A8 within the reference's own bar between its two
  routes (rtol 1e-4, atol 1e-3, ``tests/test_torch_w4a8.py``: the group
  partials are f32 sums in another order) against both routes.
* the kernels' new modes in their plain versions: the per-token
  quantizer's given-range codes from the two halves' ranges equal the
  whole row's (``act_quant_ptoken`` and JAX's ``ref.act_quant_ref``),
  and W4A8's accumulator mode plus ``w4a8_epilogue`` equal
  ``w4a8_matmul`` and JAX's ``ref.w4a8_matmul_ref``.
* ``serve.py --replicas 2 --tp 2 --chaos crash@replica1.step:4`` completes
  every request.
* the router over 2 replicas x tp 2 of the reduced xlstm-350m (its
  recurrent state in contiguous pools, W8A8 with int8-resident
  ``w_proj``), in the same spawn: the JAX router's outputs and counts.
* FSDP cut on both axes, in the same spawn: ``shard_train_step`` on a
  (data 2, model 2) mesh, six steps of paper_tiny, at
  ``test_torch_sharding.py``'s tp = 2 bars against JAX's one device and
  the port's one rank; each rank holds a quarter of every "D" and "M"
  leaf and f32 moments of it.
"""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.flags as flags  # noqa: E402
import repro.serving.router as JR  # noqa: E402
import repro.serving.scheduler as JS  # noqa: E402
from repro.configs import QuantConfig, get_config, reduced  # noqa: E402
from repro.core import calibration as JCal  # noqa: E402
from repro.distributed import fault_injection as JFI  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import quantization as TQ  # noqa: E402
from repro_torch.kernels.act_quant import (act_quant_ptoken,  # noqa: E402
                                           act_quant_ptoken_range)
from repro_torch.kernels.w4a8_matmul import (w4a8_epilogue,  # noqa: E402
                                             w4a8_matmul)
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from _tp_probe import run_cases, run_router_cases  # noqa: E402
import _train_ref as TRF  # noqa: E402

QN = QuantConfig()
QW8 = QuantConfig(mode="pt_static", true_int8=True)
TOL = 2e-4                      # the reference's tp bar in f32
W4_RTOL, W4_ATOL = 1e-4, 1e-3   # the reference's bar between its W4A8 routes
# what one flipped code moves paper_tiny's logits by (f32, |logit| ~3): up
# to 0.061 over 8 seeds' weights (``tests/test_torch_ptoken.py``
# PTOKEN_TIE); a fault (a wrong range, scale or slot) moves them by O(1)
FLIP_BAR = 0.1
N_TOKENS = 8
STEP_S = 0.01                   # the JAX router's clock: one replica step
CRASH = "crash@replica1.step:4"
RATES = [1, 3, 7, 2]            # the port's clocks, ms a read, by rank
# (name, qcfg, prequant, weight_bits, kv_dtype)
MODES = [("pt_dynamic", QuantConfig(mode="pt_dynamic"), False, 8, None),
         ("ptoken_dynamic", QuantConfig(mode="ptoken_dynamic"), False, 8,
          None),
         ("pt_dynamic-int8", QuantConfig(mode="pt_dynamic", true_int8=True),
          False, 8, None),
         ("ptoken_dynamic-int8",
          QuantConfig(mode="ptoken_dynamic", true_int8=True), False, 8,
          None),
         ("w4a8", QW8, True, 4, "int8")]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    jcfg = get_config("paper_tiny")
    japi = j_build(jcfg)
    params = japi.init_params(jax.random.PRNGKey(0))
    cushion = japi.extract_cushion(params, jnp.asarray([1, 2, 3], jnp.int32),
                                   None, QN)
    rs = np.random.RandomState(5)
    calib = rs.randint(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    scales, _ = JCal.calibrate(japi, params, [{"tokens": jnp.asarray(calib)}],
                               QW8, cushion=cushion)
    tokens = rs.randint(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    trace = [rs.randint(0, jcfg.vocab_size, (1, (20, 26)[i % 2]))
             .astype(np.int32) for i in range(8)]
    return dict(jcfg=jcfg, japi=japi, params=params, cushion=cushion,
                scales=scales, tokens=tokens, trace=trace,
                budgets=[6, 3, 8, 5, 4, 7, 2, 6],
                np_params=np_tree(params), np_cushion=np_tree(cushion),
                np_scales=np_tree(JCal.scales_to_plain(scales)))


@pytest.fixture(scope="module")
def xl():
    """The reduced xLSTM (f32, JAX's weights), a 4-token cushion state,
    W8A8 scales and a trace of 6 requests."""
    jcfg = reduced(get_config("xlstm-350m"), dtype="float32")
    japi = j_build(jcfg)
    params = japi.init_params(jax.random.PRNGKey(0))
    cushion = japi.extract_cushion(
        params, jnp.asarray([1, 2, 3, 4], jnp.int32), None, QN)
    rs = np.random.RandomState(6)
    calib = rs.randint(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    scales, _ = JCal.calibrate(japi, params, [{"tokens": jnp.asarray(calib)}],
                               QW8, cushion=cushion)
    trace = [rs.randint(0, jcfg.vocab_size, (1, (10, 14)[i % 2]))
             .astype(np.int32) for i in range(6)]
    return dict(jcfg=jcfg, japi=japi, params=params, cushion=cushion,
                scales=scales, trace=trace, budgets=[5, 3, 6, 4, 2, 5],
                np_params=np_tree(params), np_cushion=np_tree(cushion),
                np_scales=np_tree(JCal.scales_to_plain(scales)),
                tcfg=t_reduced(t_get_config("xlstm-350m"), dtype="float32"))


def _case(s, **kw):
    return dict(cfg=s.get("tcfg", t_get_config("paper_tiny")),
                params=s["np_params"], cushion=s["np_cushion"],
                scales=s["np_scales"], max_seq=128, **kw)


# ---------------------------------------------------------------------------
# 1. The router over 2 replicas x tp 2
# ---------------------------------------------------------------------------

# the pools of the router cases: paper_tiny's paged int8 pool, the
# xLSTM's contiguous pool of state (no KV to page or quantize)
PAGED_INT8 = dict(kv_dtype="int8", paged=True, page_size=32)
STATE_POOL = dict(kv_dtype=None, paged=False)


def _router_case(s, name, chaos=None, pool=PAGED_INT8):
    reqs = [dict(tokens=t, max_new_tokens=b)
            for t, b in zip(s["trace"], s["budgets"])]
    return _case(s, name=name, kind="router", qcfg=QW8, prequant=True,
                 n_slots=2, n_replicas=2, requests=reqs, chaos=chaos,
                 router_cfg=dict(backoff_base_s=0.0), clock_rates=RATES,
                 **pool)


def _train_case(s):
    """Six steps of ``shard_train_step`` on the world's (data 2, model 2)
    mesh: FSDP shards cut on both axes."""
    return dict(kind="train", name="train-2x2", cfg=t_get_config("paper_tiny"),
                params=s["np_params"],
                batches=TRF.batches(s["jcfg"].vocab_size),
                batch_rows=TRF.B, seq=TRF.S, steps=TRF.STEPS, lr=1e-3,
                warmup=10, return_params=True, one_rank=True)


@pytest.fixture(scope="module")
def router_runs(tiny, xl):
    """The router cases, and FSDP on both axes, in one spawn of 2 x 2
    ranks: {name: [each rank's report]}."""
    cases = [_router_case(tiny, "no-fault"), _router_case(tiny, "crash",
                                                          CRASH),
             _router_case(xl, "xlstm", pool=STATE_POOL), _train_case(tiny)]
    outs = M.spawn_mesh(run_router_cases, 2, 2, cases, device="cpu",
                        every_rank=True, timeout_s=900)
    return {c["name"]: [o[i] for o in outs] for i, c in enumerate(cases)}


class _Clock:
    """A test-owned ``time`` for the JAX router: ``perf_counter`` reads it,
    ``sleep`` and a replica step move it."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


def _jax_router(s, chaos, pool=PAGED_INT8):
    clock = _Clock()
    router = JR.ReplicaRouter(
        s["japi"], s["params"], QW8, n_replicas=2, meshes=None,
        cfg=JR.RouterConfig(backoff_base_s=0.0), cushion=s["cushion"],
        scales=s["scales"], prequant=True, n_slots=2, max_seq=128, **pool)

    def step(fn):
        clock.sleep(STEP_S)
        return fn()
    for rep in router.replicas:
        rep.engine.step = functools.partial(step, rep.engine.step)
    reqs = [JS.Request(uid=i, batch={"tokens": jnp.asarray(t)},
                       max_new_tokens=b)
            for i, (t, b) in enumerate(zip(s["trace"], s["budgets"]))]
    inj = None
    if chaos:
        inj = JFI.FaultInjector.parse(chaos)
        inj.fire = functools.partial(inj.fire, sleep=clock.sleep)
    saved = (JR.time, JS.time)
    JR.time = JS.time = types.SimpleNamespace(
        perf_counter=clock.perf_counter, sleep=clock.sleep)
    try:
        return router.run(reqs, injector=inj)
    finally:
        JR.time, JS.time = saved


COUNTS = ("submitted", "completed", "retries", "failovers", "replica_deaths",
          "queue_depth_peak", "rejections", "drained", "n_replicas")


@pytest.mark.parametrize("name,chaos", [("no-fault", None),
                                        ("crash", CRASH)])
def test_router_over_tp_replicas_matches_jax(tiny, router_runs, name, chaos):
    """Tokens, replica and slot of every request and the ``RouterStats``
    counts equal to the JAX router's on every rank; the ranks' clocks
    differ and their stats and outputs are the same."""
    want = _jax_router(tiny, chaos)
    ranks = router_runs[name]
    jkey = [(o.uid, o.replica, o.slot) for o in want.outputs]
    jstats = want.stats.as_dict()
    for rep in ranks:
        assert rep["backend"] == "gloo"
        assert [o[:3] for o in rep["outputs"]] == jkey
        for o, j in zip(rep["outputs"], want.outputs):
            np.testing.assert_array_equal(o[3], j.tokens)
        assert rep["rejected"] == [(r.uid, r.reason) for r in want.rejected]
        for k in COUNTS:
            assert rep["stats"][k] == jstats[k], k
        assert [p["state"] for p in rep["stats"]["per_replica"]] == \
            [p["state"] for p in jstats["per_replica"]]
        assert rep["stats"] == ranks[0]["stats"]
    st = ranks[0]["stats"]
    assert st["completed"] == len(tiny["trace"])
    assert st["replica_deaths"] == (1 if chaos else 0)
    if chaos:
        assert st["failovers"] > 0
        # a failed-over request gives the no-fault run's tokens
        base = {o[0]: o[3] for o in router_runs["no-fault"][0]["outputs"]}
        for o in ranks[0]["outputs"]:
            np.testing.assert_array_equal(o[3], base[o[0]])
    print(f"[{name}] {st['completed']} completed, {st['failovers']} "
          f"failovers, {st['replica_deaths']} deaths, replicas "
          f"{sorted({o[1] for o in ranks[0]['outputs']})}")


def test_router_over_tp_replicas_xlstm_matches_jax(xl, router_runs):
    """2 replicas x tp 2 of the reduced xLSTM (each rank its value slice
    of the mLSTM memory, contiguous W8A8 pools of 2 slots): every
    request's tokens, replica and slot and the ``RouterStats`` counts of
    the JAX router on every rank."""
    want = _jax_router(xl, None, STATE_POOL)
    ranks = router_runs["xlstm"]
    jstats = want.stats.as_dict()
    for rep in ranks:
        assert [o[:3] for o in rep["outputs"]] == \
            [(o.uid, o.replica, o.slot) for o in want.outputs]
        for o, j in zip(rep["outputs"], want.outputs):
            np.testing.assert_array_equal(o[3], j.tokens)
        for k in COUNTS:
            assert rep["stats"][k] == jstats[k], k
        assert rep["stats"] == ranks[0]["stats"]
    assert ranks[0]["stats"]["completed"] == len(xl["trace"])
    assert {o[1] for o in ranks[0]["outputs"]} == {0, 1}


def test_replica_meshes_are_disjoint_rows(router_runs):
    """Ranks 0-1 serve replica 0 and ranks 2-3 replica 1 (data rows), and
    each replica's outputs are reported alike by all four ranks."""
    ranks = router_runs["no-fault"]
    assert [r["replica"] for r in ranks] == [0, 0, 1, 1]
    assert {o[1] for o in ranks[0]["outputs"]} == {0, 1}


def test_make_replica_meshes_outside_a_spawn():
    """Outside a spawn: one replica of one rank is one rank's mesh; more
    raise, naming spawn_mesh."""
    (m,) = M.make_replica_meshes(1, 1, device="cpu")
    assert (m.size, m.data_size, m.base) == (1, 1, 0)
    with pytest.raises(RuntimeError, match="spawn_mesh"):
        M.make_replica_meshes(2, 2, device="cpu")


def test_serve_cli_replicas_over_tp(capfd):
    """``serve.py --replicas 2 --tp 2 --chaos crash@replica1.step:4``:
    every request completes; world rank 0 prints the reference's lines."""
    res = serve.main(["--device", "cpu", "--mode", "continuous",
                      "--replicas", "2", "--tp", "2", "--chaos", CRASH,
                      "--quant", "pt_static", "--prequant", "--kv-dtype",
                      "int8", "--cushion-len", "3", "--rate", "0",
                      "--n-requests", "8", "--prompt-len", "16",
                      "--tokens", "16", "--slots", "2"])
    out = capfd.readouterr().out
    st = res.stats
    assert st.completed == st.submitted == 8 and st.replica_deaths == 1
    assert "[serve] 2 replicas x tp=2 on disjoint rank groups" in out
    assert "[serve] router: 8/8 completed, 0 rejected" in out


# ---------------------------------------------------------------------------
# 2. pt_dynamic, ptoken_dynamic and W4A8 at tp = 2
# ---------------------------------------------------------------------------

def _mode_case(s, name, qcfg, pq, wb, kv, **kw):
    return _case(s, name=name, kind="static", qcfg=qcfg, prequant=pq,
                 weight_bits=wb, kv_dtype=kv, tokens=s["tokens"],
                 n_tokens=N_TOKENS, logits=True, record_quant=True,
                 margins=True, **kw)


@pytest.fixture(scope="module")
def modes(tiny):
    """{name: (the unsharded port's report, [tp = 2 ranks' reports])}."""
    cases = [_mode_case(tiny, *m) for m in MODES]
    outs = M.spawn_tp(run_cases, 2, cases, device="cpu", every_rank=True,
                      timeout_s=900)
    one = run_cases(M.make_tp_mesh(1, device="cpu"),
                    [dict(c, mesh=False) for c in cases])
    return {c["name"]: (one[i], [o[i] for o in outs])
            for i, c in enumerate(cases)}


def _jax_engine(s, qcfg, pq, wb, kv):
    return JEngine(s["japi"], s["params"], qcfg, cushion=s["cushion"],
                   scales=s["scales"] if qcfg.mode == "pt_static" else None,
                   max_seq=128, kv_dtype=kv, prequant=pq, weight_bits=wb)


def _jax_ref(s, mode):
    _, qcfg, pq, wb, kv = mode
    eng = _jax_engine(s, qcfg, pq, wb, kv)
    batch = {"tokens": jnp.asarray(s["tokens"])}
    cache = eng._init_cache(s["tokens"].shape[0])
    logits, _, _ = eng._prefill(eng.params, batch, cache)
    logits = np.asarray(logits[:, -1] if logits.ndim == 3 else logits)
    return logits, np.asarray(eng.generate(batch, N_TOKENS).tokens)


def _tokens_up_to_tie(got, want, margins, label):
    """``got`` equals ``want``, or each row up to its first parting, where
    the JAX-side top-1 - top-2 margin the port saw is printed."""
    for b in range(want.shape[0]):
        diff = np.flatnonzero(got[b] != want[b])
        if diff.size:
            t = int(diff[0])
            print(f"{label} row {b}: tokens part at {t}, margin "
                  f"{margins[b, t]:.3g}")
            assert margins[b, t] < FLIP_BAR, (label, b, t, margins[b, t])


def _integer(mode) -> bool:
    """A mode whose row-parallel sums are exact over the ranks: true
    int8's int32 accumulators (W4A8's f32 group sums add in another order
    over the ranks, but on paper_tiny's two groups a rank the order is the
    same)."""
    return mode[1].true_int8


def _first_cut(records, want) -> int:
    """The index of the first row-parallel site's record (its codes a
    slice)."""
    return next(i for i, (g, w) in enumerate(zip(records, want))
                if g["codes"].shape != w["codes"].shape)


@pytest.mark.parametrize("mode", MODES, ids=[m[0] for m in MODES])
def test_tp2_quantization_equals_unsharded(modes, mode):
    """Every activation quantization of the prefill against the unsharded
    port's: rank r's scale and zero point, and its codes (a row-parallel
    site's: the r-th slice of the whole row's). The integer modes (true
    int8, W4A8) sum integers or a rank's whole groups over the ranks, and
    every record and the logits are the unsharded run's bit for bit. The
    fake-quant modes sum the ranks' f32 partial products after the first
    row-parallel site, which rounds otherwise than one product, as under
    ``none`` (the reference's tp bar, 2e-4): every record up to that site
    is exact; after it the ranges move by ulps and a code lands on the
    other side of a rounding boundary now and then, which the next ranges
    carry (counted and printed); the logits then part by at most a flipped
    code's effect (``FLIP_BAR``) and the tokens at most at a near tie."""
    one, ranks = modes[mode[0]]
    want = one["quant_records"]
    assert want, "no activation quantization recorded"
    for rep in ranks:
        got = rep["quant_records"]
        assert len(got) == len(want)
        k = _first_cut(got, want)
        moved = flipped = 0
        for i, (g, w) in enumerate(zip(got, want)):
            codes = w["codes"]
            if g["codes"].shape != codes.shape:
                n = g["codes"].shape[-1]
                codes = codes[..., rep["rank"] * n:(rep["rank"] + 1) * n]
            if _integer(mode) or i <= k:
                np.testing.assert_array_equal(g["scale"], w["scale"])
                np.testing.assert_array_equal(g["zero"], w["zero"])
                np.testing.assert_array_equal(g["codes"], codes)
                continue
            moved += int(not np.array_equal(g["scale"], w["scale"]))
            flipped += int((g["codes"] != codes).sum())
        np.testing.assert_array_equal(rep["logits"], ranks[0]["logits"])
        err = float(np.abs(rep["logits"] - one["logits"]).max())
        print(f"{mode[0]} rank {rep['rank']}: {len(want)} quantizations, "
              f"exact through #{k} (the first row-parallel site); after "
              f"it {moved} ranges moved, {flipped} codes flipped; logits "
              f"max |tp - one rank| {err:.3g}")
        if _integer(mode):
            np.testing.assert_array_equal(rep["logits"], one["logits"])
            np.testing.assert_array_equal(rep["tokens"], one["tokens"])
        else:
            assert err <= FLIP_BAR
            _tokens_up_to_tie(rep["tokens"], one["tokens"], rep["margins"],
                              f"{mode[0]} tp vs one rank")


@pytest.mark.parametrize("mode", MODES, ids=[m[0] for m in MODES])
def test_tp2_modes_match_jax_unsharded(tiny, modes, mode, monkeypatch):
    """Prefill logits against JAX's unsharded Engine and its greedy tokens
    up to the first near tie. Within 2e-4 (the reference's tp bar in f32)
    where no code flips; on this input the unsharded port and JAX already
    part by flipped codes under the fake-quant modes and true-int8
    ptoken (an ulp upstream puts a value on the other side of a rounding
    boundary), so those are held to ``FLIP_BAR``. W4A8: within the
    reference's bar between its routes (rtol 1e-4, atol 1e-3) of the
    Pallas route, whose per-group order the port's kernel keeps; the jnp
    route, which folds the scales otherwise, parts from the Pallas route
    itself by flipped codes on this input, and the port is held as close
    to it as the Pallas route is, plus that bar."""
    one, ranks = modes[mode[0]]
    if mode[3] == 4:
        monkeypatch.setattr(flags, "W4A8_KERNEL", "pallas")
        pallas_logits, pallas = _jax_ref(tiny, mode)
        monkeypatch.setattr(flags, "W4A8_KERNEL", "jnp")
        jnp_logits, _ = _jax_ref(tiny, mode)
        routes = float(np.abs(pallas_logits - jnp_logits).max())
        for rep in ranks:
            np.testing.assert_allclose(rep["logits"], pallas_logits,
                                       rtol=W4_RTOL, atol=W4_ATOL)
            np.testing.assert_array_equal(rep["tokens"], pallas)
            err = float(np.abs(rep["logits"] - jnp_logits).max())
            print(f"w4a8 rank {rep['rank']}: |tp - JAX pallas| "
                  f"{np.abs(rep['logits'] - pallas_logits).max():.3g}, "
                  f"|tp - JAX jnp| {err:.3g}, JAX's routes apart "
                  f"{routes:.3g}")
            assert err <= routes + W4_ATOL
        return
    want_logits, want = _jax_ref(tiny, mode)
    bar = TOL if mode[0] == "pt_dynamic-int8" else FLIP_BAR
    for rep in ranks + [one]:
        err = float(np.abs(rep["logits"] - want_logits).max())
        print(f"{mode[0]} {'rank %d' % rep['rank'] if rep in ranks else 'one rank'}"
              f": prefill logits max |port - JAX| {err:.3g} (bar {bar})")
        np.testing.assert_allclose(rep["logits"], want_logits, rtol=bar,
                                   atol=bar)
    for rep in ranks:
        _tokens_up_to_tie(rep["tokens"], want, rep["margins"],
                          f"{mode[0]} tp vs JAX")


# ---------------------------------------------------------------------------
# 3. The kernels' new modes, plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ptoken_given_range_from_halves_equals_whole_row(dtype):
    """The range-only mode on each half of a row, their min and max, then
    the given-range mode on each half: the whole row's codes, scale and
    zero (``act_quant_ptoken`` and, in f32, JAX's oracle
    ``ref.act_quant_ref``)."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy((rs.randn(6, 96) * 2 + 0.3).astype(np.float32))
    x[2] = 0.0
    x[3] = x[3].abs()
    x = x.to(dtype)
    codes, scale, zero = act_quant_ptoken(x)
    halves = (x[:, :48].contiguous(), x[:, 48:].contiguous())
    rngs = [act_quant_ptoken_range(h) for h in halves]
    mn = torch.minimum(rngs[0][0], rngs[1][0])
    mx = torch.maximum(rngs[0][1], rngs[1][1])
    parts = [act_quant_ptoken(h, rng=(mn, mx)) for h in halves]
    assert torch.equal(torch.cat([p[0] for p in parts], 1), codes)
    for p in parts:
        assert torch.equal(p[1], scale) and torch.equal(p[2], zero)
    if dtype == torch.float32:
        jc, js, jz = R.act_quant_ref(jnp.asarray(x.numpy()), bits=8,
                                     per_token=True)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
        np.testing.assert_array_equal(zero.numpy(), np.asarray(jz))


@pytest.mark.parametrize("M,K,group", [(4, 256, 64), (20, 512, 128)])
def test_w4a8_accumulator_mode_plus_epilogue(M, K, group):
    """``accumulate=True`` then ``w4a8_epilogue`` is ``w4a8_matmul`` bit for
    bit; the sum of the two K halves' accumulators (each half's own group
    scales) plus the epilogue is within f32 accumulation of it and of
    JAX's ``ref.w4a8_matmul_ref``."""
    rs = np.random.RandomState(M)
    N = 48
    x = torch.from_numpy(rs.randint(-128, 128, (M, K)).astype(np.int8))
    wq = torch.from_numpy(rs.randint(-7, 8, (K, N)).astype(np.int8))
    s_w = torch.from_numpy(rs.rand(K // group, N).astype(np.float32) * 0.02)
    colsum = (wq.to(torch.int32).reshape(K // group, group, N).sum(1)
              .float() * s_w).sum(0)
    s_x, z_x = torch.tensor(0.031), torch.tensor(7.0)
    wp = TQ.pack_int4(wq)
    whole = w4a8_matmul(x, wp, s_x, z_x, s_w, colsum, group, -128.0)
    acc = w4a8_matmul(x, wp, s_x, z_x, s_w, None, group, accumulate=True)
    assert torch.equal(w4a8_epilogue(acc, s_x, z_x, colsum, -128.0), whole)
    h, gh = K // 2, K // group // 2
    parts = [w4a8_matmul(x[:, i * h:(i + 1) * h].contiguous(),
                         wp[i * h // 2:(i + 1) * h // 2].contiguous(), s_x,
                         z_x, s_w[i * gh:(i + 1) * gh].contiguous(), None,
                         group, accumulate=True) for i in range(2)]
    split = w4a8_epilogue(parts[0] + parts[1], s_x, z_x, colsum, -128.0)
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=W4_RTOL,
                               atol=W4_ATOL)
    ref = R.w4a8_matmul_ref(jnp.asarray(x.numpy()), jnp.asarray(wp.numpy()),
                            jnp.float32(0.031), jnp.float32(7.0 - 128.0),
                            jnp.asarray(s_w.numpy()), group)
    np.testing.assert_allclose(split.numpy(), np.asarray(ref), rtol=W4_RTOL,
                               atol=W4_ATOL)


# ---------------------------------------------------------------------------
# FSDP cut on both axes: tensor-parallel training on a (data 2, model 2) mesh
# ---------------------------------------------------------------------------

def test_fsdp_on_both_axes_matches_jax_and_keeps_its_shards(tiny,
                                                            router_runs):
    """``shard_train_step`` on a (data 2, model 2) mesh, six steps of
    paper_tiny (one row a data rank): the first step's loss, CE and
    gradient norm within 1e-5 relative of JAX's one device, the parameters
    after six steps (each rank's tensor-parallel part, gathered over data)
    at the resume bar with the Adam allowance against JAX and against the
    port's one rank; the four ranks' metrics equal. Each rank holds only
    its shard of every "D" and "M" leaf, and f32 moments of that shard."""
    ranks = router_runs["train-2x2"]
    cfg = t_get_config("paper_tiny")
    jref = TRF.reference(tiny["japi"], tiny["params"], cfg,
                         TRF.batches(tiny["jcfg"].vocab_size), qat=False)
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
    m0, jm = ranks[0]["metrics"][0], jref["metrics"][0]
    rel = {k: abs(m0[k] / jm[k] - 1) for k in ("loss", "ce", "grad_norm")}
    print(f"(data 2, model 2) vs JAX, step 0, relative: {rel}")
    assert max(rel.values()) <= TRF.FIRST_STEP
    lrs = TRF.lr_sum()
    for r in ranks:
        TRF.assert_params_close(
            TRF.flat(r["params"]), TRF.cut(jref["params"], cfg,
                                           r["tp_rank"], 2), lrs,
            f"rank ({r['rank']}, {r['tp_rank']}) vs JAX after six steps")
        if "one" in r:
            for path, d in r["one"]["diffs"].items():
                assert d["past"] <= TRF.ADAM_SHARE, path
                assert d["worst_past"] <= lrs, path
        held = 0
        for path, leaf in r["leaves"].items():
            spec, own = leaf["spec"], leaf["part"][0]
            # paper_tiny at tp = 2 cuts every leaf the rules name "model"
            assert (own == -1) == ("model" in spec), path
            want = leaf["full"] // (2 if "data" in spec else 1) \
                // (2 if "model" in spec else 1)
            assert leaf["shard"] == want, path
            assert leaf["moments"] == 2 * want
            assert leaf["moment_dtype"] == "torch.float32"
            held += want
        assert r["shard_bytes"] == 4 * held
        print(f"rank ({r['rank']}, {r['tp_rank']}) holds {r['shard_bytes']} "
              f"of {r['full_bytes']} parameter bytes")
        assert r["shard_bytes"] < 0.3 * r["full_bytes"]
    assert sum("one" in r for r in ranks) == 2
