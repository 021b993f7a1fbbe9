"""Port parity, the xLSTM (``repro_torch.models.xlstm``) against the JAX
package on the same weights (JAX's, carried across through
``models/convert.py``), CushionState, scales and numpy inputs, in f32, on
``reduced(xlstm-350m)``: 2 (mLSTM, sLSTM) pairs, d_model 64, 4 heads of
32 (inner 128).

Tolerances, measured on the CPU with JAX's functions jitted (the tests
print what they measure: ``pytest -s``):

* ``_mlstm_mix`` (quadratic) and ``apply_mlstm`` chunked at a chunk of 4
  (``S % chunk == 0`` reached), with and without an initial state: h and
  the final state within 1e-5 relative and 1e-5 absolute (the chunked
  form sums the chunks' contributions in the order of the reference's
  scan, but its einsums associate otherwise: measured 1e-6).
* ``decode_mlstm`` / ``decode_slstm``: outputs and states within 1e-5.
* ``forward`` under a CushionState: logits within 1e-4 under ``none`` and
  ``pt_dynamic`` / ``pt_static``; a site's L_q within 1e-4 relative under
  ``none`` and 2e-3 under the quantized modes; amin / amax / absmax_ch
  within 1e-5. Under ``ptoken_dynamic`` a code flipped by a one-ulp
  difference travels along the recurrences: logits within ``TIE`` = 0.1,
  L_q and the ranges within 5e-2 relative (the hybrid's bars).
* Prefill + decode against ``forward`` (the teacher-forced logits, 1e-4)
  and against JAX (logits within 1e-4, the state within 1e-5).
* Greedy tokens of both engines and of the search: identical; resident
  weight bytes JAX's three counts.
* The loss under ``none``: CE, L_q and the total within 1e-5 relative.
* The tuning under ``none``: logs within 1e-5 relative, the tuned state
  within 1e-4 (measured 2.9e-5 at one of C's 8,192 entries: Adam moves an
  element by about lr a step whatever its gradient's size, so an entry
  with a tiny gradient parts); every leaf of the state tree moves.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.store import CheckpointManager as JStore  # noqa: E402
from repro.configs import (CushionConfig, QuantConfig, get_config,  # noqa: E402
                           reduced)
from repro.core import calibration as JCal  # noqa: E402
from repro.core import cushioncache as JCC  # noqa: E402
from repro.core import quantization as JQ  # noqa: E402
from repro.core import smoothquant as JSQ  # noqa: E402
from repro import monitoring as JMON  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro.serving import ContinuousEngine as JContinuous  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch import monitoring as TMON  # noqa: E402
from repro_torch.checkpoint.store import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import calibration as TCal  # noqa: E402
from repro_torch.core import cushioncache as TCC  # noqa: E402
from repro_torch.core import quantization as TQ  # noqa: E402
from repro_torch.core import smoothquant as TSQ  # noqa: E402
from repro_torch.launch import serve, tune  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.scheduler import ContinuousEngine, Request  # noqa: E402

QN = QuantConfig()
QD = QuantConfig(mode="pt_dynamic")
QW8 = QuantConfig(mode="pt_static", true_int8=True)
QPT = QuantConfig(mode="ptoken_dynamic")
QMODES = {"none": QN, "pt_dynamic": QD, "pt_static": QW8,
          "ptoken_dynamic": QPT}
ARCH = "xlstm-350m"
TIE = 0.1


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def configs():
    return (reduced(get_config(ARCH), dtype="float32"),
            t_reduced(t_get_config(ARCH), dtype="float32"))


def _cmp_tree(t, j, atol=1e-5, rtol=1e-5):
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(np_tree(j))[0],
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(lambda x: x.detach().numpy(), t))[0]):
        assert pa == pb
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                   err_msg=str(pa))


@pytest.fixture(scope="module")
def xl():
    jcfg, tcfg = configs()
    japi = j_build(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(1))
    jcushion = japi.extract_cushion(
        jparams, jnp.asarray([7, 2, 11, 5], jnp.int32), None, QN)
    rs = np.random.RandomState(0)
    calib = rs.randint(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jscales, _ = JCal.calibrate(japi, jparams,
                                [{"tokens": jnp.asarray(calib)}], QW8,
                                cushion=jcushion)
    params = convert.params_from_numpy(np_tree(jparams))
    return dict(
        jcfg=jcfg, tcfg=tcfg, japi=japi, api=build(tcfg, "cpu"),
        jparams=jparams, params=params.tree(), jcushion=jcushion,
        cushion=convert.cushion_from_numpy(np_tree(jcushion)),
        jscales=jscales, scales=convert.scales_from_numpy(
            np_tree(JCal.scales_to_plain(jscales))),
        calib=calib, tokens=rs.randint(0, jcfg.vocab_size, (2, 12))
        .astype(np.int32), vocab=jcfg.vocab_size)


def _pair0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# ---------------------------------------------------------------------------
# the mLSTM and the sLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["quadratic", "chunked"])
@pytest.mark.parametrize("init", [False, True])
def test_mlstm_matches_jax(xl, form, init):
    """``apply_mlstm`` over 16 positions, quadratic (chunk 0) or chunkwise
    at a chunk of 4, from a fresh or a cushion state: the block's output
    and the final state, and ``_mlstm_mix`` on the same q, k, v, gates."""
    s = xl
    chunk = 0 if form == "quadratic" else 4
    x = np.random.RandomState(3).randn(2, 16, 64).astype(np.float32)
    jp, tp = _pair0(s["jparams"]["layers"])["mlstm"], \
        _pair0(s["params"]["layers"])["mlstm"]
    jst = tst = None
    if init:
        jst = jax.tree.map(lambda a: jnp.broadcast_to(a[0][None],
                                                      (2,) + a.shape[1:]),
                           s["jcushion"]["state"]["m"])
        tst = {k: v[0][None].expand(2, *v.shape[1:])
               for k, v in s["cushion"]["state"]["m"].items()}
    jo, jfin = JX.apply_mlstm(jp, jnp.asarray(x), s["jcfg"], QN, None, None,
                              init_state=jst, return_state=True, chunk=chunk)
    to, tfin = TX.apply_mlstm(tp, torch.from_numpy(x), s["tcfg"], QN, None,
                              None, init_state=tst, return_state=True,
                              chunk=chunk)
    err = np.abs(to.numpy() - np.asarray(jo)).max()
    print(f"[{form}, init {init}] out max |port - JAX| {err:.2e}")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    _cmp_tree(tfin, jfin)
    if form == "quadratic":
        args = JX._mlstm_qkvif(jp, jnp.asarray(x), s["jcfg"], QN, None, None,
                               0)[:5]
        jh, jmix = JX._mlstm_mix(*args, jst, True)
        th, tmix = TX._mlstm_mix(*(torch.from_numpy(np.array(a))
                                   for a in args), tst, True)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                                   atol=1e-5)
        _cmp_tree(tmix, jmix)


def test_decode_mlstm_and_slstm_match_jax(xl):
    """One recurrent step of each block from the cushion's state."""
    s = xl
    x = np.random.RandomState(4).randn(2, 1, 64).astype(np.float32)
    jl, tl = _pair0(s["jparams"]["layers"]), _pair0(s["params"]["layers"])
    for blk, grp, jf, tf in (("mlstm", "m", JX.decode_mlstm, TX.decode_mlstm),
                             ("slstm", "s", JX.decode_slstm,
                              TX.decode_slstm)):
        jst = jax.tree.map(lambda a: jnp.broadcast_to(
            a[0][None], (2,) + a.shape[1:]).astype(jnp.float32),
            s["jcushion"]["state"][grp])
        tst = {k: v[0][None].expand(2, *v.shape[1:]).float()
               for k, v in s["cushion"]["state"][grp].items()}
        jo, jnew = jf(jl[blk], jnp.asarray(x), jst, s["jcfg"], QN, None)
        to, tnew = tf(tl[blk], torch.from_numpy(x), tst, s["tcfg"], QN, None)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                                   atol=1e-5, err_msg=blk)
        _cmp_tree(tnew, jnew)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(QMODES))
def test_forward_logits_and_taps_match_jax(xl, mode):
    s = xl
    qcfg = QMODES[mode]
    static = mode == "pt_static"
    js, ts = (s["jscales"], s["scales"]) if static else (None, None)
    jl, jt = jax.jit(lambda p, t: s["japi"].forward(
        p, {"tokens": t}, qcfg, scales=js, cushion=s["jcushion"],
        collect=True, remat=False))(s["jparams"], jnp.asarray(s["tokens"]))
    tl, tt = s["api"].forward(s["params"],
                              {"tokens": torch.from_numpy(s["tokens"])},
                              qcfg, scales=ts, cushion=s["cushion"],
                              collect=True)
    err = np.abs(tl.numpy() - np.asarray(jl)).max()
    print(f"[{mode}] logits max |port - JAX| {err:.2e}")
    flip = mode == "ptoken_dynamic"
    assert err <= (TIE if flip else 1e-4), err
    q_tol = 1e-4 if mode == "none" else (5e-2 if flip else 2e-3)
    r_tol = 5e-2 if flip else 1e-5
    assert set(tt) == set(jt)
    for site in TX.SITES:
        for key, rtol in (("qerr", q_tol), ("amin", r_tol),
                          ("amax", r_tol), ("absmax_ch", r_tol)):
            np.testing.assert_allclose(
                tt["layers"][site][key].numpy(),
                np.asarray(jt["layers"][site][key]), rtol=rtol,
                atol=0 if key == "qerr" else 1e-5, err_msg=f"{site}.{key}")
    np.testing.assert_allclose(float(TX.total_qerr(tt)),
                               float(JX.T.total_qerr(jt)), rtol=q_tol)


def test_loss_fn_matches_jax(xl):
    """CE + λ·L_q under ``none``, with n_skip. (Under pt_dynamic the
    reference's jitted loss is 1.6e-3 from its own eager one on this batch,
    CE 5.6352 against 5.6440, and the port's within 1e-6 of the eager one:
    measured, not held here, as the eager reference takes ~17 s.)"""
    s = xl
    toks = np.random.RandomState(8).randint(0, s["vocab"], (2, 13)) \
        .astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jaux = jax.jit(lambda p, b: s["japi"].loss_fn(
        p, b, QN, cushion=s["jcushion"], collect=True, remat=False, lam=0.5,
        n_skip=2))(s["jparams"], jax.tree.map(jnp.asarray, batch))
    tl, taux = s["api"].loss_fn(s["params"], to_torch(batch), QN,
                                cushion=s["cushion"], collect=True, lam=0.5,
                                n_skip=2)
    for k in ("ce", "qerr"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_cushion_zeros_and_extract_cushion_match_jax(xl):
    """The CushionState: zeros at -30 in the model dtype; extracted, the
    state after the prefix (f32), as the reference's."""
    s = xl
    z, jz = s["api"].cushion_zeros(3), s["japi"].cushion_zeros(3)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(np_tree(jz))[0],
            jax.tree_util.tree_flatten_with_path(np_tree(z))[0]):
        assert pa == pb and a.shape == b.shape and a.dtype == b.dtype, pa
        np.testing.assert_array_equal(a, b)
    got = s["api"].extract_cushion(s["params"], torch.tensor([7, 2, 11, 5]),
                                   None, QN)
    _cmp_tree(got, s["jcushion"])
    assert got["state"]["m"]["C"].dtype == torch.float32


def test_calibration_scales_match_jax(xl):
    s = xl
    tsc, _ = TCal.calibrate(s["api"], s["params"],
                            [{"tokens": torch.from_numpy(s["calib"])}], QW8,
                            cushion=s["cushion"])
    assert set(tsc) == set(TX.SITES) | {"head"}
    for site, t in tsc.items():
        j = s["jscales"][site]
        np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale),
                                   rtol=1e-5, err_msg=site)
        np.testing.assert_array_equal(t.zero.numpy(), np.asarray(j.zero))
    assert tsc["s_in"].scale.shape == (2,)


def test_smoothquant_raises_for_xlstm(xl):
    s = xl
    with pytest.raises(NotImplementedError, match="no exact fold"):
        JSQ.apply_smoothquant(s["jparams"], {"layers": {}}, s["jcfg"])
    with pytest.raises(NotImplementedError, match="no exact fold"):
        TSQ.apply_smoothquant(s["params"], {"layers": {}}, s["tcfg"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_prefill_decode_match_forward_and_jax(xl):
    """Prefill 8 positions from the cushion's state, decode 4 more: the
    teacher-forced forward's logits and JAX's; every state leaf is written
    in place."""
    s = xl
    api, japi = s["api"], s["japi"]
    toks = s["tokens"]
    full, _ = api.forward(s["params"], {"tokens": torch.from_numpy(toks)},
                          QN, cushion=s["cushion"])
    cache = api.init_cache(2, 0)
    jcache = japi.init_cache(2, 0)
    leaves = jax.tree.map(lambda t: t, cache)
    tl, cache, pos = api.prefill(s["params"],
                                 {"tokens": torch.from_numpy(toks[:, :8])},
                                 cache, QN, cushion=s["cushion"])
    jl, jcache, jpos = jax.jit(lambda p, t, c: japi.prefill(
        p, {"tokens": t}, c, QN, cushion=s["jcushion"]))(
            s["jparams"], jnp.asarray(toks[:, :8]), jcache)
    assert int(pos) == int(jpos) == 8
    np.testing.assert_allclose(tl[:, 0].numpy(), full[:, 7].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _cmp_tree(cache, jcache)
    jdec = jax.jit(lambda p, t, c: japi.decode_step(p, t, jpos, c, QN))
    for i in range(8, 12):
        tl, cache = api.decode_step(s["params"], torch.from_numpy(toks[:, i]),
                                    pos, cache, QN)
        jl, jcache = jdec(s["jparams"], jnp.asarray(toks[:, i]), jcache)
        np.testing.assert_allclose(tl.numpy(), full[:, i].numpy(), atol=1e-4)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _cmp_tree(cache, jcache)
    for g in leaves:
        for k in leaves[g]:
            assert cache[g][k] is leaves[g][k]


@pytest.mark.parametrize("mode", ["none", "pt_static", "pt_static_prequant",
                                  "ptoken_dynamic"])
def test_engine_tokens_and_resident_bytes_match_jax(xl, mode):
    """Only ``w_proj`` becomes int8-resident (the reference's key list names
    ``wqkv``, not ``w_qkv``, and the sLSTM's ``w`` is not a head's): JAX's
    three byte counts."""
    s = xl
    qcfg = {"none": QN, "ptoken_dynamic": QPT}.get(mode, QW8)
    static = qcfg is QW8
    kw = dict(cushion=s["cushion"], max_seq=64,
              scales=s["scales"] if static else None,
              prequant=mode.endswith("prequant"))
    jkw = dict(kw, cushion=s["jcushion"],
               scales=s["jscales"] if static else None)
    jeng = JEngine(s["japi"], s["jparams"], qcfg, **jkw)
    eng = Engine(s["api"], s["params"], qcfg, **kw)
    jt = jeng.generate({"tokens": jnp.asarray(s["tokens"])}, 6).tokens
    tt = eng.generate({"tokens": torch.from_numpy(s["tokens"])}, 6).tokens
    np.testing.assert_array_equal(tt, np.asarray(jt))
    got = (eng.weight_bytes_fp, eng.weight_bytes_int8, eng.weight_bytes_int4)
    assert got == (jeng.weight_bytes_fp, jeng.weight_bytes_int8,
                   jeng.weight_bytes_int4)
    if kw["prequant"]:
        assert got == (732500, 49152, 0)
        pre = eng.params.tree()["layers"]
        assert pre["mlstm"]["w_proj"]["w_int"].dtype == torch.int8
        assert isinstance(pre["mlstm"]["w_qkv"], torch.Tensor)
        assert isinstance(pre["slstm"]["w"], torch.Tensor)
        assert got == TMON.resident_weight_bytes(
            TQ.prequantize_tree(s["params"], QW8)) == \
            JMON.resident_weight_bytes(JQ.prequantize_tree(s["jparams"],
                                                           QW8))


def test_int8_kv_and_paged_are_refused(xl):
    s = xl
    with pytest.raises(ValueError, match="kv_dtype"):
        s["japi"].init_cache(1, 16, kv_dtype="int8")
    with pytest.raises(ValueError, match="kv_dtype"):
        s["api"].init_cache(1, 16, kv_dtype="int8")
    with pytest.raises(ValueError, match="pageable"):
        ContinuousEngine(s["api"], s["params"], QN, n_slots=2, max_seq=64,
                         paged=True, page_size=32)


def test_pool_with_nested_axes_matches_engine_and_jax(xl):
    """Five requests through 2 W8A8 slots (int8-resident ``w_proj``): the
    state tree is scattered leaf by leaf along the nested axes, slots
    recycle; JAX's tokens, slots and ServeStats, and the port's static B=1
    Engine's tokens. A pool of state never runs out of positions."""
    s = xl
    rs = np.random.RandomState(100)
    toks = [rs.randint(0, s["vocab"], (1, [8, 12][i % 2])).astype(np.int32)
            for i in range(5)]
    budgets = [5, 3, 6, 4, 5]
    jreqs = [JRequest(uid=i, batch={"tokens": jnp.asarray(t)},
                      max_new_tokens=n)
             for i, (t, n) in enumerate(zip(toks, budgets))]
    treqs = [Request(uid=i, batch={"tokens": torch.from_numpy(t)},
                     max_new_tokens=n)
             for i, (t, n) in enumerate(zip(toks, budgets))]
    kw = dict(n_slots=2, max_seq=16, prequant=True)
    ce = ContinuousEngine(s["api"], s["params"], QW8, cushion=s["cushion"],
                          scales=s["scales"], **kw)
    assert ce.cache["m"]["C"].shape[1] == 2
    assert not ce._seq_cache
    jce = JContinuous(s["japi"], s["jparams"], QW8, cushion=s["jcushion"],
                      scales=s["jscales"], **kw)
    outs, jouts = ce.run(treqs), jce.run(jreqs)
    assert [o.uid for o in outs] == [o.uid for o in jouts]
    for a, b in zip(jouts, outs):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.slot == a.slot
    assert ce.stats.as_dict() == jce.stats.as_dict()
    assert ce.stats.recycles >= 1
    eng = Engine(s["api"], s["params"], QW8, cushion=s["cushion"],
                 scales=s["scales"], max_seq=64, prequant=True)
    for r, o in zip(treqs, outs):
        np.testing.assert_array_equal(
            eng.generate(r.batch, r.max_new_tokens).tokens[0], o.tokens)


# ---------------------------------------------------------------------------
# the method, the artifact
# ---------------------------------------------------------------------------

def test_greedy_search_falls_back_and_matches_jax_tokens(xl, monkeypatch):
    s = xl
    assert not s["api"].supports_kv_scoring
    ccfg = CushionConfig(max_prefix_len=2, tau=1.5, n_candidates=16,
                         seed_tokens=(1,))
    jsample = {0: s["japi"].make_batch(jax.random.PRNGKey(1000), 1, 12)}
    jres = JCC.greedy_search(s["japi"], s["jparams"], lambda i: jsample[i],
                             QD, ccfg, jax.random.PRNGKey(0), chunk=8,
                             verbose=False)
    rng, k1, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    pool = JCC.candidate_pool(k1, s["vocab"], ccfg.n_candidates,
                              ccfg.seed_tokens)
    monkeypatch.setattr(TCC, "candidate_pool", lambda *a, **k: pool)
    res = TCC.greedy_search(s["api"], s["params"],
                            lambda i: to_torch(jsample[i]), QD, ccfg,
                            torch.Generator(), chunk=8, verbose=False)
    np.testing.assert_array_equal(res.prefix_ids, jres.prefix_ids)
    for h, jh in zip(res.history, jres.history):
        assert h["best_tok"] == jh["best_tok"]
        np.testing.assert_allclose([h["base_err"], h["best_err"]],
                                   [jh["base_err"], jh["best_err"]],
                                   rtol=1e-2)


def test_prefix_tune_moves_every_leaf_and_matches_jax(xl):
    """The CushionState has no "kv": the whole tree trains. Three steps
    under ``none``: logs and every tuned leaf as JAX's, every leaf moved,
    all finite (the -inf of the masked decays gives no NaN gradient)."""
    s = xl
    batches = [s["japi"].make_batch(jax.random.PRNGKey(3000 + i), 2, 12)
               for i in range(3)]
    ccfg = CushionConfig(tune_steps=3, tune_lr=1e-3, lam=0.05, log_every=2)
    jtr = JCC.prefix_tune(s["japi"], s["jparams"], s["jcushion"],
                          iter(batches), QN, ccfg, verbose=False)
    ttr = TCC.prefix_tune(s["api"], s["params"], s["cushion"],
                          (to_torch(b) for b in batches), QN, ccfg,
                          verbose=False)
    err = max(abs(t[k] / j[k] - 1) for t, j in zip(ttr.log, jtr.log)
              for k in ("loss", "ce", "range", "qerr", "gnorm"))
    print(f"tuning logs, none: max relative |port - JAX| {err:.2e}")
    assert err <= 1e-5, err
    _cmp_tree(ttr.cushion, jtr.cushion, atol=1e-4)
    for g, leaves in ttr.cushion["state"].items():
        for k, v in leaves.items():
            assert torch.isfinite(v).all(), (g, k)
            assert not torch.equal(v, s["cushion"]["state"][g][k]), (g, k)


def test_state_artifact_round_trips_both_ways(xl, tmp_path):
    s = xl
    fp = TCC.cushion_fingerprint(s["cushion"])
    assert fp == JCC.cushion_fingerprint(s["jcushion"])
    CheckpointManager(str(tmp_path / "t")).save(
        1, {"cushion": s["cushion"]}, extra={"f": fp})
    jtree, _ = JStore(str(tmp_path / "t")).restore_tree(1)
    JStore(str(tmp_path / "j")).save(1, {"cushion": s["jcushion"]})
    ttree, _ = CheckpointManager(str(tmp_path / "j")).restore_tree(1)
    _cmp_tree(ttree["cushion"], jtree["cushion"], atol=0, rtol=0)
    assert TCC.cushion_fingerprint(ttree["cushion"]) == fp
    like = TCC.cushion_fingerprint(CheckpointManager(
        str(tmp_path / "j")).restore(1, {"cushion": s["cushion"]})["cushion"])
    assert like == fp


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def test_launchers_tune_and_serve_on_cpu(tmp_path, monkeypatch):
    """``--arch xlstm-350m`` at the reduced size: tune writes a state
    artifact, serve loads the two-level tree and serves it statically and
    in a pool; an int8 KV cache is refused."""
    red = configs()[1]
    for mod in (serve, tune):
        monkeypatch.setattr(mod, "get_config",
                            lambda a: red if a == ARCH else None)
    out = tmp_path / "art"
    tune.main(["--device", "cpu", "--arch", ARCH, "--out-dir", str(out),
               "--max-prefix-len", "2", "--candidates", "8",
               "--sample-len", "8", "--steps", "2", "--log-every", "2",
               "--seq-len", "8", "--eval-batches", "1", "--with-scales"])
    res = serve.main(["--device", "cpu", "--arch", ARCH, "--quant",
                      "pt_static", "--prequant", "--cushion", str(out),
                      "--tokens", "3", "--prompt-len", "8", "--batch", "2"])
    assert res.tokens.shape == (2, 3)
    outs = serve.main(["--device", "cpu", "--arch", ARCH, "--mode",
                       "continuous", "--cushion-len", "2", "--rate", "0",
                       "--n-requests", "3", "--prompt-len", "8",
                       "--tokens", "3"])
    assert len(outs) == 3
    with pytest.raises(ValueError, match="kv_dtype"):
        serve.main(["--device", "cpu", "--arch", ARCH, "--kv-dtype", "int8",
                    "--tokens", "2", "--prompt-len", "8"])
