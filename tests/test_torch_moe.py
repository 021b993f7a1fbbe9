"""Port parity, the MoE family (``repro_torch.models.moe``) against the JAX
package on the same weights (JAX's, carried across through
``models/convert.py``), cushion, scales and numpy inputs, in f32.

Configurations: ``reduced(olmoe-1b-7b)`` (4 layers, d_model 64, 8 experts,
top-2) in two settings: ``dropless`` (``reduced``'s capacity factor 64)
and ``drops`` (capacity factor 1.25, olmoe's own, with every layer's
router planted so that expert 0 overflows and (token, k) entries drop);
``reduced(arctic-480b)`` for the dense residual branch.

Tolerances, measured on the CPU with JAX's function jitted (the tests
print what they measure: ``pytest -s``):

* ``capacity``, the dispatch and the routing: exact.
* ``apply_moe``: y within 1e-5 (f32 matmuls summed in another order:
  measured up to 6.3e-7 over four seeds) and lb within 1e-6 (measured
  4.8e-7). Under the
  dynamic modes one token row of a call may sit further off, within 2e-2:
  a one-ulp difference of an expert's hidden activation moves one code of
  the ``down`` site across a rounding boundary (measured 6.7e-3 on one of
  48 rows, in one of four seeds).
* ``forward``: logits within 1e-4 (the model tests' bar; measured 8.1e-6
  under ``none``); under a quantized mode one position may sit up to 0.1
  off (``test_torch_ptoken.py``'s ``PTOKEN_TIE``): a one-ulp difference
  upstream flips a code at a later site, the head's included (measured
  8.9e-3 under pt_static, up to 9.1e-3 under ptoken_dynamic over three
  seeds). A site's L_q within 1e-4 relative under ``none`` (measured
  1.2e-5: L_q quantizes with dynamic ranges in every mode) and 2e-3 under
  the quantized modes (the JAX package's own bar for its dynamic modes;
  measured 1.9e-4); a site's amin / amax / absmax_ch within 1e-5.
* Caches: fp within 1e-5; int8 codes off by at most one at under 0.1% of
  entries, the cushion block bit-exact (``test_torch_model.py``).
* Greedy tokens of every engine: identical.
* Calibration scales within 1e-5 relative; search scores within 1e-4
  relative under ``none`` and 2e-3 under the dynamic modes, the same
  argmin and the same searched tokens; the first tuning losses within the
  method's f32 ``none`` bar, 1e-5 relative (measured 1.6e-6 on paper_tiny,
  ``test_torch_tune.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import (CushionConfig, QuantConfig, get_config,  # noqa: E402
                           reduced)
from repro.core import calibration as JCal  # noqa: E402
from repro.core import cushioncache as JCC  # noqa: E402
from repro.core import outliers as JOUT  # noqa: E402
from repro.core import quantization as JQ  # noqa: E402
from repro import monitoring as JMON  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro.serving import ContinuousEngine as JContinuous  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import _ARCH_MODULES as T_ARCHS  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import calibration as TCal  # noqa: E402
from repro_torch.core import cushioncache as TCC  # noqa: E402
from repro_torch.core import outliers as TOUT  # noqa: E402
from repro_torch.core import quantization as TQ  # noqa: E402
from repro_torch.launch import serve, tune  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.monitoring import resident_weight_bytes  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.scheduler import ContinuousEngine, Request  # noqa: E402

QN = QuantConfig()
QD = QuantConfig(mode="pt_dynamic")
QW8 = QuantConfig(mode="pt_static", true_int8=True)
QPT = QuantConfig(mode="ptoken_dynamic")
QMODES = {"none": QN, "pt_dynamic": QD, "pt_static": QW8,
          "ptoken_dynamic": QPT}
DYNAMIC = ("pt_dynamic", "ptoken_dynamic")
SETTINGS = ("dropless", "drops")
PLANT = 1.0         # added to expert 0's router column in every layer
PTOKEN_TIE = 0.1


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def configs(arch="olmoe-1b-7b", cf=None, **kw):
    jcfg = reduced(get_config(arch), dtype="float32", **kw)
    tcfg = t_reduced(t_get_config(arch), dtype="float32", **kw)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=cf))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=cf))
    return jcfg, tcfg


def _setup(setting):
    jcfg, tcfg = configs(cf=None if setting == "dropless" else 1.25)
    japi = j_build(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(1))
    if setting == "drops":
        r = jparams["layers"]["moe"]["router"]
        jparams["layers"]["moe"]["router"] = r.at[:, :, 0].add(PLANT)
    jcushion = japi.extract_cushion(
        jparams, jnp.asarray([7, 2, 11, 5], jnp.int32), None, QN)
    rs = np.random.RandomState(0)
    calib = rs.randint(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jscales, _ = JCal.calibrate(japi, jparams,
                                [{"tokens": jnp.asarray(calib)}], QW8,
                                cushion=jcushion)
    params = convert.params_from_numpy(np_tree(jparams))
    return dict(
        jcfg=jcfg, tcfg=tcfg, japi=japi, api=build(tcfg, "cpu"),
        jparams=jparams, params=params.tree(),
        jpre=JQ.prequantize_tree(jparams, QW8),
        pre=TQ.prequantize_tree(params.tree(), QW8),
        jcushion=jcushion, cushion=convert.cushion_from_numpy(
            np_tree(jcushion)),
        jscales=jscales, scales=convert.scales_from_numpy(
            np_tree(JCal.scales_to_plain(jscales))),
        calib=calib, tokens=rs.randint(0, jcfg.vocab_size, (2, 16))
        .astype(np.int32), vocab=jcfg.vocab_size)


@pytest.fixture(scope="module", params=SETTINGS)
def olmoe(request):
    return _setup(request.param)


@pytest.fixture(scope="module")
def drops():
    return _setup("drops")


@pytest.fixture
def kept(monkeypatch):
    """Records, per ``dispatch`` call, the (token, k) entries that keep a
    slot and the entries routed."""
    seen = []
    inner = TM.dispatch

    def counting(onehot, cap):
        d = inner(onehot, cap)
        seen.append((float(d.sum()), float(onehot.sum())))
        return d
    monkeypatch.setattr(TM, "dispatch", counting)
    return seen


def _dropped(seen):
    return sum(n - k for k, n in seen)


# ---------------------------------------------------------------------------
# capacity, routing, dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,K", [(8, 2), (64, 8), (128, 2), (16, 1)])
def test_capacity_matches_jax(E, K):
    for cf in (1.0, 1.25, 2.0, 64.0):
        jcfg, tcfg = configs(cf=cf)
        moe = dict(num_experts=E, top_k=K)
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                                 **moe))
        for S in (1, 2, 3, 7, 16, 17, 64, 257, 512, 2048):
            c = TM.capacity(S, tcfg)
            assert type(c) is int
            assert c == JM.capacity(S, jcfg), (S, E, K, cf)


def test_dispatch_matches_plain_loop():
    """The slot one-hot against a loop over each row's (token, k) entries
    in s-major, k-minor order: an expert's n-th entry takes slot n, entries
    past the capacity keep none; the per-token dispatch is 0/1."""
    rs = np.random.RandomState(3)
    B, S, K, E, cap = 3, 9, 2, 4, 4
    idx = np.stack([np.stack([rs.choice(E, K, replace=False)
                              for _ in range(S)]) for _ in range(B)])
    idx[0, :, 0] = 1                         # expert 1 overflows in row 0
    onehot = (torch.from_numpy(idx)[..., None] == torch.arange(E)).float()
    got = TM.dispatch(onehot, cap).numpy()
    want = np.zeros((B, S, K, E, cap), np.float32)
    for b in range(B):
        fill = [0] * E
        for s in range(S):
            for k in range(K):
                e = idx[b, s, k]
                if fill[e] < cap:
                    want[b, s, k, e, fill[e]] = 1.0
                fill[e] += 1
    np.testing.assert_array_equal(got, want)
    assert want.sum() < B * S * K              # entries did drop


def test_route_ties_go_to_lower_index_as_jax():
    """Equal gate probabilities: the lower expert id first, as
    ``jax.lax.top_k``; the weights renormalised over the top K in f32."""
    x = np.zeros((1, 3, 4), np.float32)
    x[0, 1] = [1.0, 0.0, 0.0, 0.0]
    x[0, 2] = [0.0, 2.0, 2.0, 0.0]
    router = np.zeros((4, 6), np.float32)
    router[0, 3] = router[0, 5] = 1.0
    router[1, 1] = router[1, 4] = router[2, 1] = router[2, 4] = 1.0
    probs, top_w, top_idx = TM.route(torch.from_numpy(x),
                                     torch.from_numpy(router), 3)
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    jw, jidx = jax.lax.top_k(jprobs, 3)
    np.testing.assert_array_equal(top_idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(top_idx[0].numpy(),
                                  [[0, 1, 2], [3, 5, 0], [1, 4, 0]])
    np.testing.assert_allclose(
        top_w.numpy(), np.asarray(jw / jw.sum(-1, keepdims=True)),
        rtol=1e-6)
    assert probs.dtype == top_w.dtype == torch.float32


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------

def _site_scales():
    vals = {"mlp_in": (0.03, 128.0), "down": (0.01, 120.0)}
    j = {k: JQ.SiteScale(jnp.float32(s), jnp.float32(z))
         for k, (s, z) in vals.items()}
    t = {k: TQ.SiteScale(torch.tensor(s), torch.tensor(z))
         for k, (s, z) in vals.items()}
    return j, t


def _check_rows(got, want, mode, bar=1e-5, loose=2e-2):
    """got / want (B, S, ...): every row within ``bar``; under a dynamic
    mode one row may sit within ``loose`` (a flipped code)."""
    err = np.abs(got - want).reshape(got.shape[0] * got.shape[1], -1)
    err = err.max(-1)
    print(f"[{mode}] max |port - JAX| {err.max():.2e}, rows over {bar}: "
          f"{int((err > bar).sum())} of {err.size}")
    if mode in DYNAMIC:
        assert (err > bar).sum() <= 1, err
        assert err.max() <= loose, err.max()
    else:
        assert err.max() <= bar, err.max()


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("mode", list(QMODES))
def test_apply_moe_matches_jax(mode, setting, kept):
    """y and lb of one MoE layer on the same input, under every mode;
    under ``drops`` the planted expert overflows and entries drop, and the
    same entries keep their slots (a wrong drop moves y by O(0.1))."""
    jcfg, tcfg = configs(cf=None if setting == "dropless" else 1.25)
    jp = JM.moe_init(jax.random.PRNGKey(4), jcfg)
    if setting == "drops":
        jp["router"] = jp["router"].at[:, 0].add(2.0)
    tp = convert.params_from_numpy(np_tree(jp)).tree()
    x = np.random.RandomState(4).randn(2, 24, 64).astype(np.float32)
    qcfg = QMODES[mode]
    jsc, tsc = _site_scales() if mode == "pt_static" else (None, None)
    jy, jlb = jax.jit(lambda p, x: JM.apply_moe(p, x, jcfg, qcfg, jsc,
                                                None))(jp, jnp.asarray(x))
    ty, tlb = TM.apply_moe(tp, torch.from_numpy(x), tcfg, qcfg, tsc, None)
    _check_rows(ty.numpy(), np.asarray(jy), mode)
    np.testing.assert_allclose(float(tlb), float(jlb), rtol=0, atol=1e-6)
    assert (_dropped(kept) > 0) == (setting == "drops"), kept


@pytest.mark.parametrize("mode", ["none", "pt_dynamic", "pt_static"])
def test_arctic_residual_branch_matches_jax(mode):
    """arctic's dense residual MLP beside the experts: under pt_static it
    is ``apply_mlp`` on the int path with fp weights (the weight quantized
    per call), sharing the experts' site scales; the experts stay fake
    quant."""
    jcfg, tcfg = configs("arctic-480b")
    assert jcfg.moe.dense_residual_ff and tcfg.moe.dense_residual_ff
    jp = JM.moe_init(jax.random.PRNGKey(5), jcfg)
    tp = convert.params_from_numpy(np_tree(jp)).tree()
    assert set(tp["residual"]) == {"w_up", "w_gate", "w_down"}
    x = np.random.RandomState(5).randn(2, 12, 64).astype(np.float32)
    qcfg = QMODES[mode]
    jsc, tsc = _site_scales() if mode == "pt_static" else (None, None)
    jy, jlb = jax.jit(lambda p, x: JM.apply_moe(p, x, jcfg, qcfg, jsc,
                                                None))(jp, jnp.asarray(x))
    ty, tlb = TM.apply_moe(tp, torch.from_numpy(x), tcfg, qcfg, tsc, None)
    _check_rows(ty.numpy(), np.asarray(jy), mode)
    np.testing.assert_allclose(float(tlb), float(jlb), rtol=0, atol=1e-6)
    # the branch is there: without it y changes
    bare = {k: v for k, v in tp.items() if k != "residual"}
    y0, _ = TM.apply_moe(bare, torch.from_numpy(x), tcfg, qcfg, tsc, None)
    assert float((y0 - ty).abs().max()) > 1e-2


def test_groups_keep_per_candidate_ranges_at_the_expert_sites():
    """``groups`` stacked forwards along B: each keeps its own pt_dynamic
    ranges and L_q at mlp_in and down (the reference vmaps them): the
    stacked call equals the rows run one at a time."""
    _, tcfg = configs(cf=1.25)
    jp = JM.moe_init(jax.random.PRNGKey(6), configs(cf=1.25)[0])
    tp = convert.params_from_numpy(np_tree(jp)).tree()
    xs = [torch.from_numpy(np.random.RandomState(i).randn(1, 10, 64)
                           .astype(np.float32) * (1 + 3 * i))
          for i in range(3)]
    taps = {}
    y, _ = TM.apply_moe(tp, torch.cat(xs), tcfg, QD, None, taps, groups=3)
    for i, x in enumerate(xs):
        t1 = {}
        y1, _ = TM.apply_moe(tp, x, tcfg, QD, None, t1)
        np.testing.assert_allclose(y[i:i + 1].numpy(), y1.numpy(),
                                   rtol=0, atol=1e-6)
        for site in ("mlp_in", "down"):
            np.testing.assert_allclose(float(taps[site]["qerr"][i]),
                                       float(t1[site]["qerr"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# forward, loss, prefill / decode
# ---------------------------------------------------------------------------

def _pick(s, mode):
    qcfg = QMODES[mode]
    static = qcfg.mode == "pt_static"
    return (qcfg, s["jscales"] if static else None,
            s["scales"] if static else None)


@pytest.mark.parametrize("mode", list(QMODES))
def test_forward_logits_and_taps_match_jax(olmoe, mode, kept):
    s = olmoe
    qcfg, js, ts = _pick(s, mode)
    jl, jt = jax.jit(lambda p, t: s["japi"].forward(
        p, {"tokens": t}, qcfg, scales=js, cushion=s["jcushion"],
        collect=True, remat=False))(s["jparams"], jnp.asarray(s["tokens"]))
    tl, tt = s["api"].forward(s["params"],
                              {"tokens": torch.from_numpy(s["tokens"])},
                              qcfg, scales=ts, cushion=s["cushion"],
                              collect=True)
    err = np.abs(tl.numpy() - np.asarray(jl)).max(-1)
    print(f"[{mode}] logits max |port - JAX| {err.max():.2e}")
    if mode != "none":
        assert (err > 1e-4).sum() <= 1 and err.max() <= PTOKEN_TIE, err
    else:
        assert err.max() <= 1e-4, err.max()
    q_tol = 1e-4 if mode == "none" else 2e-3
    for site in TM.SITES:
        for key in ("qerr", "amin", "amax", "absmax_ch"):
            np.testing.assert_allclose(
                tt["layers"][site][key].numpy(),
                np.asarray(jt["layers"][site][key]),
                rtol=q_tol if key == "qerr" else 0,
                atol=0 if key == "qerr" else 1e-5, err_msg=f"{site}.{key}")
    np.testing.assert_allclose(tt["head"]["qerr"].numpy(),
                               np.asarray(jt["head"]["qerr"]), rtol=q_tol)
    np.testing.assert_allclose(float(tt["lb_loss"]), float(jt["lb_loss"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(TM.total_qerr(tt)),
                               float(JM.T.total_qerr(jt)), rtol=q_tol)
    assert (_dropped(kept) > 0) == (s["tcfg"].moe.capacity_factor < 2)


def test_loss_fn_matches_jax(drops):
    """CE + load_balance_coef * lb, and + λ·L_q with lam > 0."""
    s = drops
    toks = np.random.RandomState(8).randint(0, s["vocab"], (2, 17)) \
        .astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for lam in (0.0, 0.5):
        jl, jaux = jax.jit(lambda p, b: s["japi"].loss_fn(
            p, b, QD, cushion=s["jcushion"], collect=True, remat=False,
            lam=lam))(s["jparams"], jax.tree.map(jnp.asarray, batch))
        tl, taux = s["api"].loss_fn(s["params"], to_torch(batch), QD,
                                    cushion=s["cushion"], collect=True,
                                    lam=lam)
        np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(taux["lb"]), float(jaux["lb"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(taux["qerr"]), float(jaux["qerr"]),
                                   rtol=2e-3)
        np.testing.assert_allclose(float(tl), float(jl), rtol=2e-3)
        want = taux["ce"] + s["tcfg"].moe.load_balance_coef * taux["lb"] \
            + lam * taux["qerr"]
        np.testing.assert_allclose(float(tl), float(want), rtol=1e-6)
    # the range penalty reads the sites only; lb_loss carries no L_q
    assert set(taux["taps"]) >= {"layers", "head", "lb_loss"}
    np.testing.assert_allclose(
        float(TOUT.activation_range_penalty(taux["taps"])),
        float(JOUT.activation_range_penalty(jaux["taps"])), rtol=1e-5)


@pytest.mark.parametrize("setting", SETTINGS)
def test_prefill_decode_matches_forward(setting):
    """Prefill half the batch, decode the rest: the teacher-forced forward
    logits, with a cushion (``tests/test_models.py``'s check, at its
    bar)."""
    dropless = setting == "dropless"
    _, tcfg = configs(cf=None if setting == "dropless" else 1.25)
    api = build(tcfg, "cpu")
    params = api.init_params(torch.Generator().manual_seed(0))
    batch = api.make_batch(torch.Generator().manual_seed(1), 2, 16)
    cushion = {"kv": {k: v + 0.03 for k, v in
                      api.cushion_zeros(4)["kv"].items()}}
    full, _ = api.forward(params, batch, QN, cushion=cushion)
    split = 8
    cache = api.init_cache(2, 64)
    lg, cache, pos = api.prefill(params, {"tokens":
                                          batch["tokens"][:, :split]},
                                 cache, QN, cushion=cushion)
    # a prefill of 8 tokens has its own capacity: compare where nothing
    # drops (the dropless setting), else only that the path runs
    if dropless:
        np.testing.assert_allclose(lg[:, 0].numpy(),
                                   full[:, split - 1].numpy(),
                                   rtol=5e-3, atol=5e-3)
    for i in range(split, 12):
        lg, cache = api.decode_step(params, batch["tokens"][:, i], pos,
                                    cache, QN)
        pos = pos + 1
        assert lg.shape == (2, tcfg.vocab_size)
        if dropless:
            np.testing.assert_allclose(lg.numpy(), full[:, i].numpy(),
                                       rtol=5e-3, atol=5e-3)
        assert bool(torch.isfinite(lg).all())


def _cmp_caches(jc, tc, int8: bool):
    jc = np_tree(jc)
    if not int8:
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].numpy(), jc[k], atol=1e-5)
        return
    for k in ("kc", "vc"):
        np.testing.assert_array_equal(tc[k].numpy(), jc[k])
    for k in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tc[k].numpy(), jc[k], rtol=1e-6)
    for k in ("k", "v"):
        d = np.abs(tc[k].numpy().astype(np.int32) - jc[k].astype(np.int32))
        assert d.max() <= 1, k
        assert (d > 0).mean() < 1e-3, (k, (d > 0).mean())


@pytest.mark.parametrize("mode,kv", [(m, kv) for m in ("none", "w8a8",
                                                       "prequant")
                                     for kv in ("fp", "int8")])
def test_prefill_decode_match_jax(drops, mode, kv):
    """With the cushion, where entries drop: the prefill's logits and
    cache, then three decode steps, against JAX; the weights fp (none),
    fp under true int8 (w8a8) or int8-resident (prequant)."""
    s = drops
    qcfg = QN if mode == "none" else QW8
    jp = s["jpre"] if mode == "prequant" else s["jparams"]
    tp = s["pre"] if mode == "prequant" else s["params"]
    js = None if mode == "none" else s["jscales"]
    ts = None if mode == "none" else s["scales"]
    kv_dtype = None if kv == "fp" else "int8"
    B, S = s["tokens"].shape
    japi, api = s["japi"], s["api"]
    jcache = japi.init_cache(B, 32, kv_dtype=kv_dtype, prefix_len=4)
    tcache = api.init_cache(B, 32, kv_dtype=kv_dtype, prefix_len=4)
    jl, jcache, jpos = jax.jit(lambda p, t, c: japi.prefill(
        p, {"tokens": t}, c, qcfg, cushion=s["jcushion"], scales=js))(
            jp, jnp.asarray(s["tokens"]), jcache)
    tl, tcache, tpos = api.prefill(
        tp, {"tokens": torch.from_numpy(s["tokens"])}, tcache, qcfg,
        cushion=s["cushion"], scales=ts)
    assert int(tpos) == int(jpos) == 4 + S
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    _cmp_caches(jcache, tcache, kv_dtype is not None)
    jdec = jax.jit(lambda p, t, pos, c: japi.decode_step(p, t, pos, c, qcfg,
                                                         scales=js))
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for step in range(3):
        jl, jcache = jdec(jp, jnp.asarray(tok), jpos + step, jcache)
        tl, tcache = api.decode_step(tp, torch.from_numpy(tok), tpos + step,
                                     tcache, qcfg, scales=ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    _cmp_caches(jcache, tcache, kv_dtype is not None)


def test_decode_per_row_pos_matches_single_slot(drops):
    """Two slots prefilled to different depths decode as one batch with a
    (B,) pos: each row equals its slot decoded alone
    (``tests/test_serving.py``'s check)."""
    s = drops
    api, params = s["api"], s["params"]
    rows, poss, toks, ref = [], [], [], []
    for i, L in enumerate((20, 26)):
        t = torch.from_numpy(np.random.RandomState(10 + i).randint(
            0, s["vocab"], (1, L)).astype(np.int32))
        c = api.init_cache(1, 64)
        lg, c, p = api.prefill(params, {"tokens": t}, c, QN)
        tok = lg[:, -1].argmax(-1).to(torch.int32)
        c1 = {k: v.clone() for k, v in c.items()}
        lr, _ = api.decode_step(params, tok, p, c1, QN)
        rows.append(c)
        poss.append(p)
        toks.append(tok[0])
        ref.append(lr[0])
    pool = {k: torch.cat([r[k] for r in rows], dim=ax)
            for k, ax in api.cache_batch_axes.items()}
    lg2, _ = api.decode_step(params, torch.stack(toks),
                             torch.stack(poss).to(torch.int32), pool, QN)
    for i in range(2):
        np.testing.assert_allclose(lg2[i].numpy(), ref[i].numpy(),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _requests(tokens, budgets):
    j = [JRequest(uid=i, batch={"tokens": jnp.asarray(t)}, max_new_tokens=n)
         for i, (t, n) in enumerate(zip(tokens, budgets))]
    p = [Request(uid=i, batch={"tokens": torch.from_numpy(t)},
                 max_new_tokens=n)
         for i, (t, n) in enumerate(zip(tokens, budgets))]
    return j, p


def _same_outputs(a_outs, b_outs):
    assert [o.uid for o in b_outs] == [o.uid for o in a_outs]
    for a, b in zip(a_outs, b_outs):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.slot == a.slot


@pytest.mark.parametrize("pool", ["contiguous", "paged"])
def test_continuous_matches_engine_and_jax(drops, pool):
    """Five requests of ragged prompts and budgets through 2 slots (so
    slots recycle), where prefill entries drop: the tokens of the port's
    static B=1 Engine per request and of JAX's ContinuousEngine, with its
    slots and ServeStats."""
    s = drops
    rs = np.random.RandomState(100)
    tokens = [rs.randint(0, s["vocab"], (1, [20, 26][i % 2]))
              .astype(np.int32) for i in range(5)]
    jreqs, treqs = _requests(tokens, [5, 3, 6, 4, 5])
    kw = dict(n_slots=2, max_seq=128)
    if pool == "paged":
        kw.update(paged=True, page_size=32)
    ce = ContinuousEngine(s["api"], s["params"], QN, cushion=s["cushion"],
                          **kw)
    jce = JContinuous(s["japi"], s["jparams"], QN, cushion=s["jcushion"],
                      **kw)
    outs = ce.run(treqs)
    _same_outputs(jce.run(jreqs), outs)
    assert ce.stats.as_dict() == jce.stats.as_dict()
    assert ce.stats.recycles >= 1
    eng = Engine(s["api"], s["params"], QN, cushion=s["cushion"],
                 max_seq=128)
    for r, o in zip(treqs, outs):
        np.testing.assert_array_equal(
            eng.generate(r.batch, r.max_new_tokens).tokens[0], o.tokens)


def test_int8_pool_w8a8_matches_jax(drops):
    """A contiguous int8 pool with prequantized W8A8 attention and head
    (the experts fp), per-slot KV scales: JAX's tokens, slots and
    stats."""
    s = drops
    rs = np.random.RandomState(101)
    tokens = [rs.randint(0, s["vocab"], (1, [20, 26][i % 2]))
              .astype(np.int32) for i in range(4)]
    jreqs, treqs = _requests(tokens, [4, 3, 5, 4])
    kw = dict(n_slots=2, max_seq=128, kv_dtype="int8", prequant=True)
    ce = ContinuousEngine(s["api"], s["params"], QW8, cushion=s["cushion"],
                          scales=s["scales"], **kw)
    jce = JContinuous(s["japi"], s["jparams"], QW8, cushion=s["jcushion"],
                      scales=s["jscales"], **kw)
    _same_outputs(jce.run(jreqs), ce.run(treqs))
    assert ce.stats.as_dict() == jce.stats.as_dict()


@pytest.mark.parametrize("pool", ["contiguous", "paged"])
def test_chunked_admission_matches_jax_chunked(drops, pool, kept):
    """40-token prompts stream in 16-token chunks at capacity factor 1.25:
    each chunk sizes its experts' capacity from its own length, as the
    reference does (``SUPPORTS_CHUNKED_PREFILL`` is the dense family's), so
    where entries drop the chunked admission is not the blocking one. The
    port follows JAX's chunked engine: tokens, slots and stats."""
    s = drops
    rs = np.random.RandomState(102)
    tokens = [rs.randint(0, s["vocab"], (1, [40, 12][i % 2]))
              .astype(np.int32) for i in range(5)]
    jreqs, treqs = _requests(tokens, [5, 3, 6, 4, 5])
    kw = dict(n_slots=2, max_seq=128, chunk_tokens=16)
    if pool == "paged":
        kw.update(paged=True, page_size=32)
    ce = ContinuousEngine(s["api"], s["params"], QN, cushion=s["cushion"],
                          **kw)
    jce = JContinuous(s["japi"], s["jparams"], QN, cushion=s["jcushion"],
                      **kw)
    _same_outputs(jce.run(jreqs), ce.run(treqs))
    assert ce.stats.prefill_chunks == jce.stats.prefill_chunks == 9
    assert ce.stats.as_dict() == jce.stats.as_dict()
    assert _dropped(kept) > 0


def test_prequant_parity_and_fp_experts():
    """``prequantize_tree`` makes the attention and the head int8-resident
    and leaves every ``moe`` leaf fp (the experts and arctic's residual
    branch); W8A8 serving with int8-resident weights generates what fp
    weights under true int8 generate, and the resident fp bytes shrink
    (``tests/test_w8a8.py``'s checks)."""
    for arch in ("olmoe-1b-7b", "arctic-480b"):
        jcfg, tcfg = configs(arch)
        japi, api = j_build(jcfg), build(tcfg, "cpu")
        jp = japi.init_params(jax.random.PRNGKey(0))
        tp = convert.params_from_numpy(np_tree(jp))
        pq = TQ.prequantize_tree(tp.tree(), QW8)
        jpq = JQ.prequantize_tree(jp, QW8)
        lay = pq["layers"]
        assert lay["attn"]["wqkv"]["w_int"].dtype == torch.int8
        assert lay["attn"]["wo"]["w_int"].shape == (4, 64, 64)
        assert "w_int" in pq["head"]["w"]
        for k in ("router", "w_up", "w_gate", "w_down"):
            assert isinstance(lay["moe"][k], torch.Tensor), k
            assert lay["moe"][k].dtype == torch.float32
        if arch == "arctic-480b":
            for k in ("w_up", "w_gate", "w_down"):
                assert isinstance(lay["moe"]["residual"][k], torch.Tensor)
        assert not isinstance(pq["embed"]["w"], dict)
        fp, i8, i4 = resident_weight_bytes(pq)
        fp0, i80, _ = resident_weight_bytes(tp)
        assert (fp, i8, i4) == JMON.resident_weight_bytes(jpq)
        assert i80 == 0 and i8 > 0 and fp < fp0
        experts = sum(lay["moe"][k].numel() * 4 for k in ("w_up", "w_gate",
                                                          "w_down"))
        assert fp > experts                       # counted as fp bytes
        # generation: int8-resident = fp weights under true int8
        rs = np.random.RandomState(3)
        calib = [{"tokens": torch.from_numpy(
            rs.randint(0, 256, (2, 24)).astype(np.int32))}]
        batch = {"tokens": torch.from_numpy(
            rs.randint(0, 256, (2, 12)).astype(np.int32))}
        e_fp = Engine(api, tp, QW8, max_seq=64, calib_batches=calib)
        e_pq = Engine(api, tp, QW8, max_seq=64, calib_batches=calib,
                      prequant=True)
        np.testing.assert_array_equal(e_pq.generate(batch, 6).tokens,
                                      e_fp.generate(batch, 6).tokens)
        assert e_pq.weight_bytes_fp < e_fp.weight_bytes_fp


def test_calibration_scales_match_jax(olmoe):
    """MoE scales take the dense layout (qkv, o, mlp_in, down stacked over
    L, and the head), calibrated under the cushion."""
    s = olmoe
    batches = [{"tokens": s["calib"]}]
    tsc, tstats = TCal.calibrate(s["api"], s["params"], to_torch(batches),
                                 QW8, cushion=s["cushion"])
    assert set(tsc) == set(TM.SITES) | {"head"}
    jsc = s["jscales"]
    for site in tsc:
        np.testing.assert_allclose(tsc[site].scale.numpy(),
                                   np.asarray(jsc[site].scale), rtol=1e-5)
        np.testing.assert_allclose(tsc[site].zero.numpy(),
                                   np.asarray(jsc[site].zero), rtol=0,
                                   atol=0)
        if site != "head":
            assert tsc[site].scale.shape == (s["tcfg"].n_layers,)
    assert tstats["layers"]["down"]["absmax_ch"].shape == \
        (s["tcfg"].n_layers, s["tcfg"].d_ff)


# ---------------------------------------------------------------------------
# the method: scores, search, tuning
# ---------------------------------------------------------------------------

SCORE_MODES = {"none": (QN, 1e-4), "pt_dynamic": (QD, 2e-3),
               "ptoken_dynamic": (QPT, 2e-3)}


def _sample(japi, i, n=24):
    return japi.make_batch(jax.random.PRNGKey(1000 + i), 1, n)


@pytest.mark.parametrize("mode", list(SCORE_MODES))
def test_score_candidates_match_jax(drops, mode):
    """prefix_qerr and score_candidates (the KV-reuse scorer, candidates
    stacked along B with groups=N) against JAX's vmapped scorer."""
    s = drops
    qcfg, rtol = SCORE_MODES[mode]
    japi, api = s["japi"], s["api"]
    batch = _sample(japi, 0)
    padded = [1, 4, 0]
    cands = np.asarray([2, 30, 99, 7, 1, 200], np.int32)

    @jax.jit
    def jscore(p, pad, c, b):
        kv = japi.prefix_kv(p, pad, qcfg)
        return (japi.score_candidates(p, kv, jnp.int32(2), c, b, qcfg),
                japi.prefix_qerr(p, kv, jnp.int32(2), b, qcfg))

    jfast, jbase = jscore(s["jparams"], jnp.asarray(padded, jnp.int32),
                          jnp.asarray(cands), batch)
    with torch.no_grad():
        pkv = api.prefix_kv(s["params"], torch.tensor(padded), qcfg)
        tfast = api.score_candidates(s["params"], pkv, 2,
                                     torch.from_numpy(cands),
                                     to_torch(batch), qcfg).numpy()
        tbase = float(api.prefix_qerr(s["params"], pkv, 2, to_torch(batch),
                                      qcfg))
    jfast = np.asarray(jfast)
    print(f"[{mode}] scores: max relative |port - JAX| "
          f"{np.abs(tfast / jfast - 1).max():.2e}")
    np.testing.assert_allclose(tfast, jfast, rtol=rtol)
    np.testing.assert_allclose(tbase, float(jbase), rtol=rtol)
    assert int(np.argmin(tfast)) == int(np.argmin(jfast))


def test_score_candidates_moe_contract(drops):
    """In the KV-reuse scorer prefix tokens never re-enter the experts, so
    under a position-local mode (ptoken_dynamic) the full-forward scorer's
    L_q exceeds it by an offset that does not depend on the candidate, and
    the argmin agrees
    (``tests/test_search.py``'s contract, held on the port's own two
    scorers)."""
    _, tcfg = configs()                   # dropless: the offset is exact
    api = build(tcfg, "cpu")
    params = api.init_params(torch.Generator().manual_seed(0)).tree()
    batch = api.make_batch(torch.Generator().manual_seed(6), 1, 24)
    prefix, cands = [1, 4], np.asarray([2, 30, 99, 7], np.int32)
    with torch.no_grad():
        pkv = api.prefix_kv(params, torch.tensor(prefix + [0]), QPT)
        fast = api.score_candidates(params, pkv, 2, torch.from_numpy(cands),
                                    batch, QPT).numpy()
        ref = TCC.make_batched_qerr_fn(api, QPT)(
            params, torch.tensor([prefix + [int(c)] for c in cands]),
            batch).numpy()
    diff = ref - fast
    assert np.all(diff > -1e-4)
    assert np.std(diff) < 1e-3 * max(np.mean(diff), 1e-9) + 1e-4
    assert int(np.argmin(fast)) == int(np.argmin(ref))


def _jax_pools(vocab, ccfg, seed, n_iter):
    """JAX's candidate pools, iteration by iteration (its rng schedule)."""
    rng = jax.random.PRNGKey(seed)
    pools = []
    for _ in range(n_iter):
        rng, k1, _ = jax.random.split(rng, 3)
        pools.append(JCC.candidate_pool(k1, vocab, ccfg.n_candidates,
                                        ccfg.seed_tokens))
    return pools


@pytest.mark.parametrize("search", ["greedy_search", "greedy_search_ref"])
def test_greedy_search_matches_jax_tokens(drops, search, monkeypatch):
    """With JAX's candidate pools injected, both searches find JAX's prefix
    tokens and per-iteration best token on the MoE model."""
    s = drops
    ccfg = CushionConfig(max_prefix_len=3, tau=1.5, n_candidates=16,
                         seed_tokens=(1,))
    jsample = {i: _sample(s["japi"], i) for i in range(3)}
    jres = getattr(JCC, search)(s["japi"], s["jparams"],
                                lambda i: jsample[i], QD, ccfg,
                                jax.random.PRNGKey(0), chunk=8,
                                verbose=False)
    it = iter(_jax_pools(s["vocab"], ccfg, 0, 3))
    monkeypatch.setattr(TCC, "candidate_pool", lambda *a, **k: next(it))
    res = getattr(TCC, search)(s["api"], s["params"],
                               lambda i: to_torch(jsample[i]), QD, ccfg,
                               torch.Generator(), chunk=8, verbose=False)
    np.testing.assert_array_equal(res.prefix_ids, jres.prefix_ids)
    assert [h["best_tok"] for h in res.history] == \
        [h["best_tok"] for h in jres.history]
    for h, jh in zip(res.history, jres.history):
        np.testing.assert_allclose([h["base_err"], h["best_err"]],
                                   [jh["base_err"], jh["best_err"]],
                                   rtol=2e-3)


def test_prefix_tune_on_moe_matches_jax_first_losses(drops):
    """prefix_tune on MoE (``tests/test_cushion_tune.py``'s check: finite
    losses, the cushion KV moves), and its first steps' logs under
    ``none`` against JAX's within the method's f32 bar."""
    s = drops
    batches = [s["japi"].make_batch(jax.random.PRNGKey(3000 + i), 2, 16)
               for i in range(3)]
    ccfg = CushionConfig(tune_steps=3, tune_lr=1e-3, lam=0.05, log_every=2)
    cush0 = s["api"].extract_cushion(s["params"], torch.tensor([1, 2]),
                                     None, QN)
    tr = TCC.prefix_tune(s["api"], s["params"], cush0,
                         (to_torch(b) for b in batches), QD, ccfg,
                         verbose=False)
    assert [r["step"] for r in tr.log] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in tr.log)
    assert not torch.equal(tr.cushion["kv"]["k"], cush0["kv"]["k"])
    # under none, against JAX from JAX's cushion
    jtr = JCC.prefix_tune(s["japi"], s["jparams"], s["jcushion"],
                          iter(batches), QN, ccfg, verbose=False)
    ttr = TCC.prefix_tune(s["api"], s["params"], s["cushion"],
                          (to_torch(b) for b in batches), QN, ccfg,
                          verbose=False)
    err = max(abs(t[k] / j[k] - 1) for t, j in zip(ttr.log, jtr.log)
              for k in ("loss", "ce", "range", "qerr", "gnorm"))
    print(f"tuning logs, none: max relative |port - JAX| {err:.2e}")
    assert err <= 1e-5, err


# ---------------------------------------------------------------------------
# registry, conversion, launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(T_ARCHS))
def test_build_every_arch_matches_jax_family_api(arch):
    """Every arch of the port's config table builds (no weights made), and
    its family module, sites, cache slot layout, scoring path and paged
    leaves are the reference's."""
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    japi, api = j_build(jcfg), build(tcfg, "cpu")
    assert api.mod.__name__.rsplit(".", 1)[1] == \
        japi.mod.__name__.rsplit(".", 1)[1]
    assert tuple(api.sites) == tuple(japi.sites)
    assert api.cache_batch_axes == japi.cache_batch_axes
    assert api.supports_kv_scoring == japi.supports_kv_scoring
    assert api.supports_chunked_prefill == japi.supports_chunked_prefill
    assert api.paged_kv_leaves == japi.paged_kv_leaves


@pytest.mark.parametrize("arch", ["internvl2-26b", "jamba-v0.1-52b"])
def test_build_vlm_and_hybrid_full_config_api(arch):
    """The full internvl2-26b and jamba-v0.1-52b configs build (no weights
    made): their sites, cache layout and scoring path."""
    from repro_torch.models import hybrid as TH
    from repro_torch.models import vlm as TV
    api = build(t_get_config(arch), "cpu")
    assert not api.supports_chunked_prefill
    assert api.paged_kv_leaves == ("k", "v")
    if arch == "internvl2-26b":
        assert api.mod is TV
        assert api.sites == ("qkv", "o", "mlp_in", "down")
        assert api.supports_kv_scoring
        assert api.cache_batch_axes == {"k": 1, "v": 1}
        assert api.text_len(1536) == 512
    else:
        assert api.mod is TH
        assert api.sites == ("qkv", "o", "mamba_in", "mamba_out",
                             "mlp_in", "down")
        assert not api.supports_kv_scoring
        assert api.cache_batch_axes == {"k": 1, "v": 1, "h": 2, "conv": 2}
        assert TH.layout(api.cfg)[0] == 4
        assert TH.n_mamba_per_period(api.cfg) == 7
        assert TM.capacity(512, api.cfg) == 80


def test_build_olmoe_full_config_api():
    """The full olmoe config builds (no weights made): its sites, cache
    layout and scoring path are the dense family's."""
    api = build(t_get_config("olmoe-1b-7b"), "cpu")
    assert api.mod is TM
    assert api.sites == ("qkv", "o", "mlp_in", "down")
    assert api.supports_kv_scoring and api.supports_chunked_prefill
    assert api.paged_kv_leaves == ("k", "v")
    assert api.cache_batch_axes == {"k": 1, "v": 1}
    assert TM.capacity(1, api.cfg) == 4
    assert TM.capacity(512, api.cfg) == 80


def test_convert_keeps_the_router_f32_in_a_bf16_model():
    jcfg = reduced(get_config("arctic-480b"), dtype="bfloat16")
    jp = j_build(jcfg).init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(np_tree(jp)).tree()
    moe = tp["layers"]["moe"]
    L, E, D, Fd = 4, 8, 64, 128
    assert moe["router"].dtype == torch.float32
    assert moe["router"].shape == (L, D, E)
    assert moe["w_up"].shape == moe["w_gate"].shape == (L, E, D, Fd)
    assert moe["w_down"].shape == (L, E, Fd, D)
    for k in ("w_up", "w_gate", "w_down"):
        assert moe[k].dtype == moe["residual"][k].dtype == torch.bfloat16
    np.testing.assert_array_equal(moe["router"].numpy(),
                                  np.asarray(jp["layers"]["moe"]["router"]))
    # the port's own init agrees on shapes and dtypes
    _, tcfg = configs("arctic-480b")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    own = build(tcfg, "cpu").init_params(torch.Generator().manual_seed(0))
    for k, v in own.tree()["layers"]["moe"].items():
        if isinstance(v, torch.Tensor):
            assert v.shape == moe[k].shape and v.dtype == moe[k].dtype, k


def test_launchers_serve_and_tune_olmoe_on_cpu(tmp_path, monkeypatch):
    """``--arch olmoe-1b-7b`` through the registry, at the reduced size on
    the CPU (the config lookup returns ``reduced``): tune writes an
    artifact, serve serves it static and continuous."""
    red = t_reduced(t_get_config("olmoe-1b-7b"), dtype="float32")
    for mod in (serve, tune):
        monkeypatch.setattr(mod, "get_config",
                            lambda a: red if a == "olmoe-1b-7b" else None)
    out = tmp_path / "art"
    tune.main(["--device", "cpu", "--arch", "olmoe-1b-7b", "--out-dir",
               str(out), "--max-prefix-len", "2", "--candidates", "8",
               "--sample-len", "12", "--steps", "2", "--log-every", "2",
               "--seq-len", "12", "--eval-batches", "1", "--with-scales"])
    res = serve.main(["--device", "cpu", "--arch", "olmoe-1b-7b", "--quant",
                      "pt_static", "--prequant", "--kv-dtype", "int8",
                      "--cushion", str(out), "--batch", "2",
                      "--prompt-len", "12", "--tokens", "3"])
    assert res.tokens.shape == (2, 3)
    serve.main(["--device", "cpu", "--arch", "olmoe-1b-7b", "--mode",
                "continuous", "--paged", "--page-size", "32", "--rate", "0",
                "--n-requests", "3", "--prompt-len", "12", "--tokens", "3",
                "--cushion-len", "2"])
