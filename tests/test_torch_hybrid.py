"""Port parity, the Jamba hybrid (``repro_torch.models.hybrid``) against the
JAX package on the same weights (JAX's, carried across through
``models/convert.py``, sublayers as a list), cushion, scales and numpy
inputs, in f32, on ``reduced(jamba-v0.1-52b)``: one period of 8 layers
(attention at 3, Mamba at the other seven, MoE on the odd layers, 8
experts top-2, dropless), d_model 64.

Tolerances, measured on the CPU with JAX's functions jitted (the tests
print what they measure: ``pytest -s``):

* ``forward``: logits within 1e-4 under ``none``. Under a quantized mode
  the MoE family's bar (ROADMAP queue 3: one position up to 0.1 off, a
  code flipped upstream) becomes, for a recurrence: the positions off by
  more than 1e-4 lie in one row, at or after its first such position, all
  within 0.1, since a code flipped at one position reaches the positions
  after it through the Mamba state (measured under ptoken_dynamic: the
  last 5 of 16 positions of one row, up to 5.5e-2). A site's L_q within
  1e-4 relative under
  ``none`` and 2e-3 under the quantized modes; amin / amax / absmax_ch
  within 1e-5 absolute and relative (the Mamba sites' ranges, ~14, carry
  the scan's rounding: measured 1.2e-6 relative); lb within 1e-6 under
  ``none`` and 1e-3 relative under a quantized mode (measured 1.2e-4,
  the loss under pt_dynamic). Under ptoken_dynamic, where the measured
  flip spreads, L_q and the channel maxima within 5e-2 relative
  (measured 1.8e-2 at the head, 2.4e-2 at mamba_out's absmax_ch); pt_dynamic
  and pt_static keep the tight bars (measured 2.6e-6 and 8.3e-7). The Mamba scan agrees with the reference's
  associative scan to f32 rounding (``tests/test_torch_ssm.py``).
* Caches: fp KV and the Mamba state within 1e-5; int8 codes off by at
  most one at under 0.1% of entries, the cushion block bit-exact
  (``test_torch_model.py``). Prefill and decode under ptoken_dynamic: the
  row whose prompt flipped a code within 0.1 (one row, 4.6e-2 measured),
  its cache rows then apart; the other rows at these bars.
* The loss under pt_dynamic, and the search's errors: the method's
  pt_dynamic bars (ROADMAP queue 3; the reference disagrees with itself
  there), CE 1e-3 (measured 3.4e-4) and L_q 1e-2 (measured 4.8e-3).
* Greedy tokens of every engine and of the search: identical.
* Calibration scales within 1e-5 relative; the first tuning losses within
  the method's f32 ``none`` bar, 1e-5 relative; the cushion's ``state``
  leaves bit-identical after tuning (only ``kv`` trains).
* ``resident_weight_bytes`` of a prequantized tree: JAX's three counts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import (CushionConfig, QuantConfig, get_config,  # noqa: E402
                           reduced)
from repro.core import calibration as JCal  # noqa: E402
from repro.core import cushioncache as JCC  # noqa: E402
from repro.core import quantization as JQ  # noqa: E402
from repro import monitoring as JMON  # noqa: E402
from repro.models import hybrid as JH  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro.serving import ContinuousEngine as JContinuous  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import monitoring as TMON  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import calibration as TCal  # noqa: E402
from repro_torch.core import cushioncache as TCC  # noqa: E402
from repro_torch.core import quantization as TQ  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import hybrid as TH  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.scheduler import ContinuousEngine, Request  # noqa: E402

QN = QuantConfig()
QD = QuantConfig(mode="pt_dynamic")
QW8 = QuantConfig(mode="pt_static", true_int8=True)
QPT = QuantConfig(mode="ptoken_dynamic")
QMODES = {"none": QN, "pt_dynamic": QD, "pt_static": QW8,
          "ptoken_dynamic": QPT}
TIE = 0.1
ARCH = "jamba-v0.1-52b"


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def configs():
    return (reduced(get_config(ARCH), dtype="float32"),
            t_reduced(t_get_config(ARCH), dtype="float32"))


@pytest.fixture(scope="module")
def jamba():
    jcfg, tcfg = configs()
    japi = j_build(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(1))
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
        jcushion=jcushion,
        cushion=convert.cushion_from_numpy(np_tree(jcushion)),
        jscales=jscales, scales=convert.scales_from_numpy(
            np_tree(JCal.scales_to_plain(jscales))),
        calib=calib, tokens=rs.randint(0, jcfg.vocab_size, (2, 16))
        .astype(np.int32), vocab=jcfg.vocab_size)


# ---------------------------------------------------------------------------
# layout, list trees, prequantization, resident bytes
# ---------------------------------------------------------------------------

def test_layout_matches_jax(jamba):
    assert TH.layout(jamba["tcfg"]) == JH.layout(jamba["jcfg"])
    assert TH.layout(jamba["tcfg"]) == (1, [
        ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
        ("attn", "moe"), ("mamba", "dense"), ("mamba", "moe"),
        ("mamba", "dense"), ("mamba", "moe")])
    assert TH.n_mamba_per_period(jamba["tcfg"]) == 7
    full = t_get_config(ARCH)
    assert TH.layout(full)[0] == 4 and TH.SITES == JH.SITES


def test_list_sub_through_convert_and_param_tree(jamba):
    """``sub`` crosses as a list of dicts; ParamTree keeps it a list (the
    index a path component); the port's own init has JAX's shapes and
    dtypes; unstack / stack_trees walk lists."""
    jp, tp = jamba["jparams"], jamba["params"]
    sub = tp["layers"]["sub"]
    assert isinstance(sub, list) and len(sub) == 8
    assert set(sub[3]) == {"ln1", "ln2", "attn", "moe"}
    assert set(sub[0]) == {"ln1", "ln2", "mamba", "mlp"}
    np.testing.assert_array_equal(
        sub[5]["mamba"]["w_in"].numpy(),
        np.asarray(jp["layers"]["sub"][5]["mamba"]["w_in"]))
    tree = C.ParamTree(tp)
    assert "layers__sub__5__mamba__w_in" in dict(tree.named_buffers())
    again = tree.tree()
    assert isinstance(again["layers"]["sub"], list)
    assert jax.tree.structure(np_tree(again)) == \
        jax.tree.structure(np_tree(tp))
    own = jamba["api"].init_params(torch.Generator().manual_seed(0)).tree()
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(np_tree(own))[0],
            jax.tree_util.tree_flatten_with_path(np_tree(jp))[0]):
        assert pa == pb and a.shape == b.shape and a.dtype == b.dtype, pa
    per = C.unstack(tp["layers"], 1)
    assert isinstance(per[0]["sub"], list)
    back = C.stack_trees(per)
    assert torch.equal(back["sub"][7]["moe"]["w_up"],
                       tp["layers"]["sub"][7]["moe"]["w_up"])


def test_prequantize_and_resident_bytes_match_jax(jamba):
    """The Mamba and dense linears and the attention become int8-resident,
    the experts, the router, ``w_x`` and ``dt_w`` stay fp; the three byte
    counts equal JAX's."""
    pre = jamba["pre"]
    sub = pre["layers"]["sub"]
    assert isinstance(sub, list)
    for k in ("w_in", "w_out"):
        assert sub[0]["mamba"][k]["w_int"].dtype == torch.int8
    for k in ("w_x", "dt_w", "conv_w", "A_log"):
        assert isinstance(sub[0]["mamba"][k], torch.Tensor), k
    assert sub[3]["attn"]["wqkv"]["w_int"].shape == (1, 64, 128)
    assert sub[0]["mlp"]["w_up"]["w_int"].dtype == torch.int8
    for k in ("router", "w_up", "w_gate", "w_down"):
        assert isinstance(sub[1]["moe"][k], torch.Tensor), k
    got = TMON.resident_weight_bytes(pre)
    assert got == JMON.resident_weight_bytes(jamba["jpre"])
    assert TMON.resident_weight_bytes(jamba["params"]) == \
        JMON.resident_weight_bytes(jamba["jparams"])
    assert got[1] > 0 and got[2] == 0


def test_resident_bytes_refuses_a_node_it_cannot_walk():
    """A node that is neither a dict, a list nor a tensor raises instead of
    being skipped (its bytes would go uncounted)."""
    ok = {"a": [torch.zeros(3, dtype=torch.int8), {"b": torch.zeros(2)}]}
    assert TMON.resident_weight_bytes(ok) == (8, 3, 0)
    with pytest.raises(TypeError, match="ndarray"):
        TMON.resident_weight_bytes({"a": np.zeros(3)})
    with pytest.raises(TypeError, match="SiteScale"):
        TMON.resident_weight_bytes(
            {"s": TQ.SiteScale(torch.ones(()), torch.zeros(()))})


# ---------------------------------------------------------------------------
# forward, loss, cushion
# ---------------------------------------------------------------------------

def _check_flip_spreads_forward(err):
    """err (B, S): positions off by more than 1e-4 all lie in one row, at
    or after its first such position, and are within TIE: one code flipped
    upstream, carried to the later positions by the recurrence."""
    off = err > 1e-4
    rows = np.flatnonzero(off.any(-1))
    assert rows.size <= 1, err
    for r in rows:
        first = int(np.flatnonzero(off[r])[0])
        assert err[r, :first].max(initial=0) <= 1e-4, err
    assert err.max() <= TIE, err


def _pick(s, mode):
    qcfg = QMODES[mode]
    static = qcfg.mode == "pt_static"
    return (qcfg, s["jscales"] if static else None,
            s["scales"] if static else None)


@pytest.mark.parametrize("mode", list(QMODES))
def test_forward_logits_and_taps_match_jax(jamba, mode):
    s = jamba
    qcfg, js, ts = _pick(s, mode)
    jl, jt = jax.jit(lambda p, t: s["japi"].forward(
        p, {"tokens": t}, qcfg, scales=js, cushion=s["jcushion"],
        collect=True, remat=False))(s["jparams"], jnp.asarray(s["tokens"]))
    tl, tt = s["api"].forward(s["params"],
                              {"tokens": torch.from_numpy(s["tokens"])},
                              qcfg, scales=ts, cushion=s["cushion"],
                              collect=True)
    err = np.abs(tl.numpy() - np.asarray(jl)).max(-1)
    print(f"[{mode}] logits max |port - JAX| {err.max():.2e}, positions "
          f"over 1e-4: {int((err > 1e-4).sum())} of {err.size}")
    if mode == "none":
        assert err.max() <= 1e-4, err.max()
    else:
        _check_flip_spreads_forward(err)
    # under ptoken_dynamic a code flipped at one position spreads along
    # the recurrence: L_q and the channel maxima move with it
    flip = mode == "ptoken_dynamic"
    q_tol = 1e-4 if mode == "none" else (5e-2 if flip else 2e-3)
    tols = {"qerr": (q_tol, 0), "amin": (1e-5, 1e-5), "amax": (1e-5, 1e-5),
            "absmax_ch": (5e-2 if flip else 1e-5, 1e-5)}
    assert set(tt["layers"]) == set(jt["layers"])
    for site in TH.SITES:
        for key, (rtol, atol) in tols.items():
            np.testing.assert_allclose(
                tt["layers"][site][key].numpy(),
                np.asarray(jt["layers"][site][key]), rtol=rtol, atol=atol,
                err_msg=f"{site}.{key}")
    np.testing.assert_allclose(tt["head"]["qerr"].numpy(),
                               np.asarray(jt["head"]["qerr"]), rtol=q_tol)
    np.testing.assert_allclose(float(tt["lb_loss"]), float(jt["lb_loss"]),
                               rtol=1e-3 if mode != "none" else 0,
                               atol=1e-6)
    np.testing.assert_allclose(float(TH.total_qerr(tt)),
                               float(JH.T.total_qerr(jt)), rtol=q_tol)


def test_forward_return_cache_and_lb_without_collect(jamba):
    """``return_cache``: the Mamba state after the sequence; the taps carry
    ``lb_loss`` without ``collect``."""
    s = jamba
    jl, jt, jst = JH.forward(s["jparams"], jnp.asarray(s["tokens"]),
                             s["jcfg"], QN, cushion=s["jcushion"],
                             remat=False, return_cache=True)
    tl, tt, tst = TH.forward(s["params"], torch.from_numpy(s["tokens"]),
                             s["tcfg"], QN, cushion=s["cushion"],
                             return_cache=True)
    assert set(tt) == {"lb_loss"}
    np.testing.assert_allclose(float(tt["lb_loss"]), float(jt["lb_loss"]),
                               rtol=0, atol=1e-6)
    for k in ("h", "conv"):
        assert tst[k].shape == jst[k].shape
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_loss_fn_matches_jax(jamba, lam):
    """CE + load_balance_coef * lb (+ λ·L_q), with n_skip."""
    s = jamba
    toks = np.random.RandomState(8).randint(0, s["vocab"], (2, 17)) \
        .astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jaux = jax.jit(lambda p, b: s["japi"].loss_fn(
        p, b, QD, cushion=s["jcushion"], collect=True, remat=False,
        lam=lam, n_skip=2))(s["jparams"], jax.tree.map(jnp.asarray, batch))
    tl, taux = s["api"].loss_fn(s["params"], to_torch(batch), QD,
                                cushion=s["cushion"], collect=True, lam=lam,
                                n_skip=2)
    print(f"[lam {lam}] CE relative |port - JAX| "
          f"{abs(float(taux['ce']) / float(jaux['ce']) - 1):.2e}")
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(taux["lb"]), float(jaux["lb"]),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(float(taux["qerr"]), float(jaux["qerr"]),
                               rtol=1e-2)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)


def test_cushion_zeros_and_extract_cushion_match_jax(jamba):
    s = jamba
    z = s["api"].cushion_zeros(3)
    jz = s["japi"].cushion_zeros(3)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(np_tree(z))[0],
            jax.tree_util.tree_flatten_with_path(np_tree(jz))[0]):
        assert pa == pb and a.shape == b.shape and a.dtype == b.dtype, pa
        assert not a.any()
    cu = s["cushion"]
    got = s["api"].extract_cushion(s["params"], torch.tensor([7, 2, 11, 5]),
                                   None, QN)
    assert set(got) == {"kv", "state"}
    for grp in ("kv", "state"):
        for k in got[grp]:
            assert got[grp][k].dtype == cu[grp][k].dtype, (grp, k)
            np.testing.assert_allclose(got[grp][k].numpy(),
                                       cu[grp][k].numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"{grp}.{k}")
    assert got["state"]["h"].dtype == torch.float32


def test_a_cushion_without_state_is_refused(jamba):
    s = jamba
    with pytest.raises(ValueError, match="state"):
        s["api"].forward(s["params"],
                         {"tokens": torch.from_numpy(s["tokens"])}, QN,
                         cushion={"kv": s["cushion"]["kv"]})


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def _cmp_caches(jc, tc, int8: bool, rows=None):
    """The caches within their bars; ``rows``: the batch rows to compare
    (default all)."""
    jc = np_tree(jc)
    rows = slice(None) if rows is None else rows
    for k in ("h", "conv"):
        np.testing.assert_allclose(tc[k].numpy()[:, :, rows], jc[k][:, :, rows],
                                   rtol=0, atol=1e-5, err_msg=k)
    if not int8:
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].numpy()[:, rows], jc[k][:, rows],
                                       atol=1e-5)
        return
    for k in ("kc", "vc"):
        np.testing.assert_array_equal(tc[k].numpy(), jc[k])
    for k in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tc[k].numpy(), jc[k], rtol=1e-6)
    for k in ("k", "v"):
        d = np.abs(tc[k].numpy().astype(np.int32) - jc[k].astype(np.int32))
        assert d.max() <= 1, k
        assert (d > 0).mean() < 1e-3, (k, (d > 0).mean())


@pytest.mark.parametrize("mode,kv", [("none", "fp"), ("w8a8", "int8"),
                                     ("prequant", "int8"),
                                     ("prequant", "fp"),
                                     ("pt_dynamic", "fp"),
                                     ("ptoken_dynamic", "fp")])
def test_prefill_decode_match_jax(jamba, mode, kv):
    """With the cushion: the prefill's logits and cache (KV and Mamba
    state), then three decode steps, against JAX; weights fp (none, the
    dynamic modes), fp under true int8 (w8a8) or int8-resident
    (prequant). Under ptoken_dynamic a row whose prefill flipped a code
    (``_check_flip_spreads_forward``) keeps its logits within TIE, and
    the other rows are held to the bars."""
    s = jamba
    qcfg = {"none": QN, "pt_dynamic": QD,
            "ptoken_dynamic": QPT}.get(mode, QW8)
    static = qcfg is QW8
    jp = s["jpre"] if mode == "prequant" else s["jparams"]
    tp = s["pre"] if mode == "prequant" else s["params"]
    js = s["jscales"] if static else None
    ts = s["scales"] if static else None
    kv_dtype = None if kv == "fp" else "int8"
    B, S = s["tokens"].shape
    japi, api = s["japi"], s["api"]
    jcache = japi.init_cache(B, 32, kv_dtype=kv_dtype, prefix_len=4)
    tcache = api.init_cache(B, 32, kv_dtype=kv_dtype, prefix_len=4)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    jl, jcache, jpos = jax.jit(lambda p, t, c: japi.prefill(
        p, {"tokens": t}, c, qcfg, cushion=s["jcushion"], scales=js))(
            jp, jnp.asarray(s["tokens"]), jcache)
    tl, tcache, tpos = api.prefill(
        tp, {"tokens": torch.from_numpy(s["tokens"])}, tcache, qcfg,
        cushion=s["cushion"], scales=ts)
    assert int(tpos) == int(jpos) == 4 + S

    def cmp_logits(t, j):
        err = np.abs(t.numpy() - np.asarray(j)).reshape(B, -1).max(-1)
        if mode != "ptoken_dynamic":
            assert err.max() <= 1e-4, err
        _check_flip_spreads_forward(err[:, None])
        return [b for b in range(B) if err[b] <= 1e-4]

    keep = cmp_logits(tl, jl)
    _cmp_caches(jcache, tcache, kv_dtype is not None, keep)
    jdec = jax.jit(lambda p, t, pos, c: japi.decode_step(p, t, pos, c, qcfg,
                                                         scales=js))
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    h0 = tcache["h"]
    for step in range(3):
        jl, jcache = jdec(jp, jnp.asarray(tok), jpos + step, jcache)
        tl, tcache = api.decode_step(tp, torch.from_numpy(tok), tpos + step,
                                     tcache, qcfg, scales=ts)
        keep = [b for b in cmp_logits(tl, jl) if b in keep]
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert tcache["h"] is h0               # the state is written in place
    assert keep and (mode == "ptoken_dynamic" or len(keep) == B)
    _cmp_caches(jcache, tcache, kv_dtype is not None, keep)


def test_prefill_decode_matches_forward():
    """Prefill half the batch, decode the rest: the teacher-forced forward
    logits, with a cushion (``tests/test_models.py``'s check, at its
    bar)."""
    _, tcfg = configs()
    api = build(tcfg, "cpu")
    params = api.init_params(torch.Generator().manual_seed(0))
    batch = api.make_batch(torch.Generator().manual_seed(1), 2, 16)
    cushion = api.extract_cushion(params, torch.tensor([3, 9, 1]), None, QN)
    full, _ = api.forward(params, batch, QN, cushion=cushion)
    split = 8
    cache = api.init_cache(2, 64)
    lg, cache, pos = api.prefill(params, {"tokens":
                                          batch["tokens"][:, :split]},
                                 cache, QN, cushion=cushion)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, split - 1].numpy(),
                               rtol=5e-3, atol=5e-3)
    for i in range(split, 12):
        lg, cache = api.decode_step(params, batch["tokens"][:, i], pos,
                                    cache, QN)
        pos = pos + 1
        np.testing.assert_allclose(lg.numpy(), full[:, i].numpy(),
                                   rtol=5e-3, atol=5e-3)


def test_decode_per_row_pos_matches_single_slot(jamba):
    """Two slots prefilled to different depths decode as one batch with a
    (B,) pos: each row equals its slot decoded alone, the Mamba state
    scattered on axis 2 (``tests/test_serving.py``'s check)."""
    s = jamba
    api, params = s["api"], s["params"]
    rows, poss, toks, ref = [], [], [], []
    for i, L in enumerate((20, 26)):
        t = torch.from_numpy(np.random.RandomState(10 + i).randint(
            0, s["vocab"], (1, L)).astype(np.int32))
        c = api.init_cache(1, 64)
        lg, c, p = api.prefill(params, {"tokens": t}, c, QN,
                               cushion=s["cushion"])
        tok = lg[:, -1].argmax(-1).to(torch.int32)
        c1 = {k: v.clone() for k, v in c.items()}
        lr, _ = api.decode_step(params, tok, p, c1, QN)
        rows.append(c)
        poss.append(p)
        toks.append(tok[0])
        ref.append(lr[0])
    assert api.cache_batch_axes == {"k": 1, "v": 1, "h": 2, "conv": 2}
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
def test_int8_pool_matches_engine_and_jax(jamba, pool):
    """Five requests of ragged prompts and budgets through 2 int8 slots
    (so slots recycle) with W8A8 int8-resident weights: JAX's tokens,
    slots and ServeStats, and the port's static B=1 Engine's tokens. Paged,
    the KV pages and the Mamba state keeps its dense per-slot row."""
    s = jamba
    rs = np.random.RandomState(100)
    tokens = [rs.randint(0, s["vocab"], (1, [20, 26][i % 2]))
              .astype(np.int32) for i in range(5)]
    jreqs, treqs = _requests(tokens, [5, 3, 6, 4, 5])
    kw = dict(n_slots=2, max_seq=128, kv_dtype="int8", prequant=True)
    if pool == "paged":
        kw.update(paged=True, page_size=32)
    ce = ContinuousEngine(s["api"], s["params"], QW8, cushion=s["cushion"],
                          scales=s["scales"], **kw)
    if pool == "paged":
        assert ce.cache["h"].shape[2] == 2 and "page_table" in ce.cache
        assert ce.cache["k"].shape[1] == ce.n_pages
    jce = JContinuous(s["japi"], s["jparams"], QW8, cushion=s["jcushion"],
                      scales=s["jscales"], **kw)
    outs = ce.run(treqs)
    _same_outputs(jce.run(jreqs), outs)
    assert ce.stats.as_dict() == jce.stats.as_dict()
    assert ce.stats.recycles >= 1
    eng = Engine(s["api"], s["params"], QW8, cushion=s["cushion"],
                 scales=s["scales"], max_seq=128, kv_dtype="int8",
                 prequant=True)
    for r, o in zip(treqs, outs):
        np.testing.assert_array_equal(
            eng.generate(r.batch, r.max_new_tokens).tokens[0], o.tokens)


def test_fp_pool_matches_jax_and_never_chunks(jamba):
    """The fp contiguous pool against JAX's; with ``chunk_tokens`` set the
    hybrid still admits blocking (no chunked prefill for the family)."""
    s = jamba
    rs = np.random.RandomState(101)
    tokens = [rs.randint(0, s["vocab"], (1, [20, 40][i % 2]))
              .astype(np.int32) for i in range(4)]
    jreqs, treqs = _requests(tokens, [4, 3, 5, 4])
    kw = dict(n_slots=2, max_seq=128, chunk_tokens=16)
    ce = ContinuousEngine(s["api"], s["params"], QN, cushion=s["cushion"],
                          **kw)
    jce = JContinuous(s["japi"], s["jparams"], QN, cushion=s["jcushion"],
                      **kw)
    assert not s["api"].supports_chunked_prefill
    _same_outputs(jce.run(jreqs), ce.run(treqs))
    assert ce.stats.prefill_chunks == jce.stats.prefill_chunks == 0
    assert ce.stats.as_dict() == jce.stats.as_dict()


def test_prefix_cache_is_refused_where_the_reference_fails(jamba):
    """A stem's pages carry KV but no Mamba state, and the stem cushion
    extends the KV only: the reference's paged pool admits a hybrid with
    ``prefix_cache`` and raises at the first stem hit (its prefill looks
    up the cushion's ``state``). The port refuses the pool when it is
    made."""
    s = jamba
    rs = np.random.RandomState(7)
    stem = rs.randint(0, s["vocab"], (1, 64)).astype(np.int32)
    toks = [np.concatenate([stem, rs.randint(0, s["vocab"], (1, 8))
                            .astype(np.int32)], 1) for _ in range(2)]
    kw = dict(n_slots=1, max_seq=128, paged=True, page_size=16,
              prefix_cache=True)
    jreqs, _ = _requests(toks, [3, 3])
    jce = JContinuous(s["japi"], s["jparams"], QN, cushion=s["jcushion"],
                      **kw)
    with pytest.raises(KeyError, match="state"):
        jce.run(jreqs)
    with pytest.raises(ValueError, match="no stem to share"):
        ContinuousEngine(s["api"], s["params"], QN, cushion=s["cushion"],
                         **kw)


# ---------------------------------------------------------------------------
# calibration, the method
# ---------------------------------------------------------------------------

def test_calibration_scales_match_jax(jamba):
    """One scale a period and site (the sublayers merged), the head's."""
    s = jamba
    tsc, tstats = TCal.calibrate(s["api"], s["params"],
                                 to_torch([{"tokens": s["calib"]}]), QW8,
                                 cushion=s["cushion"])
    assert set(tsc) == set(TH.SITES) | {"head"}
    jsc = s["jscales"]
    for site in tsc:
        np.testing.assert_allclose(tsc[site].scale.numpy(),
                                   np.asarray(jsc[site].scale), rtol=1e-5)
        np.testing.assert_allclose(tsc[site].zero.numpy(),
                                   np.asarray(jsc[site].zero), rtol=0,
                                   atol=0)
        if site != "head":
            assert tsc[site].scale.shape == (1,)
    assert tstats["layers"]["mamba_out"]["absmax_ch"].shape == (1, 128)


def _jax_pools(vocab, ccfg, seed, n_iter):
    rng = jax.random.PRNGKey(seed)
    pools = []
    for _ in range(n_iter):
        rng, k1, _ = jax.random.split(rng, 3)
        pools.append(JCC.candidate_pool(k1, vocab, ccfg.n_candidates,
                                        ccfg.seed_tokens))
    return pools


def test_greedy_search_falls_back_and_matches_jax_tokens(jamba, monkeypatch):
    """``greedy_search`` on the hybrid takes ``greedy_search_ref`` (no
    KV-reuse scoring, as the reference), and with JAX's candidate pools
    finds JAX's prefix tokens."""
    s = jamba
    assert not s["api"].supports_kv_scoring
    with pytest.raises(NotImplementedError, match="greedy_search_ref"):
        s["api"].prefix_kv(s["params"], torch.tensor([1, 2]), QN)
    ccfg = CushionConfig(max_prefix_len=3, tau=1.5, n_candidates=16,
                         seed_tokens=(1,))
    jsample = {i: s["japi"].make_batch(jax.random.PRNGKey(1000 + i), 1, 24)
               for i in range(3)}
    jres = JCC.greedy_search(s["japi"], s["jparams"], lambda i: jsample[i],
                             QD, ccfg, jax.random.PRNGKey(0), chunk=8,
                             verbose=False)
    it = iter(_jax_pools(s["vocab"], ccfg, 0, 3))
    monkeypatch.setattr(TCC, "candidate_pool", lambda *a, **k: next(it))
    calls = []
    inner = TCC.greedy_search_ref
    monkeypatch.setattr(TCC, "greedy_search_ref",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    res = TCC.greedy_search(s["api"], s["params"],
                            lambda i: to_torch(jsample[i]), QD, ccfg,
                            torch.Generator(), chunk=8, verbose=False)
    assert calls == [1]
    np.testing.assert_array_equal(res.prefix_ids, jres.prefix_ids)
    assert [h["best_tok"] for h in res.history] == \
        [h["best_tok"] for h in jres.history]
    for h, jh in zip(res.history, jres.history):
        np.testing.assert_allclose([h["base_err"], h["best_err"]],
                                   [jh["base_err"], jh["best_err"]],
                                   rtol=1e-2)


def test_prefix_tune_matches_jax_and_freezes_state(jamba):
    """prefix_tune on the hybrid: its first steps' logs under ``none``
    against JAX's within the method's f32 bar; only ``kv`` trains, the
    ``state`` leaves come back bit-identical (both packages)."""
    s = jamba
    batches = [s["japi"].make_batch(jax.random.PRNGKey(3000 + i), 2, 16)
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
    for k in ("h", "conv"):
        assert torch.equal(ttr.cushion["state"][k], s["cushion"]["state"][k])
        np.testing.assert_array_equal(np.asarray(jtr.cushion["state"][k]),
                                      np.asarray(s["jcushion"]["state"][k]))
    assert not torch.equal(ttr.cushion["kv"]["k"], s["cushion"]["kv"]["k"])
    np.testing.assert_allclose(ttr.cushion["kv"]["k"].numpy(),
                               np.asarray(jtr.cushion["kv"]["k"]), rtol=0,
                               atol=1e-5)
