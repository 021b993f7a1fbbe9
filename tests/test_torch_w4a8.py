"""Port parity, W4A8 (int4-packed resident weights, int8 activations):
``pack_int4`` / ``unpack_int4``, ``prequantize(weight_bits=4)`` and
``prequantize_tree``, ``w4a8_matmul_plain`` against the JAX oracle
(``ref.w4a8_matmul_ref``) and the Pallas kernel in interpret mode, the
serving dot, and the static and paged continuous engines against the JAX
engines on both of the reference's routes (``REPRO_W4A8_KERNEL`` jnp and
pallas), on ``paper_tiny`` (groups of 128: 2 per d_model, 6 per d_ff).

Tolerances: packed nibbles, codes and ``w_scale`` values bit-exact;
``colsum`` (the scale-weighted column sum over G groups) within the bound
of two f32 summation orders, 2 (G - 1) 2^-24 sum_g |term_g|: XLA adds the
G products in another order than ``torch.sum`` (measured: bit-exact for
G <= 2 and for bf16 weights, up to 1.9e-6 apart at G = 20 in f32, where
|colsum| reaches 17.5); matmul outputs
rtol 1e-4, atol 1e-3, the reference's own bar between its routes
(``tests/test_w4a8.py``: the routes order the group-scale f32 sums
differently and agree to f32 rounding, not bit for bit); greedy tokens
identical, with the top-2 logit margin checked as in
``tests/test_torch_engine.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.flags as flags  # noqa: E402
from repro.configs import QuantConfig, get_config, reduced  # noqa: E402
from repro.core import calibration as JCal  # noqa: E402
from repro.core import quantization as JQ  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.kernels.w4a8_matmul import w4a8_matmul as j_w4a8  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro.serving import ContinuousEngine as JContinuous  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import quantization as TQ  # noqa: E402
from repro_torch.kernels.w4a8_matmul import w4a8_matmul_plain  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.serving.engine import Engine, plan_quantization  # noqa: E402
from repro_torch.serving.scheduler import (ContinuousEngine,  # noqa: E402
                                           Request)

try:
    import hypothesis
    import hypothesis.strategies as st
except ImportError:     # pragma: no cover
    hypothesis = st = None

QN = QuantConfig()
QW8 = QuantConfig(mode="pt_static", true_int8=True)
RTOL, ATOL = 1e-4, 1e-3
MIN_MARGIN = 2e-4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def tt(a):
    return convert.tensor_from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 2, 7, 8, 33, 256])
def test_pack_unpack_match_jax(K):
    """The full signed nibble range, even and odd K: the packed bytes equal
    JAX's, and both unpacks invert them."""
    wq = np.random.RandomState(K).randint(-8, 8, (K, 24)).astype(np.int8)
    jp = np.asarray(JQ.pack_int4(jnp.asarray(wq)))
    tp = TQ.pack_int4(torch.from_numpy(wq))
    assert tp.shape == ((K + 1) // 2, 24) and tp.dtype == torch.int8
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(TQ.unpack_int4(tp, K).numpy(), wq)
    np.testing.assert_array_equal(
        TQ.unpack_int4(tt(jp), K).numpy(),
        np.asarray(JQ.unpack_int4(jnp.asarray(jp), K)))


def test_pack_unpack_extreme_nibbles_and_stacked():
    """-8 (the sign-extension pivot) and 7 in both nibble slots; a stacked
    (L, K, N) leaf packs along its own axis 0 as JAX's does."""
    wq = np.asarray([[-8, 7], [7, -8], [-8, -8], [7, 7], [-1, 0]], np.int8)
    tp = TQ.pack_int4(torch.from_numpy(wq))
    np.testing.assert_array_equal(TQ.unpack_int4(tp, 5).numpy(), wq)
    np.testing.assert_array_equal(tp.numpy(),
                                  np.asarray(JQ.pack_int4(jnp.asarray(wq))))
    w3 = np.random.RandomState(1).randint(-8, 8, (6, 3, 5)).astype(np.int8)
    np.testing.assert_array_equal(
        TQ.pack_int4(torch.from_numpy(w3)).numpy(),
        np.asarray(JQ.pack_int4(jnp.asarray(w3))))


if hypothesis is not None:
    @hypothesis.settings(max_examples=25, deadline=None)
    @hypothesis.given(st.integers(min_value=1, max_value=70),
                      st.integers(min_value=1, max_value=16),
                      st.integers(min_value=0, max_value=2 ** 31 - 1))
    def test_pack_unpack_roundtrip_property(k, n, seed):
        """Any (K, N) int4 matrix round-trips exactly through the port's
        pack and unpack."""
        wq = np.random.RandomState(seed).randint(-8, 8, (k, n)) \
            .astype(np.int8)
        np.testing.assert_array_equal(
            TQ.unpack_int4(TQ.pack_int4(torch.from_numpy(wq)), k).numpy(),
            wq)


# ---------------------------------------------------------------------------
# prequantize(weight_bits=4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(256, 96), (960, 40), (640, 24), (33, 16)])
def test_prequantize_int4_matches_jax(dtype, K, N):
    """Groups of 128 (K = 256, 640), one group (K = 960, smollm's d_model:
    128 does not divide it) and odd K. ``w_packed`` equal, ``w_scale`` equal
    in the weight's dtype (as in JAX), ``colsum`` within the summation-order
    bound (exact for G <= 2)."""
    w = jnp.asarray(np.random.RandomState(K).randn(K, N) * 0.1).astype(dtype)
    jpq = np_tree(JQ.prequantize(w, QW8, weight_bits=4))
    tpq = TQ.prequantize(tt(w), QW8, weight_bits=4)
    G = K // 128 if K % 128 == 0 else 1
    assert tpq["w_packed"].shape == ((K + 1) // 2, N)
    assert tpq["w_scale"].shape == (G, N)
    assert tpq["w_scale"].dtype == getattr(torch, dtype)
    assert tpq["colsum"].dtype == torch.float32
    np.testing.assert_array_equal(tpq["w_packed"].numpy(), jpq["w_packed"])
    np.testing.assert_array_equal(tpq["w_scale"].float().numpy(),
                                  np.asarray(jpq["w_scale"], np.float32))
    wq = TQ.unpack_int4(tpq["w_packed"], K)
    assert int(wq.abs().max()) <= 7          # the restricted range
    terms = (wq.double().reshape(G, K // G, N).sum(1)
             * tpq["w_scale"].double()).abs().sum(0).numpy()
    err = np.abs(tpq["colsum"].numpy().astype(np.float64) - jpq["colsum"])
    assert (err <= 2 * (G - 1) * 2.0 ** -24 * terms).all(), err.max()
    with pytest.raises(ValueError, match="weight_bits"):
        TQ.prequantize(tt(w), QW8, weight_bits=5)


def test_prequantize_tree_int4_matches_jax():
    """Stacked (L, K, N) leaves quantized one layer at a time: the port's
    tree equals JAX's leaf for leaf (untied head packed too)."""
    jparams = j_build(get_config("paper_tiny")).init_params(
        jax.random.PRNGKey(0))
    jpq = np_tree(JQ.prequantize_tree(jparams, QW8, weight_bits=4))
    tpq = TQ.prequantize_tree(
        convert.params_from_numpy(np_tree(jparams)).tree(), QW8,
        weight_bits=4)
    n_packed = []

    def visit(j, t, path=()):
        assert set(j) == set(t), path
        for k in j:
            if isinstance(j[k], dict):
                visit(j[k], t[k], path + (k,))
                continue
            want = np.asarray(j[k], np.float32) if k == "w_scale" else j[k]
            if k == "colsum" and "w_packed" in j:
                # up to 6 groups: within the summation-order bound
                np.testing.assert_allclose(t[k].numpy(), want, rtol=0,
                                           atol=2 * 5 * 2.0 ** -24
                                           * np.abs(want).max() * 4)
            else:
                np.testing.assert_array_equal(t[k].numpy(), want)
            if k == "w_packed":
                n_packed.append(path)
    visit(jpq, tpq)
    assert len(n_packed) == 6 and "w_packed" in tpq["head"]["w"]
    assert tpq["layers"]["mlp"]["w_down"]["w_scale"].shape[1] == 6
    with pytest.raises(ValueError, match="weight_bits"):
        TQ.prequantize_tree(tpq, QW8, weight_bits=3)


def test_params_from_numpy_carries_a_jax_int4_tree():
    """A JAX W4A8-prequantized bf16 tree (a stacked (L, K, N) leaf, two
    groups) crosses through numpy with ``w_packed`` and ``colsum``
    unchanged; ``w_scale`` arrives in bf16, as the port's own
    prequantization stores it."""
    w = jnp.asarray(np.random.RandomState(4).randn(2, 256, 96) * 0.1) \
        .astype("bfloat16")
    tree = {"layers": {"attn": {"wqkv": w}}}
    jpq = np_tree(JQ.prequantize_tree(tree, QW8, weight_bits=4))
    got = convert.params_from_numpy(jpq).tree()["layers"]["attn"]["wqkv"]
    mine = TQ.prequantize_tree(convert.params_from_numpy(np_tree(tree))
                               .tree(), QW8, weight_bits=4)
    mine = mine["layers"]["attn"]["wqkv"]
    j = jpq["layers"]["attn"]["wqkv"]
    assert got["w_scale"].dtype == torch.bfloat16
    assert got["w_packed"].shape == (2, 128, 96)
    np.testing.assert_array_equal(got["w_packed"].numpy(), j["w_packed"])
    np.testing.assert_array_equal(got["colsum"].numpy(), j["colsum"])
    assert mine["w_scale"].dtype == torch.bfloat16
    assert torch.equal(got["w_scale"], mine["w_scale"])
    assert torch.equal(got["w_packed"], mine["w_packed"])
    assert torch.equal(got["colsum"], mine["colsum"])


# ---------------------------------------------------------------------------
# the matmul: plain version against the oracle and the Pallas kernel
# ---------------------------------------------------------------------------

def _packed_case(rs, M, K, N, group):
    x = rs.randint(-128, 128, (M, K)).astype(np.int8)
    wq = rs.randint(-7, 8, (K, N)).astype(np.int8)
    s_w = (rs.rand(K // group, N) * 0.02 + 1e-3).astype(np.float32)
    colsum_g = wq.astype(np.int32).reshape(K // group, group, N).sum(1)
    colsum = (colsum_g.astype(np.float32) * s_w).sum(0)
    return x, np.asarray(JQ.pack_int4(jnp.asarray(wq))), s_w, colsum


@pytest.mark.parametrize("M", [1, 4, 37])
@pytest.mark.parametrize("K,group", [(256, 64), (960, 960), (640, 128)])
def test_w4a8_plain_matches_ref_and_pallas(M, K, group):
    """Ragged M, several groups and one group of 960, an asymmetric zero
    point passed as stored plus the -128 shift (as the serving path
    does)."""
    rs = np.random.RandomState(M + K)
    N = 128
    x, packed, s_w, colsum = _packed_case(rs, M, K, N, group)
    s_x, z_x = np.float32(0.013), np.float32(125.0)
    ref = R.w4a8_matmul_ref(jnp.asarray(x), jnp.asarray(packed),
                            jnp.float32(s_x), jnp.float32(z_x - 128),
                            jnp.asarray(s_w), group_size=group)
    pal = j_w4a8(jnp.asarray(x), jnp.asarray(packed), s_x, z_x - 128,
                 jnp.asarray(s_w), jnp.asarray(colsum), group_size=group,
                 interpret=True)
    got = w4a8_matmul_plain(tt(x), tt(packed), tt(s_x), tt(z_x), tt(s_w),
                            tt(colsum), group, z_shift=-128.0)
    for want in (ref, pal):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    bf = w4a8_matmul_plain(tt(x), tt(packed), tt(s_x), tt(z_x), tt(s_w),
                           tt(colsum), group, z_shift=-128.0,
                           out_dtype=torch.bfloat16)
    assert torch.equal(bf, got.to(torch.bfloat16))


@pytest.mark.parametrize("route", ["jnp", "pallas"])
def test_w4a8_serving_dot_matches_jax(monkeypatch, route):
    """``qdot`` on an int4-prequantized weight (ragged lead dims, odd-free
    K with two groups) against JAX's ``qdot`` on its own prequantized
    weight, on both reference routes; an odd, group-indivisible K against
    the jnp route."""
    monkeypatch.setattr(flags, "W4A8_KERNEL", route)
    rs = np.random.RandomState(0)
    for K, lead in ((256, (3, 7)), (33, (4,))):
        x = jnp.asarray((rs.randn(*lead, K) * 2 + 0.7).astype(np.float32))
        w = jnp.asarray((rs.randn(K, 64) * 0.1).astype(np.float32))
        site = JQ.SiteScale(*JQ.params_from_minmax(jnp.min(x), jnp.max(x),
                                                   8, False))
        tsite = TQ.SiteScale(tt(site.scale), tt(site.zero))
        jpq = JQ.prequantize(w, QW8, weight_bits=4)
        tpq = TQ.prequantize(tt(w), QW8, weight_bits=4)
        if K % 2 and route == "pallas":
            continue                        # the Pallas kernel takes even K
        want = np.asarray(JQ.qdot(x, jpq, QW8, site))
        got = TQ.qdot(tt(x), tpq, QW8, tsite)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg = get_config("paper_tiny")
    japi = j_build(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(3))
    jcushion = japi.extract_cushion(jparams, jnp.asarray([9, 4, 1, 30],
                                                         jnp.int32), None, QN)
    rs = np.random.RandomState(11)
    calib = rs.randint(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jscales, _ = JCal.calibrate(japi, jparams,
                                [{"tokens": jnp.asarray(calib)}], QW8,
                                cushion=jcushion)
    return dict(
        japi=japi, jparams=jparams, jcushion=jcushion, jscales=jscales,
        api=build(t_get_config("paper_tiny"), "cpu"),
        params=convert.params_from_numpy(np_tree(jparams)),
        cushion=convert.cushion_from_numpy(np_tree(jcushion)),
        scales=convert.scales_from_numpy(
            np_tree(JCal.scales_to_plain(jscales))),
        tokens=rs.randint(0, jcfg.vocab_size, (2, 12)).astype(np.int32),
        vocab=jcfg.vocab_size)


def _min_margin(eng, tokens, gen_tokens):
    """Smallest top-1 minus top-2 logit gap along the generated trajectory
    (teacher-forced through the port's prefill and decode steps)."""
    top2 = _trajectory_logits(eng, tokens, gen_tokens).topk(2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


def _trajectory_logits(eng, tokens, gen_tokens):
    """The port's logits (steps, B, V) before each generated token,
    teacher-forced through its prefill and decode steps."""
    api = eng.api
    cache = api.init_cache(tokens.shape[0], eng.max_seq,
                           kv_dtype=eng.kv_dtype, prefix_len=eng.prefix_len)
    p = eng.params.tree()
    logits, cache, pos = api.prefill(p, {"tokens": torch.from_numpy(tokens)},
                                     cache, eng.qcfg, cushion=eng.cushion,
                                     scales=eng.scales)
    steps = [logits[:, -1]]
    for i in range(gen_tokens.shape[1] - 1):
        tok = torch.from_numpy(gen_tokens[:, i].astype(np.int32))
        logits, cache = api.decode_step(p, tok, pos + i, cache, eng.qcfg,
                                        scales=eng.scales)
        steps.append(logits)
    return torch.stack(steps).float()


def test_w4a8_engine_matches_jax_on_both_routes(tiny, monkeypatch):
    """W4A8 + int8 KV under the cushion: the port's greedy tokens equal the
    JAX Engine's on the jnp route and on the Pallas route (interpret), and
    the int4 residency equals JAX's and half of the W8A8 int8 residency."""
    s = tiny
    kw = dict(max_seq=48, kv_dtype="int8", prequant=True)
    eng = Engine(s["api"], s["params"], QW8, cushion=s["cushion"],
                 scales=s["scales"], weight_bits=4, **kw)
    res = eng.generate({"tokens": torch.from_numpy(s["tokens"])}, 8)
    for route in ("jnp", "pallas"):
        monkeypatch.setattr(flags, "W4A8_KERNEL", route)
        jeng = JEngine(s["japi"], s["jparams"], QW8, cushion=s["jcushion"],
                       scales=s["jscales"], weight_bits=4, **kw)
        jres = jeng.generate({"tokens": jnp.asarray(s["tokens"])}, 8)
        np.testing.assert_array_equal(res.tokens, jres.tokens, err_msg=route)
    assert eng.weight_bytes_int4 == jeng.weight_bytes_int4 > 0
    assert eng.weight_bytes_int8 == 0
    e8 = Engine(s["api"], s["params"], QW8, cushion=s["cushion"],
                scales=s["scales"], **kw)
    assert eng.weight_bytes_int4 == e8.weight_bytes_int8 // 2
    margin = _min_margin(eng, s["tokens"], res.tokens)
    assert margin > MIN_MARGIN, margin


def test_w4a8_paged_continuous_matches_static_and_jax(tiny, monkeypatch):
    """The paged ContinuousEngine on the packed tree: each request's tokens
    equal the static W4A8 Engine's at B = 1 and the JAX ContinuousEngine's,
    with the same slots and counters."""
    monkeypatch.setattr(flags, "W4A8_KERNEL", "jnp")
    s = tiny
    rs = np.random.RandomState(100)
    toks = [rs.randint(0, s["vocab"], (1, [20, 26][i % 2])).astype(np.int32)
            for i in range(4)]
    budgets = [5, 3, 6, 4]
    kw = dict(n_slots=2, max_seq=128, kv_dtype="int8", paged=True,
              page_size=32, prequant=True, weight_bits=4)
    ce = ContinuousEngine(s["api"], s["params"], QW8, cushion=s["cushion"],
                          scales=s["scales"], **kw)
    outs = ce.run([Request(uid=i, batch={"tokens": torch.from_numpy(t)},
                           max_new_tokens=n)
                   for i, (t, n) in enumerate(zip(toks, budgets))])
    jce = JContinuous(s["japi"], s["jparams"], QW8, cushion=s["jcushion"],
                      scales=s["jscales"], **kw)
    jouts = jce.run([JRequest(uid=i, batch={"tokens": jnp.asarray(t)},
                              max_new_tokens=n)
                     for i, (t, n) in enumerate(zip(toks, budgets))])
    assert [o.uid for o in outs] == [o.uid for o in jouts]
    for a, b in zip(jouts, outs):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.slot == a.slot
    assert ce.stats.as_dict() == jce.stats.as_dict()
    assert ce.stats.weight_bytes_int4 > 0 and ce.stats.recycles >= 1
    eng = Engine(s["api"], s["params"], QW8, cushion=s["cushion"],
                 scales=s["scales"], max_seq=128, kv_dtype="int8",
                 prequant=True, weight_bits=4)
    for t, n, o in zip(toks, budgets, outs):
        np.testing.assert_array_equal(
            eng.generate({"tokens": torch.from_numpy(t)}, n).tokens[0],
            o.tokens)


def test_weight_bits_guards(tiny):
    s = tiny
    kw = dict(cushion=s["cushion"], scales=s["scales"], max_seq=48)
    with pytest.raises(ValueError, match="weight_bits"):
        Engine(s["api"], s["params"], QW8, prequant=True, weight_bits=3, **kw)
    with pytest.raises(ValueError, match="prequant"):
        Engine(s["api"], s["params"], QW8, weight_bits=4, **kw)
    with pytest.raises(ValueError, match="prequant"):
        ContinuousEngine(s["api"], s["params"], QW8, weight_bits=4, **kw)
    with pytest.raises(ValueError, match="pt_static"):
        plan_quantization(s["api"], s["params"], QN, prequant=True,
                          weight_bits=4)


@pytest.fixture(scope="module")
def smollm_bf16():
    """A reduced smollm-360m in bf16 (2 layers, tied head; d_ff 256 gives
    ``down`` two groups of 128), with JAX's cushion and calibrated scales."""
    kw = dict(n_layers=2, d_ff=256, dtype="bfloat16")
    jcfg = reduced(get_config("smollm-360m"), **kw)
    japi = j_build(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(5))
    jcushion = japi.extract_cushion(jparams, jnp.asarray([9, 4, 1, 30],
                                                         jnp.int32), None, QN)
    rs = np.random.RandomState(12)
    calib = rs.randint(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jscales, _ = JCal.calibrate(japi, jparams,
                                [{"tokens": jnp.asarray(calib)}], QW8,
                                cushion=jcushion)
    return dict(
        japi=japi, jparams=jparams, jcushion=jcushion, jscales=jscales,
        api=build(t_reduced(t_get_config("smollm-360m"), **kw), "cpu"),
        params=convert.params_from_numpy(np_tree(jparams)),
        cushion=convert.cushion_from_numpy(np_tree(jcushion)),
        scales=convert.scales_from_numpy(
            np_tree(JCal.scales_to_plain(jscales))),
        tokens=rs.randint(0, jcfg.vocab_size, (2, 12)).astype(np.int32))


@pytest.mark.parametrize("weight_bits", [8, 4])
def test_bf16_resident_bytes_and_tokens_match_jax(smollm_bf16, monkeypatch,
                                                  weight_bits):
    """``w_scale`` is held in the weight's dtype, as the reference holds it:
    on a bf16 model the port's Engine and ContinuousEngine report JAX's
    fp / int8 / int4 resident bytes exactly (an f32 scale would add 2 bytes
    per W8A8 matrix and 2 G N per W4A8 scale matrix). The Engine's greedy
    tokens equal JAX's up to a near tie (``BF16_TIE``), where the two runs
    may part: bf16 logits of this random-weight model sit a few ulps apart,
    and the reference's W8A8 epilogue may contract into an FMA where the
    port rounds each step (ROADMAP queue 3)."""
    monkeypatch.setattr(flags, "W4A8_KERNEL", "jnp")
    s = smollm_bf16
    kw = dict(max_seq=48, kv_dtype="int8", prequant=True,
              weight_bits=weight_bits)
    eng = Engine(s["api"], s["params"], QW8, cushion=s["cushion"],
                 scales=s["scales"], **kw)
    jeng = JEngine(s["japi"], s["jparams"], QW8, cushion=s["jcushion"],
                   scales=s["jscales"], **kw)
    got = (eng.weight_bytes_fp, eng.weight_bytes_int8, eng.weight_bytes_int4)
    assert got == (jeng.weight_bytes_fp, jeng.weight_bytes_int8,
                   jeng.weight_bytes_int4)
    leaf = eng.params.tree()["layers"]["mlp"]["w_down"]["w_scale"]
    assert leaf.dtype == torch.bfloat16
    if weight_bits == 4:
        assert leaf.shape[1] == 2
    ckw = dict(n_slots=2, max_seq=64, kv_dtype="int8", prequant=True,
               weight_bits=weight_bits)
    ce = ContinuousEngine(s["api"], s["params"], QW8, cushion=s["cushion"],
                          scales=s["scales"], **ckw)
    jce = JContinuous(s["japi"], s["jparams"], QW8, cushion=s["jcushion"],
                      scales=s["jscales"], **ckw)
    assert (ce.stats.weight_bytes_fp, ce.stats.weight_bytes_int8,
            ce.stats.weight_bytes_int4) == got
    assert (jce.stats.weight_bytes_fp, jce.stats.weight_bytes_int8,
            jce.stats.weight_bytes_int4) == got
    res = eng.generate({"tokens": torch.from_numpy(s["tokens"])}, 8)
    jres = jeng.generate({"tokens": jnp.asarray(s["tokens"])}, 8)
    jt = np.asarray(jres.tokens)
    lg = _trajectory_logits(eng, s["tokens"], jt)
    for b in range(jt.shape[0]):
        part = np.flatnonzero(res.tokens[b] != jt[b])
        if len(part):
            n = part[0]
            gap = abs(float(lg[n, b, res.tokens[b, n]] - lg[n, b, jt[b, n]]))
            assert gap <= BF16_TIE, (b, n, gap)


# How far apart, in the port's bf16 logits (|logit| < 1 here), two tokens
# may be where the port's and JAX's greedy runs part: as
# ``test_torch_ptoken.py``'s bf16 bar, 4 ulps; a fault (a wrong scale or
# dtype) moves the logits by O(1).
BF16_TIE = 4 * 2.0 ** -8
