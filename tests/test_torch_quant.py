"""Port parity, quantization core and its artifacts: quantizer arithmetic
(with JAX's bf16/f32 type promotion), true-int8 dots, ``prequantize_tree``,
``calibrate`` and ``cushion_fingerprint`` against the JAX package, on the
same numpy inputs and weights.

Tolerances: integer codes, ``w_int``, ``colsum`` bit-exact and ``w_scale``
exact; true-int8 dot outputs within 1 ulp (f32 epilogue, FMA contraction
in XLA); calibrated scales rtol = 1e-5 (the activation statistics come out
of two frameworks' f32 forwards); fingerprints identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import QuantConfig, get_config, reduced  # noqa: E402
from repro.core import calibration as JCal  # noqa: E402
from repro.core import quantization as JQ  # noqa: E402
from repro.core.cushioncache import cushion_fingerprint as j_fingerprint  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import calibration as TCal  # noqa: E402
from repro_torch.core import quantization as TQ  # noqa: E402
from repro_torch.core.cushioncache import cushion_fingerprint  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402

QW8 = QuantConfig(mode="pt_static", true_int8=True)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def tt(a):
    return convert.tensor_from_numpy(np.asarray(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizers_match_jax(dtype):
    rs = np.random.RandomState(0)
    x = jnp.asarray(rs.randn(33, 40) * 3 + 0.5).astype(dtype)
    w = jnp.asarray(rs.randn(40, 24) * 0.1).astype(dtype)
    xt, wt = tt(x), tt(w)
    for sym in (False, True):
        js, jz = JQ.params_from_minmax(jnp.min(x), jnp.max(x), 8, sym)
        ts, tz = TQ.params_from_minmax(xt.amin(), xt.amax(), 8, sym)
        np.testing.assert_array_equal(ts.float().numpy(),
                                      np.asarray(js, np.float32))
        np.testing.assert_array_equal(tz.float().numpy(),
                                      np.asarray(jz, np.float32))
    # static f32 site scales on bf16 activations: JAX promotes to f32
    s, z = jnp.float32(0.029), jnp.float32(97.0)
    jq = JQ.quantize(x, s, z, 8, False)
    tq = TQ.quantize(xt, tt(s), tt(z), 8, False)
    assert tq.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    jw, jsw = JQ.weight_quant_int(w, QW8)
    tw, tsw = TQ.weight_quant_int(wt, QW8)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tsw.dtype == tt(jsw).dtype and torch.equal(tsw, tt(jsw))
    np.testing.assert_array_equal(
        TQ.weight_fake_quant(wt, QW8).float().numpy(),
        np.asarray(JQ.weight_fake_quant(w, QW8), np.float32))


@pytest.mark.parametrize("lead", [(5,), (2, 7)])
def test_true_int_dots_match_jax(lead):
    rs = np.random.RandomState(len(lead))
    x = jnp.asarray((rs.randn(*lead, 64) * 2 + 0.3).astype(np.float32))
    w = jnp.asarray((rs.randn(64, 48) * 0.1).astype(np.float32))
    site = JQ.SiteScale(*JQ.params_from_minmax(jnp.min(x), jnp.max(x), 8,
                                               False))
    tsite = TQ.SiteScale(tt(site.scale), tt(site.zero))
    a = TQ.true_int_dot(tt(x), tt(w), QW8, tsite)
    np.testing.assert_array_max_ulp(
        a.numpy(), np.asarray(JQ.true_int_dot(x, w, QW8, site)), 1)
    # the model-level entry (ops.qdot, as the reference's qdot_pallas)
    assert torch.equal(ops.qdot(tt(x), tt(w), QW8, tsite), a)
    pq = JQ.prequantize(w, QW8)
    tpq = TQ.prequantize(tt(w), QW8)
    for key in ("w_int", "colsum"):
        np.testing.assert_array_equal(tpq[key].numpy(), np.asarray(pq[key]))
    b = TQ.qdot(tt(x), tpq, QW8, tsite)
    np.testing.assert_array_max_ulp(
        b.numpy(), np.asarray(JQ.qdot(x, pq, QW8, site)), 1)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.fixture(scope="module")
def tiny():
    jcfg = get_config("paper_tiny")
    japi = j_build(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(0))
    api = build(t_get_config("paper_tiny"), "cpu")
    return jcfg, japi, jparams, api, convert.params_from_numpy(
        np_tree(jparams))


def test_prequantize_tree_matches_jax(tiny):
    jcfg, japi, jparams, api, params = tiny
    jpq = np_tree(JQ.prequantize_tree(jparams, QW8))
    tpq = TQ.prequantize_tree(params.tree(), QW8)

    def visit(j, t, path=()):
        assert set(j) == set(t), path
        for k in j:
            if isinstance(j[k], dict):
                visit(j[k], t[k], path + (k,))
            elif k == "w_scale":
                np.testing.assert_array_equal(
                    t[k].numpy(), np.asarray(j[k], np.float32))
            else:
                assert t[k].dtype == tt(j[k]).dtype, path + (k,)
                np.testing.assert_array_equal(t[k].numpy(), j[k])
    visit(jpq, tpq)
    assert "w_int" in tpq["head"]["w"]          # untied head prequantized


def test_calibrate_matches_jax_under_cushion(tiny):
    jcfg, japi, jparams, api, params = tiny
    ids = jnp.asarray([3, 17, 5], jnp.int32)
    jcushion = japi.extract_cushion(jparams, ids, None, QuantConfig())
    cushion = convert.cushion_from_numpy(np_tree(jcushion))
    rs = np.random.RandomState(7)
    toks = [rs.randint(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
            for _ in range(2)]
    jsc, jstats = JCal.calibrate(japi, jparams,
                                 [{"tokens": jnp.asarray(x)} for x in toks],
                                 QW8, cushion=jcushion)
    tsc, _ = TCal.calibrate(api, params,
                            [{"tokens": torch.from_numpy(x)} for x in toks],
                            QW8, cushion=cushion)
    jplain = np_tree(JCal.scales_to_plain(jsc))
    tplain = TCal.scales_to_plain(tsc)
    assert set(jplain) == set(tplain)
    for site in jplain:
        for k in ("scale", "zero"):
            np.testing.assert_allclose(tplain[site][k].numpy(),
                                       jplain[site][k], rtol=1e-5)
    # the plain round trip and the tagged form
    back = TCal.scales_from_plain(tplain)
    assert torch.equal(back["qkv"].scale, tsc["qkv"].scale)
    tagged, _ = TCal.calibrate_tagged(api, params,
                                      [{"tokens": torch.from_numpy(toks[0])}],
                                      QW8, cushion=cushion)
    assert tagged.cushion_fp == j_fingerprint(jcushion)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cushion_fingerprint_identical(dtype):
    rs = np.random.RandomState(5)
    jc = {"kv": {"k": jnp.asarray(rs.randn(2, 3, 2, 8)).astype(dtype),
                 "v": jnp.asarray(rs.randn(2, 3, 2, 8)).astype(dtype)}}
    tc = convert.cushion_from_numpy(np_tree(jc))
    assert cushion_fingerprint(tc) == j_fingerprint(jc)
    assert cushion_fingerprint(None) == j_fingerprint(None) == "none"
    tc["kv"]["v"][0, 0, 0, 0] += 1
    assert cushion_fingerprint(tc) != j_fingerprint(jc)


def test_site_stats_qerr_merge_match_jax():
    rs = np.random.RandomState(9)
    a = jnp.asarray(rs.randn(2, 10, 16).astype(np.float32))
    b = jnp.asarray((rs.randn(2, 10, 16) * 2).astype(np.float32))
    qd = QuantConfig(mode="pt_dynamic")
    for n_skip in (0, 3):
        np.testing.assert_allclose(
            TQ.site_qerr(tt(a), qd, None, n_skip).numpy(),
            np.asarray(JQ.site_qerr(a, qd, None, n_skip)), rtol=1e-6)
    js = JQ.merge_stats(JQ.site_stats(a, 2), JQ.site_stats(b, 2))
    ts = TQ.merge_stats(TQ.site_stats(tt(a), 2), TQ.site_stats(tt(b), 2))
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    jsc = JQ.scales_from_stats({"x": js}, QW8)["x"]
    tsc = TQ.scales_from_stats({"x": ts}, QW8)["x"]
    np.testing.assert_array_equal(tsc.scale.numpy(), np.asarray(jsc.scale))
    np.testing.assert_array_equal(tsc.zero.numpy(), np.asarray(jsc.zero))


def test_reduced_configs_resolve_alike():
    for arch in ("smollm-360m", "paper_tiny", "qwen1.5-0.5b"):
        j = reduced(get_config(arch), n_heads=6, dtype="float32")
        t = t_reduced(t_get_config(arch), n_heads=6, dtype="float32")
        assert {k: getattr(j, k) for k in ("n_layers", "d_model", "n_heads",
                                           "n_kv_heads", "head_dim", "d_ff",
                                           "vocab_size", "tie_embeddings")} \
            == {k: getattr(t, k) for k in ("n_layers", "d_model", "n_heads",
                                           "n_kv_heads", "head_dim", "d_ff",
                                           "vocab_size", "tie_embeddings")}


@pytest.mark.parametrize("qcfg", [
    QuantConfig(mode="pt_dynamic", true_int8=True),
    QuantConfig(mode="pt_static", true_int8=True, symmetric_a=True)],
    ids=["bf16-dynamic-range", "symmetric"])
def test_true_int_quantize_off_the_cpu_raises_without_kernel(qcfg,
                                                            monkeypatch):
    """Symmetric activation codes, which no kernel takes, come from tensor
    ops on the CPU and raise on any other device. A bf16 dynamic range
    (pt_dynamic under true int8) gives codes in bf16-rounded steps, which
    the reference forms with jnp's ``quantize`` outside its kernels: those
    are tensor ops on every device, and the int matmul kernel runs on the
    int8 codes (the encoder-decoder's W8A8 on the card). A meta tensor
    stands in for a card."""
    x = torch.empty((2, 8, 16), dtype=torch.bfloat16, device="meta")
    w = torch.empty((16, 24), dtype=torch.bfloat16, device="meta")
    site = TQ.SiteScale(torch.ones((), device="meta"),
                        torch.zeros((), device="meta"))
    if qcfg.symmetric_a:
        with pytest.raises(ValueError, match="CPU only"):
            TQ.true_int_dot(x, w, qcfg, site)
    else:
        seen = []

        def matmul(xq, w_int, *a, **k):
            seen.append(xq)
            return torch.empty((xq.shape[0], w_int.shape[1]), device="meta")

        monkeypatch.setattr(TQ, "w8a8_matmul", matmul)
        assert TQ.true_int_dot(x, w, qcfg, site).shape == (2, 8, 24)
        assert len(seen) == 1 and seen[0].dtype == torch.int8
        assert seen[0].device.type == "meta"
        monkeypatch.undo()
    xc = torch.randn((2, 8, 16)).to(torch.bfloat16)
    wc = torch.randn((16, 24)).to(torch.bfloat16)
    site_c = TQ.SiteScale(torch.tensor(0.05), torch.tensor(0.0))
    assert TQ.true_int_dot(xc, wc, qcfg, site_c).shape == (2, 8, 24)
