"""Port parity, model level: ``forward``, ``prefill`` and ``decode_step`` of
``repro_torch.models.transformer`` against the JAX model on the same
weights, cushion and calibrated scales, in modes none, pt_static with fp
weights (true int8, weight quantized per call) and prequantized W8A8, with
fp and int8 KV caches.

Configurations: ``paper_tiny`` (qkv bias, untied head: the head is
prequantized) and a reduced ``smollm-360m`` (tied head, G = 3), both f32.

Tolerances: logits allclose atol = 1e-4; fp caches atol = 1e-5; int8 cache
codes differ by at most 1 at under 0.1% of elements (RoPE's cos/sin may
differ by an ulp between XLA and PyTorch, which can move a code across a
rounding boundary); the fp cushion block kc/vc bit-exact.
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

from repro.configs import QuantConfig, get_config, reduced  # noqa: E402
from repro.core import calibration as JCal  # noqa: E402
from repro.core import quantization as JQ  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import quantization as TQ  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402

QN = QuantConfig()
QW8 = QuantConfig(mode="pt_static", true_int8=True)
MODES = {"none": (QN, False), "w8a8": (QW8, False), "prequant": (QW8, True)}
ARCHS = ("paper_tiny", "smollm-reduced")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def configs(arch):
    if arch == "paper_tiny":
        return get_config(arch), t_get_config(arch)
    kw = dict(n_heads=6, n_kv_heads=2, dtype="float32")
    return (reduced(get_config("smollm-360m"), **kw),
            t_reduced(t_get_config("smollm-360m"), **kw))


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg, tcfg = configs(request.param)
    japi = j_build(jcfg)
    api = build(tcfg, "cpu")
    jparams = japi.init_params(jax.random.PRNGKey(1))
    jcushion = japi.extract_cushion(
        jparams, jnp.asarray([7, 2, 11, 5], jnp.int32), None, QN)
    rs = np.random.RandomState(0)
    calib = rs.randint(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jscales, _ = JCal.calibrate(japi, jparams, [{"tokens": jnp.asarray(calib)}],
                                QW8, cushion=jcushion)
    params = convert.params_from_numpy(np_tree(jparams))
    return dict(
        jcfg=jcfg, tcfg=tcfg, japi=japi, api=api, jparams=jparams,
        jpre=JQ.prequantize_tree(jparams, QW8), params=params.tree(),
        pre=TQ.prequantize_tree(params.tree(), QW8), jcushion=jcushion,
        cushion=convert.cushion_from_numpy(np_tree(jcushion)),
        jscales=jscales,
        scales=convert.scales_from_numpy(
            np_tree(JCal.scales_to_plain(jscales))),
        tokens=rs.randint(0, jcfg.vocab_size, (2, 12)).astype(np.int32))


def _pick(s, mode):
    qcfg, prequant = MODES[mode]
    jp = s["jpre"] if prequant else s["jparams"]
    tp = s["pre"] if prequant else s["params"]
    js = s["jscales"] if qcfg.mode == "pt_static" else None
    ts = s["scales"] if qcfg.mode == "pt_static" else None
    return qcfg, jp, tp, js, ts


@pytest.mark.parametrize("mode", list(MODES))
def test_forward_logits_match_jax(setup, mode):
    s = setup
    qcfg, jp, tp, js, ts = _pick(s, mode)
    jl, _ = jax.jit(lambda p, t: s["japi"].forward(
        p, {"tokens": t}, qcfg, scales=js, cushion=s["jcushion"],
        remat=False))(jp, jnp.asarray(s["tokens"]))
    tl, _ = s["api"].forward(tp, {"tokens": torch.from_numpy(s["tokens"])},
                             qcfg, scales=ts, cushion=s["cushion"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)


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


@pytest.mark.parametrize("mode,kv", [(m, kv) for m in MODES
                                     for kv in ("fp", "int8")])
def test_prefill_decode_match_jax(setup, mode, kv):
    s = setup
    qcfg, jp, tp, js, ts = _pick(s, mode)
    kv_dtype = None if kv == "fp" else "int8"
    B, S = s["tokens"].shape
    max_seq, m = 32, 4
    japi, api = s["japi"], s["api"]
    jcache = japi.init_cache(B, max_seq, kv_dtype=kv_dtype, prefix_len=m)
    tcache = api.init_cache(B, max_seq, kv_dtype=kv_dtype, prefix_len=m)
    jpre = jax.jit(lambda p, t, c: japi.prefill(
        p, {"tokens": t}, c, qcfg, cushion=s["jcushion"], scales=js))
    jdec = jax.jit(lambda p, t, pos, c: japi.decode_step(
        p, t, pos, c, qcfg, scales=js))
    jl, jcache, jpos = jpre(jp, jnp.asarray(s["tokens"]), jcache)
    tl, tcache, tpos = api.prefill(
        tp, {"tokens": torch.from_numpy(s["tokens"])}, tcache, qcfg,
        cushion=s["cushion"], scales=ts)
    assert int(tpos) == int(jpos) == m + S
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    _cmp_caches(jcache, tcache, kv_dtype is not None)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for step in range(3):
        jl, jcache = jdec(jp, jnp.asarray(tok), jpos + step, jcache)
        tl, tcache = api.decode_step(tp, torch.from_numpy(tok), tpos + step,
                                     tcache, qcfg, scales=ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    _cmp_caches(jcache, tcache, kv_dtype is not None)


def test_cushion_extraction_and_zeros_match_jax(setup):
    s = setup
    np.testing.assert_allclose(s["cushion"]["kv"]["k"].numpy(),
                               np.asarray(s["jcushion"]["kv"]["k"]))
    ids = torch.tensor([7, 2, 11, 5], dtype=torch.int32)
    tc = s["api"].extract_cushion(s["params"], ids, None, QN)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["kv"][k].numpy(),
                                   np.asarray(s["jcushion"]["kv"][k]),
                                   atol=1e-5)
    z = s["api"].cushion_zeros(3)
    jz = s["japi"].cushion_zeros(3)
    assert tuple(z["kv"]["k"].shape) == jz["kv"]["k"].shape
    ph = TT.placeholder_all_scales(s["tcfg"], "cpu")
    assert set(ph) == set(TT.SITES) | {"head"}


def test_pt_static_without_scales_refused(setup):
    s = setup
    with pytest.raises(ValueError, match="placeholder"):
        s["api"].forward(s["params"], {"tokens": torch.zeros((1, 4),
                                                             dtype=torch.int32)},
                         dataclasses.replace(QW8))
