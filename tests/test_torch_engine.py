"""Port parity, serving: ``repro_torch.serving.engine.Engine.generate``
against the JAX ``Engine`` on the same weights, cushion and scales —
greedy, 16 tokens, in fp, pt_static with fp weights, prequantized W8A8 and
prequantized W8A8 with an int8 KV cache, on ``paper_tiny`` (untied head,
qkv bias) and a reduced ``smollm-360m`` (tied head, G = 3). Tokens must be
identical.

A greedy tie would let identical tokens pass by luck, so every case also
measures the smallest top-1/top-2 logit margin along the port's trajectory
and requires it to exceed twice the logit tolerance of the model tests
(2 x 1e-4): at that margin the two frameworks cannot pick different tokens.
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
from repro.models.registry import build as j_build  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import quantization as TQ  # noqa: E402
from repro_torch.core.calibration import CalibratedScales  # noqa: E402
from repro_torch.core.cushioncache import cushion_fingerprint  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.serving.engine import (Engine, bucket_steps,  # noqa: E402
                                        cache_seq_len, plan_quantization)

QN = QuantConfig()
QW8 = QuantConfig(mode="pt_static", true_int8=True)
# mode -> (qcfg, prequant, kv_dtype)
MODES = {"fp": (QN, False, None), "w8a8": (QW8, False, None),
         "prequant": (QW8, True, None), "prequant_int8kv": (QW8, True, "int8")}
N_TOKENS = 16
MIN_MARGIN = 2e-4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def configs(arch):
    if arch == "paper_tiny":
        return get_config(arch), t_get_config(arch)
    kw = dict(n_heads=6, n_kv_heads=2, dtype="float32")
    return (reduced(get_config("smollm-360m"), **kw),
            t_reduced(t_get_config("smollm-360m"), **kw))


@pytest.fixture(scope="module", params=["paper_tiny", "smollm-reduced"])
def setup(request):
    jcfg, tcfg = configs(request.param)
    japi = j_build(jcfg)
    api = build(tcfg, "cpu")
    jparams = japi.init_params(jax.random.PRNGKey(3))
    jcushion = japi.extract_cushion(
        jparams, jnp.asarray([9, 4, 1, 30], jnp.int32), None, QN)
    rs = np.random.RandomState(11)
    calib = rs.randint(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jscales, _ = JCal.calibrate(japi, jparams,
                                [{"tokens": jnp.asarray(calib)}], QW8,
                                cushion=jcushion)
    return dict(
        japi=japi, api=api, jparams=jparams, jcushion=jcushion,
        jscales=jscales,
        params=convert.params_from_numpy(np_tree(jparams)),
        cushion=convert.cushion_from_numpy(np_tree(jcushion)),
        scales=convert.scales_from_numpy(
            np_tree(JCal.scales_to_plain(jscales))),
        tokens=rs.randint(0, jcfg.vocab_size, (2, 12)).astype(np.int32))


def _min_margin(eng, tokens, gen_tokens):
    """Smallest top-1 minus top-2 logit gap along the generated trajectory
    (teacher-forced through the port's prefill and decode steps)."""
    api = eng.api
    B = tokens.shape[0]
    cache = api.init_cache(B, eng.max_seq, kv_dtype=eng.kv_dtype,
                           prefix_len=eng.prefix_len)
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
    top2 = torch.stack(steps).topk(2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_greedy_tokens_identical_to_jax(setup, mode):
    s = setup
    qcfg, prequant, kv_dtype = MODES[mode]
    static = qcfg.mode == "pt_static"
    jeng = JEngine(s["japi"], s["jparams"], qcfg, cushion=s["jcushion"],
                   scales=s["jscales"] if static else None, max_seq=48,
                   kv_dtype=kv_dtype, prequant=prequant)
    eng = Engine(s["api"], s["params"], qcfg, cushion=s["cushion"],
                 scales=s["scales"] if static else None, max_seq=48,
                 kv_dtype=kv_dtype, prequant=prequant)
    jres = jeng.generate({"tokens": jnp.asarray(s["tokens"])}, N_TOKENS)
    res = eng.generate({"tokens": torch.from_numpy(s["tokens"])}, N_TOKENS)
    assert res.tokens.shape == (2, N_TOKENS)
    np.testing.assert_array_equal(res.tokens, jres.tokens)
    assert eng.weight_bytes_int8 == jeng.weight_bytes_int8
    margin = _min_margin(eng, s["tokens"], res.tokens)
    print(f"[{mode}] min top-2 logit margin {margin:.3e}")
    assert margin > MIN_MARGIN, margin
    # the per-token host loop agrees with the device loop
    np.testing.assert_array_equal(
        eng.generate_py({"tokens": torch.from_numpy(s["tokens"])},
                        N_TOKENS).tokens, res.tokens)


def test_engine_sampling_and_plan_guards(setup):
    s = setup
    eng = Engine(s["api"], s["params"], QN, cushion=s["cushion"], max_seq=40)
    batch = {"tokens": torch.from_numpy(s["tokens"])}
    a = eng.generate(batch, 6, greedy=False,
                     generator=torch.Generator().manual_seed(0))
    b = eng.generate(batch, 6, greedy=False,
                     generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert eng.generate(batch, 1).tpot_ms == 0.0
    with pytest.raises(ValueError, match="placeholder"):
        plan_quantization(s["api"], s["params"], QW8)
    with pytest.raises(ValueError, match="pt_static"):
        plan_quantization(s["api"], s["params"], QN, prequant=True)
    stale = CalibratedScales(s["scales"], cushion_fingerprint(None))
    with pytest.raises(ValueError, match="stale"):
        plan_quantization(s["api"], s["params"], QW8, cushion=s["cushion"],
                          scales=stale)
    ok = CalibratedScales(s["scales"], cushion_fingerprint(s["cushion"]))
    tree, sc = plan_quantization(s["api"], s["params"], QW8,
                                 cushion=s["cushion"], scales=ok,
                                 prequant=True)
    assert sc is s["scales"] and "w_int" in tree["layers"]["attn"]["wqkv"]
    # the W4A8 format: nibble-packed (L, K/2, N), (L, G, N) scales in the
    # weight dtype (f32 here)
    tree4, _ = plan_quantization(s["api"], s["params"], QW8,
                                 cushion=s["cushion"], scales=ok,
                                 prequant=True, weight_bits=4)
    w4 = tree4["layers"]["attn"]["wqkv"]
    L, K, N = s["params"].tree()["layers"]["attn"]["wqkv"].shape
    G = K // 128 if K % 128 == 0 else 1
    assert set(w4) == {"w_packed", "w_scale", "colsum"}
    assert w4["w_packed"].shape == (L, K // 2, N)
    assert w4["w_packed"].dtype == torch.int8
    assert w4["w_scale"].shape == (L, G, N)
    assert w4["w_scale"].dtype == w4["colsum"].dtype == torch.float32
    assert torch.equal(TQ.unpack_int4(w4["w_packed"][0], K),
                       TQ.weight_quant_int4(
                           s["params"].tree()["layers"]["attn"]["wqkv"][0],
                           QW8)[0])
    assert (cache_seq_len(129), bucket_steps(9), bucket_steps(0)) \
        == (256, 16, 0)
