"""Port parity, the per-token dynamic baseline (``--quant ptoken_dynamic``):
``act_quant_ptoken_plain`` on f32 input against the Pallas
``act_quant_ptoken`` in interpret mode and ``ref.act_quant_ref(
per_token=True)``, ``act_fake_quant`` through it against JAX's
``act_fake_quant`` (the arithmetic of the activation's dtype: bf16-rounded
steps for bf16, f32 for f32), and the ``Engine`` and the ``ContinuousEngine``
under ``ptoken_dynamic`` against the JAX engines on ``paper_tiny`` (f32) and
a reduced ``smollm-360m`` (bf16, tied head).

Tolerances: codes, scales, zero points and fake-quantized activations
bit-exact against the oracle and JAX's eager model path (the plain versions
repeat their arithmetic step by step, with IEEE division); against the
Pallas kernel the scale within 1 ulp and codes within one step (a code
near a rounding tie can move with the scale): the kernel runs under
``jax.jit``,
where XLA turns the division by the constant qmax into a multiplication by
its f32 reciprocal, and the test shows that this is the whole difference.
Greedy tokens identical.
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
from repro.core import quantization as JQ  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.kernels.act_quant import act_quant_ptoken as j_ptoken  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro.serving import ContinuousEngine as JContinuous  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import quantization as TQ  # noqa: E402
from repro_torch.kernels.act_quant import act_quant_ptoken_plain  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.scheduler import (ContinuousEngine,  # noqa: E402
                                           Request)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def tt(a):
    return convert.tensor_from_numpy(np.asarray(a))


def _activation(rs, shape):
    """Rows of mixed sign with an outlier row (one channel at 60) and an
    all-zero row; an all-positive row checks the range through 0."""
    x = rs.randn(*shape).astype(np.float32) * 2 + 0.3
    flat = x.reshape(-1, shape[-1])
    if flat.shape[0] >= 3:
        flat[1, 7] = 60.0
        flat[2] = 0.0
    if flat.shape[0] >= 4:
        flat[3] = np.abs(flat[3]) + 0.5
    return x


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,dtype", [(1, "float32"), (4, "float32"),
                                     (37, "float32"), (37, "bfloat16")])
def test_ptoken_f32_mode_matches_pallas_and_ref(M, dtype, bits):
    """f32 input: codes, scale and zero bit-exact against the oracle;
    against the Pallas kernel (interpret) the scale within 1 ulp and codes
    within one step, and the Pallas outputs exactly those of the same
    arithmetic with the range multiplied by f32(1 / qmax). For f32 and
    bf16 activations (upcast to f32 by the caller, as the Pallas kernel
    upcasts them)."""
    x = jnp.asarray(_activation(np.random.RandomState(M), (M, 96))) \
        .astype(dtype)
    got = act_quant_ptoken_plain(tt(x.astype(jnp.float32)), bits=bits)
    ref = R.act_quant_ref(x.astype(jnp.float32), bits=bits, per_token=True)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.int8 and got[1].shape == (M, 1)
    pq, ps, pz = (np.asarray(a) for a in j_ptoken(x, bits=bits,
                                                   interpret=True))
    np.testing.assert_array_max_ulp(got[1].numpy(), ps, 1)
    assert np.abs(got[0].numpy().astype(int) - pq).max() <= 1
    qmax = np.float32(2 ** bits - 1)
    xf = np.asarray(x, np.float32)
    mn = np.minimum(xf.min(-1, keepdims=True), np.float32(0))
    rng = np.maximum(xf.max(-1, keepdims=True), np.float32(0)) - mn
    s = np.maximum(rng * (np.float32(1) / qmax), np.float32(1e-8))
    z = np.round(np.clip(-mn / s, 0, qmax))
    q = np.clip(np.round(xf / s + z), 0, qmax) - 128
    for mine, pallas in ((q, pq), (s, ps), (z, pz)):
        np.testing.assert_array_equal(mine, pallas)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_ptoken_fake_quant_matches_jax(dtype, bits):
    """``act_fake_quant`` under ptoken_dynamic (through
    ``act_quant_ptoken``) equals JAX's bit for bit on a (2, 24, 96)
    activation with an outlier row and a zero row; on a bf16 or f16
    activation the codes, scale and zero equal JAX's ``params_from_minmax``
    and ``quantize`` in that dtype."""
    cfg = QuantConfig(mode="ptoken_dynamic", a_bits=bits)
    x = jnp.asarray(_activation(np.random.RandomState(bits),
                                (2, 24, 96))).astype(dtype)
    got = TQ.act_fake_quant(tt(x), cfg)
    want = JQ.act_fake_quant(x, cfg)
    assert got.dtype == tt(want).dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    if dtype != "float32":
        x2 = x.reshape(-1, 96)
        js, jz = JQ.params_from_minmax(*JQ.act_minmax(x2, True), bits, False)
        jq = JQ.quantize(x2, js, jz, bits, False)
        q, s, z = act_quant_ptoken_plain(tt(x2), bits=bits)
        np.testing.assert_array_equal(q.numpy().astype(np.float32) + 128,
                                      np.asarray(jq, np.float32))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js, np.float32))
        np.testing.assert_array_equal(z.numpy(), np.asarray(jz, np.float32))


@pytest.mark.parametrize("symmetric", [False, True])
def test_ptoken_off_the_cpu_never_takes_the_tensor_path(symmetric):
    """Off the CPU, per-token fake-quant goes to the kernel's wrapper (which
    launches or raises) or raises: it never computes the kernel's function
    with tensor ops. A meta tensor stands in for a card here."""
    cfg = QuantConfig(mode="ptoken_dynamic", symmetric_a=symmetric)
    x = torch.empty((2, 8, 96), dtype=torch.float16, device="meta")
    with pytest.raises(ValueError):
        TQ.act_fake_quant(x, cfg)


def _configs(arch):
    if arch == "paper_tiny":
        return get_config(arch), t_get_config(arch)
    kw = dict(n_heads=6, n_kv_heads=2)          # bf16, the config's dtype
    return (reduced(get_config("smollm-360m"), **kw),
            t_reduced(t_get_config("smollm-360m"), **kw))


@pytest.mark.parametrize("arch", ["paper_tiny", "smollm-reduced-bf16"])
def test_ptoken_engine_matches_jax(arch):
    """``Engine`` under ptoken_dynamic (fp weights fake-quantized per call,
    fp KV, a 4-token cushion): greedy tokens identical to the JAX Engine's,
    f32 on paper_tiny and bf16 on the reduced smollm."""
    jcfg, tcfg = _configs(arch)
    qcfg = QuantConfig(mode="ptoken_dynamic")
    japi = j_build(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(5))
    jcushion = japi.extract_cushion(jparams, jnp.asarray([9, 4, 1, 30],
                                                         jnp.int32), None,
                                    QuantConfig())
    tokens = np.random.RandomState(2).randint(0, jcfg.vocab_size, (2, 12)) \
        .astype(np.int32)
    jeng = JEngine(japi, jparams, qcfg, cushion=jcushion, max_seq=48)
    eng = Engine(build(tcfg, "cpu"),
                 convert.params_from_numpy(np_tree(jparams)), qcfg,
                 cushion=convert.cushion_from_numpy(np_tree(jcushion)),
                 max_seq=48)
    jres = jeng.generate({"tokens": jnp.asarray(tokens)}, 8)
    res = eng.generate({"tokens": torch.from_numpy(tokens)}, 8)
    assert eng.params.tree()["embed"]["w"].dtype == (
        torch.bfloat16 if arch.endswith("bf16") else torch.float32)
    np.testing.assert_array_equal(res.tokens, jres.tokens)


# How far apart, in the port's logits, two tokens may be where the port's
# and JAX's greedy runs part under ptoken_dynamic: a per-token code flips on
# an ulp-level difference upstream (a value at a rounding tie, or a row's
# extreme), which moves a logit by up to 0.061 on paper_tiny (f32, |logit|
# ~3) and by 2 bf16 ulp on the reduced smollm (|logit| < 1), measured over
# the weights of 8 seeds. A fault (a wrong scale, slot or position) moves
# the logits by O(1).
PTOKEN_TIE = {"paper_tiny": 0.1, "smollm-reduced-bf16": 4 * 2.0 ** -8}


def _port_logits(eng, prompt, prefix):
    """The port's next-token logits after ``prompt`` and the generated
    ``prefix``, teacher-forced through its prefill and decode steps."""
    api, p = eng.api, eng.params.tree()
    cache = api.init_cache(1, eng.max_seq, kv_dtype=None,
                           prefix_len=eng.prefix_len)
    logits, cache, pos = api.prefill(p, {"tokens": torch.from_numpy(prompt)},
                                     cache, eng.qcfg, cushion=eng.cushion,
                                     scales=None)
    logits = logits[0, -1]
    for i, t in enumerate(prefix):
        logits, cache = api.decode_step(
            p, torch.tensor([t], dtype=torch.int32), pos + i, cache,
            eng.qcfg, scales=None)
        logits = logits[0]
    return logits.float()


@pytest.mark.parametrize("arch,paged", [("paper_tiny", False),
                                        ("smollm-reduced-bf16", True)])
def test_ptoken_continuous_engine_matches_jax(arch, paged):
    """``ContinuousEngine`` under ptoken_dynamic (fp pool, a 4-token
    cushion, 2 slots, 5 requests of ragged prompts and budgets, so slots
    recycle) against the JAX ContinuousEngine: slots and ``ServeStats``
    identical; tokens identical up to a near tie, where the two runs may
    part (``PTOKEN_TIE``), and most requests identical throughout.
    Contiguous pool on paper_tiny (f32), paged on the reduced smollm
    (bf16); the weights of ``test_ptoken_engine_matches_jax``."""
    jcfg, tcfg = _configs(arch)
    qcfg = QuantConfig(mode="ptoken_dynamic")
    japi = j_build(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(5))
    jcushion = japi.extract_cushion(jparams, jnp.asarray([9, 4, 1, 30],
                                                         jnp.int32), None,
                                    QuantConfig())
    rs = np.random.RandomState(4)
    budgets = [5, 3, 6, 4, 5]
    prompts = [rs.randint(0, jcfg.vocab_size, (1, (20, 26)[i % 2]))
               .astype(np.int32) for i in range(len(budgets))]
    jreqs = [JRequest(uid=i, batch={"tokens": jnp.asarray(t)},
                      max_new_tokens=n)
             for i, (t, n) in enumerate(zip(prompts, budgets))]
    treqs = [Request(uid=i, batch={"tokens": torch.from_numpy(t)},
                     max_new_tokens=n)
             for i, (t, n) in enumerate(zip(prompts, budgets))]
    kw = dict(paged=True, page_size=16) if paged else {}
    api = build(tcfg, "cpu")
    params = convert.params_from_numpy(np_tree(jparams))
    cushion = convert.cushion_from_numpy(np_tree(jcushion))
    jce = JContinuous(japi, jparams, qcfg, n_slots=2, max_seq=64,
                      cushion=jcushion, **kw)
    ce = ContinuousEngine(api, params, qcfg, n_slots=2, max_seq=64,
                          cushion=cushion, **kw)
    j_outs, t_outs = jce.run(jreqs), ce.run(treqs)
    assert [o.uid for o in t_outs] == [o.uid for o in j_outs]
    assert ce.stats.as_dict() == jce.stats.as_dict()
    assert ce.stats.recycles >= 1
    eng = Engine(api, params, qcfg, cushion=cushion, max_seq=64)
    same = 0
    for a, b in zip(j_outs, t_outs):
        assert b.slot == a.slot
        part = np.flatnonzero(a.tokens != b.tokens)
        if not len(part):
            same += 1
            continue
        n = part[0]
        lg = _port_logits(eng, prompts[a.uid], a.tokens[:n])
        gap = abs(float(lg[b.tokens[n]] - lg[a.tokens[n]]))
        assert gap <= PTOKEN_TIE[arch], (a.uid, n, gap)
    assert same >= 3, same
