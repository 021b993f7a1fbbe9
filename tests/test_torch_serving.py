"""Port parity, continuous batching over a contiguous slot pool:
``repro_torch.serving.scheduler.ContinuousEngine`` against the JAX one on
``paper_tiny``, on the same weights, cushion and numpy prompts.

* ``flash_decode_plain`` with per-row (B, K) scales (the pool's per-slot
  scales) against ``ref.flash_decode_ref`` (f32 within 1e-6: both dense)
  and the JAX Pallas ``flash_decode`` in interpret mode (within 1e-5, as in
  ``test_torch_kernels.py``: the Pallas kernel folds 32-key blocks, so its
  sums run in another order), over ragged per-row positions.
* A recycling trace (two slots, five requests) gives the JAX engine's
  tokens, slot assignments and ``ServeStats`` for fp, int8 KV with per-slot
  scales, and prequantized W8A8 + int8 KV; the cushion stays bit-identical
  in every recycled slot.
* EOS retirement, ``cancel``, the over-capacity rejection and the
  launcher's continuous mode on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import QuantConfig, get_config  # noqa: E402
from repro.core import calibration as JCal  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.kernels.flash_decode import flash_decode as j_flash_decode  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro.serving import ContinuousEngine as JContinuous  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.serving.scheduler import (ContinuousEngine,  # noqa: E402
                                           Request)

QN = QuantConfig()
QW8 = QuantConfig(mode="pt_static", true_int8=True)

# ---------------------------------------------------------------------------
# Kernel: per-row (B, K) KV scales
# ---------------------------------------------------------------------------

_B, _K, _G, _HD, _SMAX, _M = 4, 2, 2, 16, 64, 8
_RS = np.random.RandomState(7)
_Q = _RS.randn(_B, _K * _G, _HD).astype(np.float32)
_KQ = _RS.randint(-127, 128, (_B, _SMAX, _K, _HD)).astype(np.int8)
_VQ = _RS.randint(-127, 128, (_B, _SMAX, _K, _HD)).astype(np.int8)
_KSR = _RS.rand(_B, _K).astype(np.float32) * 0.05 + 0.01
_VSR = _RS.rand(_B, _K).astype(np.float32) * 0.05 + 0.01
_KC = _RS.randn(_M, _K, _HD).astype(np.float32)
_VC = _RS.randn(_M, _K, _HD).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("cushion", [True, False], ids=["cushion", "bare"])
@pytest.mark.parametrize("pos", [
    [_M, -1, _SMAX - 1, _M - 1],    # cushion boundary, retired, full, m-1
    [0, 17, 31, 32],                # chunk-edge straddle
    [3, 60, -1, 33],                # ragged mid-decode pool
])
def test_per_row_scales_match_pallas_and_ref(pos, cushion):
    posv = np.asarray(pos, np.int32)
    kj = dict(k_scale=jnp.asarray(_KSR), v_scale=jnp.asarray(_VSR))
    kt = dict(k_scale=_t(_KSR), v_scale=_t(_VSR))
    if cushion:
        kj.update(kc=jnp.asarray(_KC), vc=jnp.asarray(_VC))
        kt.update(kc=_t(_KC), vc=_t(_VC))
    ours = flash_decode(_t(_Q), _t(_KQ), _t(_VQ), _t(posv), **kt).numpy()
    args = (jnp.asarray(_Q), jnp.asarray(_KQ), jnp.asarray(_VQ),
            jnp.asarray(posv))
    pallas = j_flash_decode(*args, bkv=32, interpret=True, **kj)
    np.testing.assert_allclose(ours, np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ours, np.asarray(R.flash_decode_ref(*args,
                                                                   **kj)),
                               rtol=1e-6, atol=1e-6)
    # per-row scales that are all equal give the shared (K,) result
    same = dict(kt, k_scale=_t(np.tile(_KSR[:1], (_B, 1))),
                v_scale=_t(np.tile(_VSR[:1], (_B, 1))))
    shared = dict(kt, k_scale=_t(_KSR[0]), v_scale=_t(_VSR[0]))
    np.testing.assert_array_equal(
        flash_decode(_t(_Q), _t(_KQ), _t(_VQ), _t(posv), **same).numpy(),
        flash_decode(_t(_Q), _t(_KQ), _t(_VQ), _t(posv), **shared).numpy())


# ---------------------------------------------------------------------------
# Scheduler: the contiguous ContinuousEngine against the JAX one
# ---------------------------------------------------------------------------

def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    jcfg = get_config("paper_tiny")
    japi = j_build(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(0))
    jcushion = japi.extract_cushion(jparams, jnp.asarray([1, 2, 3],
                                                         jnp.int32), None, QN)
    calib = np.random.RandomState(11).randint(0, jcfg.vocab_size, (2, 24))
    jscales, _ = JCal.calibrate(japi, jparams,
                                [{"tokens": jnp.asarray(calib, jnp.int32)}],
                                QW8, cushion=jcushion)
    return dict(japi=japi, jparams=jparams, jcushion=jcushion,
                jscales=jscales,
                api=build(t_get_config("paper_tiny"), "cpu"),
                params=convert.params_from_numpy(np_tree(jparams)),
                cushion=convert.cushion_from_numpy(np_tree(jcushion)),
                scales=convert.scales_from_numpy(
                    np_tree(JCal.scales_to_plain(jscales))),
                vocab=jcfg.vocab_size)


def _trace(vocab, seed, lens, budgets):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (1, lens[i % len(lens)])).astype(np.int32)
            for i in range(len(budgets))], budgets


def _requests(tokens, budgets, eos=None):
    j = [JRequest(uid=i, batch={"tokens": jnp.asarray(t)}, max_new_tokens=n,
                  eos_id=eos)
         for i, (t, n) in enumerate(zip(tokens, budgets))]
    p = [Request(uid=i, batch={"tokens": torch.from_numpy(t)},
                 max_new_tokens=n, eos_id=eos)
         for i, (t, n) in enumerate(zip(tokens, budgets))]
    return j, p


def _same_outputs(j_outs, t_outs):
    assert [o.uid for o in t_outs] == [o.uid for o in j_outs]
    for a, b in zip(j_outs, t_outs):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.slot == a.slot


@pytest.mark.parametrize("mode", ["fp", "int8", "w8a8_int8"])
def test_continuous_engine_matches_jax(tiny, mode):
    s = tiny
    jreqs, treqs = _requests(*_trace(s["vocab"], 100, [20, 26],
                                     [5, 3, 6, 4, 5]))
    kv = None if mode == "fp" else "int8"
    qcfg, jx, tx = QN, {}, {}
    if mode == "w8a8_int8":
        qcfg = QW8
        jx = dict(scales=s["jscales"], prequant=True)
        tx = dict(scales=s["scales"], prequant=True)
    jce = JContinuous(s["japi"], s["jparams"], qcfg, n_slots=2, max_seq=128,
                      cushion=s["jcushion"], kv_dtype=kv, **jx)
    ce = ContinuousEngine(s["api"], s["params"], qcfg, n_slots=2,
                          max_seq=128, cushion=s["cushion"], kv_dtype=kv,
                          **tx)
    _same_outputs(jce.run(jreqs), ce.run(treqs))
    assert ce.stats.as_dict() == jce.stats.as_dict()
    assert ce.stats.recycles >= 1
    m = ce.prefix_len
    want = s["cushion"]["kv"]["k"]
    if kv is None:
        # the cushion is bit-identical in every recycled slot
        for slot in range(ce.n_slots):
            assert torch.equal(ce.cache["k"][:, slot, :m], want)
    else:
        assert torch.equal(ce.cache["kc"], want)
        assert ce.cache["k_scale"].shape == (4, ce.n_slots, 4)
        np.testing.assert_allclose(ce.cache["k_scale"].numpy(),
                                   np.asarray(jce.cache["k_scale"]),
                                   rtol=1e-6)


def test_eos_retirement_and_cancel(tiny):
    """A request whose eos_id shows up mid-stream retires at it (EOS
    included) as in the JAX engine; cancel frees a live slot without a
    result."""
    s = tiny
    tokens, budgets = _trace(s["vocab"], 5, [12], [8, 3])
    _, treqs = _requests(tokens[:1], budgets[:1])
    ce = ContinuousEngine(s["api"], s["params"], QN, n_slots=1, max_seq=128,
                          cushion=s["cushion"])
    free = ce.run(treqs)[0].tokens
    j = next(i for i in range(1, len(free)) if free[i] not in free[:i])
    eos = int(free[j])
    jreqs, treqs = _requests(tokens, budgets, eos=eos)
    jce = JContinuous(s["japi"], s["jparams"], QN, n_slots=1, max_seq=128,
                      cushion=s["jcushion"])
    outs = ce.run(treqs)
    _same_outputs(jce.run(jreqs), outs)
    np.testing.assert_array_equal(outs[0].tokens, free[:j + 1])
    assert ce.stats.as_dict() == jce.stats.as_dict()

    ce.start()
    assert ce.try_admit(treqs[1])
    assert ce.live_count == 1 and ce.cancel(1) and not ce.cancel(1)
    assert ce.live_count == 0 and ce.stats.canceled == 1
    assert ce.step() == [] and ce.pop_finished() == []


def test_over_capacity_rejected(tiny):
    s = tiny
    ce = ContinuousEngine(s["api"], s["params"], QN, n_slots=1, max_seq=128,
                          cushion=s["cushion"])
    big = Request(uid=0, batch={"tokens": torch.zeros((1, 100),
                                                      dtype=torch.int32)},
                  max_new_tokens=100)
    with pytest.raises(ValueError, match="max_seq"):
        ce.try_admit(big)
    assert ce.stats.positions_exhausted == 1
    assert ce.run([big]) == []
    assert ce.stats.positions_exhausted == 1 and ce.stats.finished == 0


@pytest.mark.parametrize("extra", [[], ["--paged", "--page-size", "32",
                                        "--prefix-cache",
                                        "--chunk-tokens", "16"]],
                         ids=["contiguous-int8", "paged-prefix-chunked"])
def test_serve_cli_continuous_on_cpu(tmp_path, extra):
    out = tmp_path / "bench.json"
    kv = ["--kv-dtype", "int8", "--quant", "pt_static",
          "--prequant"] if not extra else []
    outs = serve.main(["--arch", "paper_tiny", "--device", "cpu",
                       "--mode", "continuous", "--cushion-len", "3",
                       "--slots", "2", "--n-requests", "3", "--rate", "0",
                       "--prompt-len", "24", "--tokens", "4",
                       "--bench-json", str(out), *kv, *extra])
    assert [len(o.tokens) for o in outs] == [4, 2, 4]
    assert out.exists()
