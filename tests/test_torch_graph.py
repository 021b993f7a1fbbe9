"""The port's decode step over fixed buffers, the state a CUDA graph of it
reads (``repro_torch/serving/graphs.py``), checked on the CPU, where the
same step runs eagerly.

* RoPE: the inverse frequencies, formed once per (d_head, theta, device),
  and the angles are bit-identical to the numpy formula and to JAX's; cos
  and sin are bit-identical to the per-call formula the port used before
  and within one f32 ulp of JAX's (XLA's and PyTorch's cos and sin differ
  by up to an ulp: ROADMAP queue 3).
* The static ``Engine`` keeps one cache and one ``tok`` / ``pos`` pair
  per batch size: two successive requests of one B (other prompt length,
  other budget) give the tokens of two fresh engines, in fp and int8 KV,
  W8A8, W4A8 and ptoken_dynamic; no step and no request moves a buffer.
* The ``ContinuousEngine`` refills its pool in place at every ``start()``:
  a second run over the same trace gives a fresh engine's tokens, slots
  and ``ServeStats``, contiguous and paged, int8 and fp with the prefix
  cache and chunked prefill; no step and no run moves a buffer.
* The launch bookkeeping of a captured step: the counts a capture records
  are taken back out of ``LAUNCHES`` and added once per replay.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.models import common as JC  # noqa: E402
from repro_torch.configs import QuantConfig, get_config  # noqa: E402
from repro_torch.core.calibration import calibrate  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.launch.serve import seeded_cushion  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.graphs import CapturedStep  # noqa: E402
from repro_torch.serving.scheduler import (ContinuousEngine,  # noqa: E402
                                           Request)

QN = QuantConfig()
QW8 = QuantConfig(mode="pt_static", true_int8=True)
QPT = QuantConfig(mode="ptoken_dynamic")

# ---------------------------------------------------------------------------
# RoPE frequencies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d_head,theta", [(16, 10000.0), (32, 10000.0),
                                          (64, 10000.0), (64, 1e6),
                                          (128, 500000.0)])
def test_rope_table_matches_numpy_and_jax(d_head, theta):
    pos = np.arange(0, 8192, 7, dtype=np.int32)
    inv64 = 1.0 / (theta ** (np.arange(0, d_head, 2) / d_head))
    cpu = torch.device("cpu")
    inv = TC.rope_inv_freq(d_head, theta, cpu)
    assert inv is TC.rope_inv_freq(d_head, theta, cpu)      # formed once
    np.testing.assert_array_equal(inv.numpy(), inv64.astype(np.float32))
    tpos = torch.from_numpy(pos)
    ang = tpos.float()[..., None] * inv
    j_ang = jnp.asarray(pos).astype(jnp.float32)[..., None] * inv64[None, :]
    np.testing.assert_array_equal(ang.numpy(), np.asarray(j_ang))
    cos, sin = TC.rope_cos_sin(tpos, d_head, theta)
    # the per-call formula: the f64 numpy frequencies copied in every call
    old = tpos.float()[..., None] * torch.from_numpy(inv64).to(torch.float32)
    assert torch.equal(cos, torch.cos(old)) and torch.equal(sin,
                                                            torch.sin(old))
    j_cos, j_sin = JC.rope_cos_sin(jnp.asarray(pos), d_head, theta)
    np.testing.assert_array_max_ulp(cos.numpy(), np.asarray(j_cos), 1)
    np.testing.assert_array_max_ulp(sin.numpy(), np.asarray(j_sin), 1)


# ---------------------------------------------------------------------------
# Launch bookkeeping of a captured step
# ---------------------------------------------------------------------------


def test_replays_add_the_recorded_launches():
    _lib.reset_launches()
    _lib.count("flash_decode")              # an eager launch before

    def capture():
        for _ in range(3):
            _lib.count("w8a8_matmul")
            _lib.count("act_quant_static_fused")
        _lib.count("flash_decode")

    rec = _lib.record_launches(capture)
    assert rec == {"w8a8_matmul": 3, "act_quant_static_fused": 3,
                   "flash_decode": 1}
    # the capture launched nothing
    assert _lib.LAUNCHES["w8a8_matmul"] == 0
    assert _lib.LAUNCHES["flash_decode"] == 1
    for _ in range(5):
        _lib.replayed(rec)
    assert _lib.LAUNCHES["w8a8_matmul"] == 15
    assert _lib.LAUNCHES["act_quant_static_fused"] == 15
    assert _lib.LAUNCHES["flash_decode"] == 6
    assert _lib.COUNTERS["graph_replays"] == 5

    def broken():
        _lib.count("w4a8_matmul")
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        _lib.record_launches(broken)
    assert _lib.LAUNCHES["w4a8_matmul"] == 0
    _lib.reset_launches()
    assert not any(_lib.LAUNCHES.values())
    assert _lib.COUNTERS["graph_replays"] == 0


def test_captured_step_is_for_the_card_only():
    with pytest.raises(ValueError, match="on the card"):
        CapturedStep(lambda: None, torch.device("cpu"))


# ---------------------------------------------------------------------------
# Engines on paper_tiny
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    api = build(get_config("paper_tiny"), "cpu")
    params = api.init_params(torch.Generator().manual_seed(0))
    cushion = seeded_cushion(api, params, 3, seed=0)
    rs = np.random.RandomState(5)
    calib = [{"tokens": torch.from_numpy(
        rs.randint(0, 512, (2, 24)).astype(np.int32))}]
    scales, _ = calibrate(api, params, calib, QW8, cushion=cushion)
    return dict(api=api, params=params, cushion=cushion, scales=scales,
                rs=rs)


# mode -> (qcfg, kv_dtype, prequant, weight_bits)
MODES = {"fp": (QN, None, False, 8), "w8a8_int8kv": (QW8, "int8", True, 8),
         "w4a8_int8kv": (QW8, "int8", True, 4),
         "ptoken_fp": (QPT, None, False, 8)}


def _engine(s, mode):
    qcfg, kv, pre, wb = MODES[mode]
    return Engine(s["api"], s["params"], qcfg, cushion=s["cushion"],
                  scales=s["scales"] if qcfg.mode == "pt_static" else None,
                  max_seq=64, kv_dtype=kv, prequant=pre, weight_bits=wb)


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


def _state_ptrs(st):
    return _ptrs([st.tok, st.pos, *st.cache.values()])


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_reuses_its_state_across_requests(tiny, mode):
    """Request 1 (prompt 20, 6 tokens) then request 2 (prompt 11, 9
    tokens) of B = 2 on one engine: each gives the tokens a fresh engine
    gives it, and the cache, tok and pos stay where they were made."""
    s = tiny
    rs = np.random.RandomState(17)
    b1 = {"tokens": torch.from_numpy(rs.randint(0, 512, (2, 20))
                                     .astype(np.int32))}
    b2 = {"tokens": torch.from_numpy(rs.randint(0, 512, (2, 11))
                                     .astype(np.int32))}
    eng = _engine(s, mode)
    r1 = eng.generate(b1, 6).tokens
    st = eng.states[2]
    ptrs = _state_ptrs(st)
    step = st.step
    seen = []

    def watched():
        step()
        seen.append(_state_ptrs(st))

    st.step = watched
    r2 = eng.generate(b2, 9).tokens
    assert eng.states == {2: st} and len(seen) == 8
    assert all(p == ptrs for p in seen)
    np.testing.assert_array_equal(r1, _engine(s, mode).generate(b1, 6).tokens)
    np.testing.assert_array_equal(r2, _engine(s, mode).generate(b2, 9).tokens)
    # the eager per-token loop runs on the same state
    np.testing.assert_array_equal(eng.generate_py(b1, 6).tokens, r1)


# pool -> ContinuousEngine keywords
POOLS = {
    "contiguous_int8": dict(qcfg=QW8, kv_dtype="int8", prequant=True),
    "paged_int8": dict(qcfg=QW8, kv_dtype="int8", prequant=True,
                       paged=True, page_size=16),
    "paged_fp_prefix_chunked": dict(qcfg=QN, paged=True, page_size=16,
                                    prefix_cache=True, chunk_tokens=8),
    "contiguous_fp_ptoken": dict(qcfg=QPT),
}


def _continuous(s, pool):
    kw = dict(POOLS[pool])
    qcfg = kw.pop("qcfg")
    return ContinuousEngine(
        s["api"], s["params"], qcfg, n_slots=2, max_seq=64,
        cushion=s["cushion"],
        scales=s["scales"] if qcfg.mode == "pt_static" else None, **kw)


def _trace():
    """Five requests at once on two slots (every slot recycled), prompts
    sharing a 16-token stem, so the prefix cache hits."""
    rs = np.random.RandomState(23)
    stem = rs.randint(0, 512, 16)
    reqs = []
    for i, (n, budget) in enumerate([(20, 5), (18, 3), (21, 6), (17, 4),
                                     (19, 2)]):
        toks = np.concatenate([stem, rs.randint(0, 512, n - 16)])
        reqs.append(Request(uid=i, batch={"tokens": torch.from_numpy(
            toks[None].astype(np.int32))}, max_new_tokens=budget))
    return reqs


def _pool_ptrs(ce):
    return _ptrs([ce.tok, ce.pos, ce._live_dev, *ce.cache.values(),
                  *ce.cushion_block.values()])


@pytest.mark.parametrize("pool", list(POOLS))
def test_continuous_pool_refilled_in_place(tiny, pool):
    s = tiny
    ce = _continuous(s, pool)
    ptrs = _pool_ptrs(ce)
    decode = ce._decode_pool
    seen = []

    def watched():
        decode()
        seen.append(_pool_ptrs(ce))

    ce._decode_pool = watched
    first = ce.run(_trace())
    stats = ce.stats.as_dict()
    second = ce.run(_trace())
    assert seen and all(p == ptrs for p in seen)
    fresh = _continuous(s, pool)
    want = fresh.run(_trace())
    for outs in (first, second):
        assert [o.uid for o in outs] == [o.uid for o in want]
        for a, b in zip(outs, want):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            assert a.slot == b.slot
    assert stats == ce.stats.as_dict() == fresh.stats.as_dict()
    if "prefix" in pool:
        assert stats["prefix_hits"] > 0 and stats["prefill_chunks"] > 0
