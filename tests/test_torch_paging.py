"""Port parity, paged KV pool: ``repro_torch`` against the JAX package on
the same numpy inputs.

* ``flash_decode_paged_plain`` (what ``flash_decode_paged`` runs on a CPU
  tensor) against the JAX Pallas ``flash_decode_paged`` in interpret mode
  and ``ref.flash_decode_paged_ref`` over shuffled page tables: fp, int8
  with per-slot (B, K) scales and an fp cushion, and an fp pool with a
  cushion. Tolerance 1e-6 in f32 (the Pallas kernel folds keys page by
  page, the plain version densely).
* ``PagePool`` (the port's copy) against the reference's over one seeded
  sequence of admissions, lazy mappings, stem lookups and releases.
* The paged ``ContinuousEngine`` against the JAX one on ``paper_tiny``:
  the same tokens, slot assignments and ``ServeStats`` for fp, int8 and
  prequantized W8A8 + int8 pools, a prefix-cache hit and page
  backpressure; the cushion block is never copied after pool reset.
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
from repro.kernels.flash_decode import flash_decode_paged as j_paged  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro.serving import ContinuousEngine as JContinuous  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving.paging import PagePool as JPagePool  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels.flash_decode import (  # noqa: E402
    flash_decode_paged, flash_decode_paged_plain, flash_decode_plain,
    gather_pages)
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.serving.paging import PagePool  # noqa: E402
from repro_torch.serving.scheduler import (ContinuousEngine,  # noqa: E402
                                           Request)

QN = QuantConfig()
QW8 = QuantConfig(mode="pt_static", true_int8=True)

# ---------------------------------------------------------------------------
# Kernel: plain paged decode against the Pallas kernel
# ---------------------------------------------------------------------------

_B, _K, _G, _HD, _SMAX, _PS, _M = 4, 2, 2, 16, 64, 32, 8
_P = _SMAX // _PS
_RS = np.random.RandomState(11)
_Q = _RS.randn(_B, _K * _G, _HD).astype(np.float32)
_KF = _RS.randn(_B, _SMAX, _K, _HD).astype(np.float32)
_VF = _RS.randn(_B, _SMAX, _K, _HD).astype(np.float32)
_KQ = _RS.randint(-127, 128, (_B, _SMAX, _K, _HD)).astype(np.int8)
_VQ = _RS.randint(-127, 128, (_B, _SMAX, _K, _HD)).astype(np.int8)
_KSR = _RS.rand(_B, _K).astype(np.float32) * 0.05 + 0.01
_VSR = _RS.rand(_B, _K).astype(np.float32) * 0.05 + 0.01
_KC = _RS.randn(_M, _K, _HD).astype(np.float32)
_VC = _RS.randn(_M, _K, _HD).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _paginate(k, v, seed, n_extra=3):
    """Dense rows scattered into a shuffled page store; page 0 (scratch)
    and the spare pages hold junk."""
    rs = np.random.RandomState(seed)
    n_pages = _B * _P + 1 + n_extra
    perm = rs.permutation(np.arange(1, n_pages))[:_B * _P]
    table = perm.reshape(_B, _P).astype(np.int32)
    kp = rs.randn(n_pages, _PS, _K, _HD).astype(np.float32).astype(k.dtype)
    vp = rs.randn(n_pages, _PS, _K, _HD).astype(np.float32).astype(v.dtype)
    kp[table.reshape(-1)] = k.reshape(_B * _P, _PS, _K, _HD)
    vp[table.reshape(-1)] = v.reshape(_B * _P, _PS, _K, _HD)
    return kp, vp, table


@pytest.mark.parametrize("mode", ["fp", "int8", "fp_cushion"])
@pytest.mark.parametrize("pos", [
    [_M, -1, _SMAX - 1, _M - 1],    # cushion boundary, retired, full, m-1
    [-1, -1, -1, 5],                # mostly retired pool
    [0, 17, _PS - 1, _PS],          # page-edge straddle
    [3, 60, -1, 33],                # ragged mid-decode pool
])
def test_paged_plain_matches_pallas_and_ref(pos, mode):
    posv = np.asarray(pos, np.int32)
    kw_j, kw_t = {}, {}
    if mode == "int8":
        kp, vp, table = _paginate(_KQ, _VQ, seed=sum(pos) % 97)
        kw_j = dict(k_scale=jnp.asarray(_KSR), v_scale=jnp.asarray(_VSR),
                    kc=jnp.asarray(_KC), vc=jnp.asarray(_VC))
        kw_t = dict(k_scale=_t(_KSR), v_scale=_t(_VSR), kc=_t(_KC),
                    vc=_t(_VC))
    else:
        kp, vp, table = _paginate(_KF, _VF, seed=sum(pos) % 97)
        if mode == "fp_cushion":
            kw_j = dict(kc=jnp.asarray(_KC), vc=jnp.asarray(_VC))
            kw_t = dict(kc=_t(_KC), vc=_t(_VC))
    ours = flash_decode_paged(_t(_Q), _t(kp), _t(vp), _t(table), _t(posv),
                              **kw_t)
    np.testing.assert_array_equal(
        ours.numpy(), flash_decode_paged_plain(_t(_Q), _t(kp), _t(vp),
                                               _t(table), _t(posv),
                                               **kw_t).numpy())
    pallas = j_paged(jnp.asarray(_Q), jnp.asarray(kp), jnp.asarray(vp),
                     jnp.asarray(table), jnp.asarray(posv), interpret=True,
                     **kw_j)
    ref = R.flash_decode_paged_ref(jnp.asarray(_Q), jnp.asarray(kp),
                                   jnp.asarray(vp), jnp.asarray(table),
                                   jnp.asarray(posv), **kw_j)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    # the gather is exact and paged attention is attention on the gathered
    # cache
    np.testing.assert_array_equal(
        gather_pages(_t(kp), _t(table)).numpy(),
        np.asarray(R.gather_pages(jnp.asarray(kp), jnp.asarray(table))))
    if mode != "fp_cushion":
        dense = (_KQ, _VQ) if mode == "int8" else (_KF, _VF)
        np.testing.assert_array_equal(
            ours.numpy(), flash_decode_plain(_t(_Q), _t(dense[0]),
                                             _t(dense[1]), _t(posv),
                                             **kw_t).numpy())


# ---------------------------------------------------------------------------
# PagePool: the port's copy against the reference's
# ---------------------------------------------------------------------------

def _pool_state(p):
    return (p.table.copy(), p.refs.copy(), list(p.free), p.reserved,
            p.gauges(), p.prefix_hits, p.prefix_misses, p.dirty)


def test_page_pool_matches_reference_sequence():
    """One seeded sequence of admissions (with prefix-cache lookups and
    stem registration), lazy decode mappings and releases leaves both
    allocators in the same state after every operation."""
    kw = dict(n_slots=3, max_seq=128, page_size=16, n_pages=14,
              cushion_m=5, prefix_cache=True)
    pools = (PagePool(**kw), JPagePool(**kw))
    rs = np.random.RandomState(5)
    stem = rs.randint(0, 50, 60)
    hpos = np.zeros(3, np.int64)
    admitted = 0
    for _ in range(60):
        slot = int(rs.randint(3))
        op = rs.rand()
        if not pools[0].table[slot].any() and op < 0.6:
            S = int(rs.randint(8, 60))
            toks = stem[:S].copy()
            if rs.rand() < 0.5:
                toks[int(rs.randint(S)):] = rs.randint(50, 99)
            need = 5 + S + int(rs.randint(1, 40))
            outs = []
            for p in pools:
                shared = p.lookup_stem(toks)
                sc = p.admit(slot, 5 + S, need, shared=shared)
                if sc is not None:
                    p.register_stem(slot, toks, 5 + S)
                outs.append((shared, None if sc is None else sc.tolist()))
            assert outs[0] == outs[1]
            if outs[0][1] is not None:
                admitted += 1
                hpos[slot] = 5 + S
        elif pools[0].table[slot].any() and op < 0.8:
            lim = pools[0]._slot_limit[slot] * 16
            if hpos[slot] < lim:
                for p in pools:
                    p.ensure_mapped(slot, int(hpos[slot]))
                hpos[slot] += int(rs.randint(1, 20))
                hpos[slot] = min(hpos[slot], lim - 1)
        else:
            for p in pools:
                p.release(slot)
        a, b = (_pool_state(p) for p in pools)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2:] == b[2:]
    assert admitted >= 5 and pools[0].prefix_hits >= 1


# ---------------------------------------------------------------------------
# Scheduler: the paged ContinuousEngine against the JAX one
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
    return dict(japi=japi, jparams=jparams, jcushion=jcushion,
                api=build(t_get_config("paper_tiny"), "cpu"),
                params=convert.params_from_numpy(np_tree(jparams)),
                cushion=convert.cushion_from_numpy(np_tree(jcushion)),
                vocab=jcfg.vocab_size)


def _requests(tokens, budgets):
    """The same trace for both engines, from numpy token rows."""
    j = [JRequest(uid=i, batch={"tokens": jnp.asarray(t)}, max_new_tokens=n)
         for i, (t, n) in enumerate(zip(tokens, budgets))]
    p = [Request(uid=i, batch={"tokens": torch.from_numpy(t)},
                 max_new_tokens=n)
         for i, (t, n) in enumerate(zip(tokens, budgets))]
    return j, p


def _same_outputs(j_outs, t_outs):
    assert [o.uid for o in t_outs] == [o.uid for o in j_outs]
    for a, b in zip(j_outs, t_outs):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.slot == a.slot


def _calibrated(s):
    calib = np.random.RandomState(11).randint(0, s["vocab"], (2, 24))
    jscales, _ = JCal.calibrate(s["japi"], s["jparams"],
                                [{"tokens": jnp.asarray(calib,
                                                        jnp.int32)}],
                                QW8, cushion=s["jcushion"])
    return jscales, convert.scales_from_numpy(
        np_tree(JCal.scales_to_plain(jscales)))


@pytest.mark.parametrize("mode", ["fp", "int8", "w8a8_int8"])
def test_paged_engine_matches_jax(tiny, mode):
    """A recycling trace through the paged pool (page_size 32, two slots,
    five requests of 20 and 26 tokens) gives the JAX engine's tokens, slot
    assignments and counters — fp, int8 with per-slot scale rows, and the
    main path (pt_static, int8-resident weights, int8 KV)."""
    s = tiny
    rs = np.random.RandomState(100)
    tokens = [rs.randint(0, s["vocab"], (1, [20, 26][i % 2]))
              .astype(np.int32) for i in range(5)]
    jreqs, treqs = _requests(tokens, [5, 3, 6, 4, 5])
    kv = None if mode == "fp" else "int8"
    kw = dict(n_slots=2, max_seq=128, kv_dtype=kv, paged=True, page_size=32)
    jkw, tkw = dict(kw, cushion=s["jcushion"]), dict(kw, cushion=s["cushion"])
    qcfg = QN
    if mode == "w8a8_int8":
        qcfg = QW8
        jscales, tscales = _calibrated(s)
        jkw.update(scales=jscales, prequant=True)
        tkw.update(scales=tscales, prequant=True)
    jce = JContinuous(s["japi"], s["jparams"], qcfg, **jkw)
    ce = ContinuousEngine(s["api"], s["params"], qcfg, **tkw)
    _same_outputs(jce.run(jreqs), ce.run(treqs))
    assert ce.stats.as_dict() == jce.stats.as_dict()
    assert ce.stats.recycles >= 1
    assert ce.cache["k"].shape[1] == ce.n_pages
    if kv:
        assert ce.cache["k_scale"].shape[1] == ce.n_slots


def test_prefix_cache_hit_matches_jax(tiny):
    """Requests sharing a 62-token stem map the donor's pages read-only
    (prefix hits) and prefill only the tail: tokens, slots and counters as
    in the JAX engine."""
    s = tiny
    rs = np.random.RandomState(3)
    base = rs.randint(0, s["vocab"], 64)
    tokens = []
    for _ in range(4):
        t = rs.randint(0, s["vocab"], (1, 64)).astype(np.int32)
        t[0, :62] = base[:62]          # two full 32-pages under m=3
        tokens.append(t)
    jreqs, treqs = _requests(tokens, [4] * 4)
    kw = dict(n_slots=2, max_seq=128, paged=True, page_size=32,
              prefix_cache=True)
    jce = JContinuous(s["japi"], s["jparams"], QN, cushion=s["jcushion"],
                      **kw)
    ce = ContinuousEngine(s["api"], s["params"], QN, cushion=s["cushion"],
                          **kw)
    _same_outputs(jce.run(jreqs), ce.run(treqs))
    assert ce.stats.as_dict() == jce.stats.as_dict()
    assert ce.stats.prefix_hits >= 1 and ce.stats.prefix_misses >= 1
    with pytest.raises(ValueError, match="fp pages"):
        ContinuousEngine(s["api"], s["params"], QN, cushion=s["cushion"],
                         kv_dtype="int8", **kw)


def test_paged_backpressure_and_cushion_never_copied(tiny):
    """One content page: the second admission backpressures until the
    first retires (as in the reference). The batch-free cushion tensors
    are the same objects, with the same bytes, through admission, decode,
    retirement and re-admission; the table reaches the device only when
    it changed."""
    s = tiny
    rs = np.random.RandomState(0)
    mk = lambda uid: Request(  # noqa: E731
        uid=uid, batch={"tokens": torch.from_numpy(
            rs.randint(0, s["vocab"], (1, 12)).astype(np.int32))},
        max_new_tokens=3)
    ce = ContinuousEngine(s["api"], s["params"], QN, cushion=s["cushion"],
                          n_slots=2, max_seq=128, paged=True, page_size=32,
                          n_pages=2)
    k0, v0 = ce.cushion_block["kc"], ce.cushion_block["vc"]
    want = k0.clone()
    assert ce.try_admit(mk(0))
    assert ce.stats.cushion_page_refs == 2      # pool pin + live slot
    assert not ce.try_admit(mk(1)), "one content page: must backpressure"
    while ce.live_count:
        ce.step()
    # the admission was mirrored by the first step; the release waits for
    # the next step that runs
    assert ce.stats.page_table_syncs == 1 and ce._pool.dirty
    assert ce.stats.cushion_page_refs == 1
    assert ce.try_admit(mk(1))                  # the page came back
    ce.step()
    assert ce.stats.page_table_syncs == 2
    assert ce.cushion_block["kc"] is k0 and ce.cushion_block["vc"] is v0
    assert torch.equal(k0, want)
    assert ce.stats.recycles == 1
