"""Port parity, chunked admission prefill
(``ContinuousEngine(chunk_tokens=...)``) against the JAX package on
``paper_tiny``, on the same weights, cushion and numpy prompts.

* ``prefill(pos_offset=...)``: the chunk-resumed prefill reads the cushion
  and earlier chunks back out of the B=1 fp row as a visible prefix whose
  length is not a tile multiple; its last-token logits agree with the JAX
  chunked prefill at the same cuts within atol 1e-4 (the model tests'
  bar), and its staged KV with the JAX row within 1e-5.
* Chunked admission against blocking admission in the port and against
  the JAX chunked engine: the same tokens and slot assignments for
  contiguous and paged pools, fp and int8 (int8 pools stage fp and
  requantize the whole prompt at finalize), and a prefix-cache hit landing
  while a long stream is mid-flight.
* A stream on a recycled slot that shares a donor's stem never writes into
  the shared page (the one place the port leaves the reference, whose
  engine then leaves the static Engine's tokens).
* Bookkeeping: short prompts bypass streaming, ``cancel`` drops a stream,
  ``chunk_tokens`` is validated and bucketed, ``"auto"`` shrinks with slot
  pressure.
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
from repro.models.registry import build as j_build  # noqa: E402
from repro.serving import ContinuousEngine as JContinuous  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.serving.engine import Engine, bucket_steps  # noqa: E402
from repro_torch.serving.scheduler import (_AUTO_CHUNK_MAX,  # noqa: E402
                                           _AUTO_CHUNK_MIN, ContinuousEngine,
                                           Request)

QN = QuantConfig()


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


# ---------------------------------------------------------------------------
# Model layer: prefill(pos_offset)
# ---------------------------------------------------------------------------

_S = 40


def _split_prefill(api, params, cushion, toks, cuts, wrap, m):
    """Prefill ``toks`` in chunks [0:c1), [c1:c2), ... through pos_offset;
    returns (last-token logits, staged row) as numpy."""
    cache = api.init_cache(1, 64)
    bounds = [0] + list(cuts) + [_S]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        chunk = {"tokens": wrap(toks[:, lo:hi])}
        if lo == 0:
            logits, cache, _ = api.prefill(params, chunk, cache, QN,
                                           cushion=cushion)
        else:
            logits, cache, _ = api.prefill(params, chunk, cache, QN,
                                           pos_offset=m + lo)
    logits = logits[:, -1] if logits.ndim == 3 else logits
    return (np.asarray(logits),
            {k: np.asarray(v)[:, :, :m + _S] for k, v in cache.items()})


@pytest.mark.parametrize("cuts", [[7], [12, 30], [1, 2, 38]])
def test_pos_offset_prefill_matches_jax(tiny, cuts):
    """The resumed chunks see visible prefixes of 3 + cut positions (10;
    15, 33; 4, 5, 41): none a multiple of the attention kernel's 32-key
    tile."""
    s = tiny
    toks = np.random.RandomState(9).randint(0, s["vocab"], (1, _S)) \
        .astype(np.int32)
    jl, jrow = _split_prefill(s["japi"], s["jparams"], s["jcushion"], toks,
                              cuts, jnp.asarray, 3)
    with torch.inference_mode():
        tl, trow = _split_prefill(s["api"], s["params"], s["cushion"], toks,
                                  cuts, torch.from_numpy, 3)
        t1, _ = _split_prefill(s["api"], s["params"], s["cushion"], toks, [],
                               torch.from_numpy, 3)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(trow[key], jrow[key], atol=1e-5, rtol=0)
    # against the port's one-shot prefill: reduction order only
    np.testing.assert_allclose(tl, t1, atol=1e-4, rtol=0)
    assert int(tl.argmax()) == int(t1.argmax()) == int(jl.argmax())
    with pytest.raises(ValueError, match="chunk 0 only"):
        s["api"].prefill(s["params"], {"tokens": torch.from_numpy(toks)},
                         s["api"].init_cache(1, 64), QN,
                         cushion=s["cushion"], pos_offset=3)


# ---------------------------------------------------------------------------
# Scheduler: chunked == blocking == JAX chunked
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


@pytest.mark.parametrize("pool,kv", [
    ("dense", None), ("dense", "int8"), ("paged", None), ("paged", "int8"),
], ids=["dense-fp", "dense-int8", "paged-fp", "paged-int8"])
def test_chunked_matches_blocking_and_jax(tiny, pool, kv):
    """Mixed trace: 40-token prompts stream (budget 16: 3 chunks each),
    12-token prompts admit blocking, five requests recycle two slots."""
    s = tiny
    rs = np.random.RandomState(100)
    tokens = [rs.randint(0, s["vocab"], (1, [40, 12][i % 2]))
              .astype(np.int32) for i in range(5)]
    jreqs, treqs = _requests(tokens, [5, 3, 6, 4, 5])
    kw = dict(n_slots=2, max_seq=128, kv_dtype=kv)
    if pool == "paged":
        kw.update(paged=True, page_size=32)
    blocking = ContinuousEngine(s["api"], s["params"], QN,
                                cushion=s["cushion"], **kw)
    chunked = ContinuousEngine(s["api"], s["params"], QN,
                               cushion=s["cushion"], chunk_tokens=16, **kw)
    jce = JContinuous(s["japi"], s["jparams"], QN, cushion=s["jcushion"],
                      chunk_tokens=16, **kw)
    out_c = chunked.run(treqs)
    _same_outputs(blocking.run(treqs), out_c)
    _same_outputs(jce.run(jreqs), out_c)
    assert chunked.stats.prefill_chunks == 9
    assert chunked.stats.as_dict() == jce.stats.as_dict()


def test_prefix_cache_hit_mid_stream_matches_jax(tiny):
    """A short donor registers its stem while a long stream is mid-flight;
    a later long request sharing the stem hits the registry and streams
    only its tail."""
    s = tiny
    rs = np.random.RandomState(3)
    base = rs.randint(0, s["vocab"], (1, 32)).astype(np.int32)
    long_a = rs.randint(0, s["vocab"], (1, 80)).astype(np.int32)
    sharer = rs.randint(0, s["vocab"], (1, 80)).astype(np.int32)
    sharer[:, :30] = base[:, :30]   # page 0 = cushion (3) + 29 prompt ids
    jreqs, treqs = _requests([long_a, base, sharer], [6, 3, 4])
    kw = dict(n_slots=3, max_seq=128, paged=True, page_size=32,
              prefix_cache=True, chunk_tokens=32)
    jce = JContinuous(s["japi"], s["jparams"], QN, cushion=s["jcushion"],
                      **kw)
    ce = ContinuousEngine(s["api"], s["params"], QN, cushion=s["cushion"],
                          **kw)
    _same_outputs(jce.run(jreqs), ce.run(treqs))
    assert ce.stats.as_dict() == jce.stats.as_dict()
    assert ce.stats.prefix_hits >= 1 and ce.stats.prefill_chunks >= 3


def test_stream_on_recycled_slot_keeps_donor_pages(tiny):
    """A stream that shares a donor's stem pages on a recycled slot decodes
    as a dead row at pos -1 until it finalizes, so it never writes into the
    shared page (the reference keeps the slot's previous frozen pos, 17
    here, inside the shared page, and both the donor and the sharer then
    leave the static Engine's tokens). Every request decodes the port's
    static Engine tokens."""
    s = tiny
    rs = np.random.RandomState(0)
    short = rs.randint(0, s["vocab"], (1, 12)).astype(np.int32)
    donor = rs.randint(0, s["vocab"], (1, 32)).astype(np.int32)
    sharer = rs.randint(0, s["vocab"], (1, 80)).astype(np.int32)
    sharer[:, :30] = donor[:, :30]  # page 0 = cushion (3) + 29 prompt ids
    _, treqs = _requests([short, donor, sharer], [3, 24, 4])
    ce = ContinuousEngine(s["api"], s["params"], QN, cushion=s["cushion"],
                          n_slots=2, max_seq=128, paged=True, page_size=32,
                          prefix_cache=True, chunk_tokens=32)
    outs = ce.run(treqs)
    assert ce.stats.prefix_hits == 1 and ce.stats.recycles == 1
    assert [o.slot for o in outs] == [0, 1, 0]
    eng = Engine(s["api"], s["params"], QN, cushion=s["cushion"],
                 max_seq=128)
    for r, o in zip(treqs, outs):
        np.testing.assert_array_equal(
            o.tokens, eng.generate(r.batch, r.max_new_tokens).tokens[0])


# ---------------------------------------------------------------------------
# Bookkeeping
# ---------------------------------------------------------------------------

def _req(vocab, uid, S, n):
    ids = np.random.RandomState(uid).randint(0, vocab, (1, S))
    return Request(uid=uid, batch={"tokens": torch.from_numpy(
        ids.astype(np.int32))}, max_new_tokens=n)


def test_stream_bookkeeping(tiny):
    """Short prompts bypass streaming; cancel drops a mid-stream request
    without a result and frees its slot, and so does a blown deadline;
    chunk_tokens is validated and bucketed to a power of two."""
    s = tiny
    api, params, cu, V = s["api"], s["params"], s["cushion"], s["vocab"]
    ce = ContinuousEngine(api, params, QN, n_slots=2, max_seq=128,
                          cushion=cu, chunk_tokens=16)
    assert len(ce.run([_req(V, i, 12, 3) for i in range(3)])) == 3
    assert ce.stats.prefill_chunks == 0 and ce.stats.admitted == 3

    ce = ContinuousEngine(api, params, QN, n_slots=1, max_seq=128,
                          cushion=cu, chunk_tokens=16)
    ce.start()
    assert ce.try_admit(_req(V, 0, 48, 4))
    assert ce.prefilling == 1 and ce.is_prefilling(0)
    ce.step()                           # one chunk in
    assert ce.prefilling == 1 and ce.cancel(0)
    assert ce.prefilling == 0 and ce.stats.canceled == 1
    assert ce.try_admit(_req(V, 1, 8, 2)), "the stream's slot came back"
    while ce.live_count:
        ce.step()
    assert [o.uid for o in ce.pop_finished()] == [1]

    # a stream past its deadline is dropped before its next chunk
    late = _req(V, 2, 48, 4)
    late.deadline_s = -1.0
    assert ce.try_admit(late) and ce.prefilling == 1
    assert ce.step() == [] and ce.prefilling == 0
    assert ce.stats.deadline_prefill == 1 and ce.free_slots() == [0]

    with pytest.raises(ValueError, match="chunk_tokens"):
        ContinuousEngine(api, params, QN, n_slots=1, max_seq=128,
                         cushion=cu, chunk_tokens=0)
    ce = ContinuousEngine(api, params, QN, n_slots=1, max_seq=128,
                          cushion=cu, chunk_tokens=13)
    assert ce.chunk_tokens == bucket_steps(13) == 16


def test_auto_budget_tracks_slot_pressure(tiny):
    s = tiny
    ce = ContinuousEngine(s["api"], s["params"], QN, n_slots=4, max_seq=128,
                          cushion=s["cushion"], chunk_tokens="auto")
    ce.start()
    assert ce.chunk_auto and ce._chunk_budget() == _AUTO_CHUNK_MAX
    budgets = [ce._chunk_budget()]
    for i in range(4):
        assert ce.try_admit(_req(s["vocab"], i, 8, 30))
        budgets.append(ce._chunk_budget())
    assert budgets == sorted(budgets, reverse=True)
    assert budgets[-1] == bucket_steps(_AUTO_CHUNK_MIN)
    while ce.live_count:
        ce.step()
    assert ce._chunk_budget() == _AUTO_CHUNK_MAX
