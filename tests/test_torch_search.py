"""Port parity, the cushion search (paper §4.1): ``repro_torch``'s padded-
prefix forward, ``prefix_kv`` / ``prefix_qerr`` / ``score_candidates``,
``greedy_search`` and ``greedy_search_ref`` against the JAX package on
JAX's paper_tiny params (converted through numpy), the same samples, and
JAX's candidate pools injected into the port (its ``candidate_pool`` draws
from a ``torch.Generator`` and cannot give ``jax.random``'s pools).

Tolerances: logits atol 1e-4 (as ``test_torch_model.py``), except that
under ``ptoken_dynamic`` one position may sit up to 0.1 off
(``test_torch_ptoken.py`` ``PTOKEN_TIE``: a code flipped by a one-ulp
difference upstream; 0.086 measured here). A site's qerr and the L_q
scores: rtol 1e-5 under ``none``; 2e-3 under the dynamic modes, the JAX
package's own bar for ``ptoken_dynamic`` (``tests/test_search.py``): a
one-ulp difference in an activation moves a per-token code, or under
``pt_dynamic`` the per-tensor zero point, across a rounding boundary
(measured, the tests print it: 3.1e-5 on the pt_dynamic scores, 9.5e-4
on their base L_q, 6.8e-4 on the ptoken scores, 1.5e-4 on a search's
base / best L_q; a site of the ptoken forward takes 1e-2, see the test). The argmin and the searched tokens are identical in every mode. A
chunk's scores equal single-candidate forwards within rtol 1e-5 (the CPU's
matmul may block the stacked rows differently).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CushionConfig, QuantConfig, get_config  # noqa: E402
from repro.core import cushioncache as JCC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import cushioncache as TCC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402

QMODES = {"none": QuantConfig(mode="none"),
          "pt_dynamic": QuantConfig(mode="pt_dynamic"),
          "ptoken": QuantConfig(mode="ptoken_dynamic")}
RTOL = {"none": 1e-5, "pt_dynamic": 2e-3, "ptoken": 2e-3}
PTOKEN_TIE = 0.1


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def tiny():
    """paper_tiny with the planted massive-activation pathway of
    tests/test_search.py, so candidate ranking is meaningful."""
    japi = j_build(get_config("paper_tiny"))
    jparams = japi.init_params(jax.random.PRNGKey(0))
    w = jparams["layers"]["mlp"]["w_down"]
    jparams["layers"]["mlp"]["w_down"] = w.at[0, :8, 5].set(300.0)
    api = build(t_get_config("paper_tiny"), "cpu")
    params = convert.params_from_numpy(np_tree(jparams)).tree()
    return japi, jparams, api, params


def _sample(japi, i, n=32):
    return japi.make_batch(jax.random.PRNGKey(1000 + i), 1, n)


@pytest.mark.parametrize("mode", list(QMODES))
def test_padded_prefix_forward_matches_jax(tiny, mode):
    """forward with a padded cushion, its live length and the RoPE origin
    moved: logits and every site's qerr / amin / amax."""
    japi, jp, api, tp = tiny
    qcfg = QMODES[mode]
    padded = jnp.asarray([1, 7, 0, 0], jnp.int32)
    batch = _sample(japi, 3, n=16)

    @jax.jit
    def jrun(p, pad, b):
        kv = japi.prefix_kv(p, pad, qcfg)
        return (kv,) + japi.forward(
            p, b, qcfg, cushion={"kv": kv}, collect=True, remat=False,
            prefix_valid=jnp.arange(4) < 2, pos_offset=jnp.int32(2))

    jpkv, jl, jt = jrun(jp, padded, batch)
    tpkv = api.prefix_kv(tp, torch.tensor([1, 7, 0, 0]), qcfg)
    for k in ("k", "v"):
        np.testing.assert_allclose(tpkv[k].numpy(), np.asarray(jpkv[k]),
                                   atol=1e-5)
    tl, tt = api.forward(tp, to_torch(batch), qcfg, cushion={"kv": tpkv},
                         collect=True, prefix_valid=2, pos_offset=2)
    err = np.abs(tl.numpy() - np.asarray(jl))
    if mode == "ptoken":
        assert (err.max(-1) > 1e-4).sum() <= 1, err.max(-1)
        assert err.max() <= PTOKEN_TIE, err.max()
    else:
        assert err.max() <= 1e-4, err.max()
    # a site: under ptoken a position flipped upstream moves the later
    # sites' activations of that position (measured 3.7e-3 on a qerr, 6.0e-3
    # on an amax), so a site takes 1e-2 there and the total L_q the 2e-3 bar
    site_rtol = 1e-2 if mode == "ptoken" else RTOL[mode]
    for site in TT.SITES:
        for key in ("qerr", "amin", "amax"):
            np.testing.assert_allclose(
                tt["layers"][site][key].numpy(),
                np.asarray(jt["layers"][site][key]),
                rtol=site_rtol if key == "qerr" or mode == "ptoken" else 1e-5,
                atol=1e-5, err_msg=f"{site}.{key}")
    np.testing.assert_allclose(float(TT.total_qerr(tt)),
                               float(JT.total_qerr(jt)), rtol=RTOL[mode])
    # a dead row changes nothing: the live part alone gives the same logits
    # (within the logits bar: the score products run over another length)
    tl2, _ = api.forward(tp, to_torch(batch), qcfg,
                         cushion={"kv": {k: v[:, :2] for k, v in
                                         tpkv.items()}}, collect=True)
    np.testing.assert_allclose(tl.numpy(), tl2.numpy(), atol=1e-4)


@pytest.mark.parametrize("mode", list(QMODES))
def test_scoring_matches_jax(tiny, mode):
    """prefix_qerr and score_candidates against JAX's KV-reuse scorer on
    the same padded prefix, live length and candidates; the same argmin."""
    japi, jp, api, tp = tiny
    qcfg = QMODES[mode]
    batch = _sample(japi, 0)
    padded = [1, 7, 0, 0]
    cands = np.asarray([5, 9, 100, 200, 1, 33, 77, 401], np.int32)

    @jax.jit
    def jscore(p, pad, c, b):
        kv = japi.prefix_kv(p, pad, qcfg)
        return (japi.score_candidates(p, kv, jnp.int32(2), c, b, qcfg),
                japi.prefix_qerr(p, kv, jnp.int32(2), b, qcfg))

    jfast, jbase = jscore(jp, jnp.asarray(padded, jnp.int32),
                          jnp.asarray(cands), batch)
    jfast, jbase = np.asarray(jfast), float(jbase)
    with torch.no_grad():
        tpkv = api.prefix_kv(tp, torch.tensor(padded), qcfg)
        tfast = api.score_candidates(tp, tpkv, 2, torch.from_numpy(cands),
                                     to_torch(batch), qcfg).numpy()
        tbase = float(api.prefix_qerr(tp, tpkv, 2, to_torch(batch), qcfg))
    assert tfast.shape == (len(cands),)
    print(f"[{mode}] scores: max relative |port - JAX| "
          f"{np.abs(tfast / jfast - 1).max():.2e}, base "
          f"{abs(tbase / jbase - 1):.2e}")
    np.testing.assert_allclose(tfast, jfast, rtol=RTOL[mode])
    np.testing.assert_allclose(tbase, jbase, rtol=RTOL[mode])
    assert int(np.argmin(tfast)) == int(np.argmin(jfast))


@pytest.mark.parametrize("scorer", ["kv_reuse", "full_forward"])
def test_chunk_scores_equal_single_forwards_pt_dynamic(tiny, scorer):
    """Under pt_dynamic each candidate has its own per-tensor range, as
    under the reference's vmap: a chunk's scores equal N forwards of one
    candidate each (one range shared by the chunk would not)."""
    japi, _, api, tp = tiny
    qcfg = QMODES["pt_dynamic"]
    batch = to_torch(_sample(japi, 1))
    cands = [5, 9, 100, 200, 300]
    with torch.no_grad():
        if scorer == "kv_reuse":
            pkv = api.prefix_kv(tp, torch.tensor([1, 7, 0]), qcfg)
            chunk = api.score_candidates(tp, pkv, 2, torch.tensor(cands),
                                         batch, qcfg).numpy()
            single = [float(api.score_candidates(
                tp, pkv, 2, torch.tensor([c]), batch, qcfg)[0])
                for c in cands]
        else:
            fn = TCC.make_batched_qerr_fn(api, qcfg)
            chunk = fn(tp, torch.tensor([[1, 7, c] for c in cands]),
                       batch).numpy()
            one = TCC.make_qerr_fn(api, qcfg)
            single = [float(one(tp, torch.tensor([1, 7, c]), batch))
                      for c in cands]
        # one range over the whole chunk: a different function
        rows = torch.cat([torch.tensor(cands)[:, None],
                          batch["tokens"].expand(len(cands), -1)], 1)
        pkv = api.prefix_kv(tp, torch.tensor([1, 7, 0]), qcfg)
        _, taps = api.forward(tp, {"tokens": rows}, qcfg,
                              cushion={"kv": pkv}, collect=True, n_skip=1,
                              prefix_valid=2, pos_offset=2)
    np.testing.assert_allclose(chunk, single, rtol=1e-5)
    shared = float(TT.total_qerr(taps))
    assert abs(shared - sum(single)) > 1e-3 * sum(single)


def _jax_pools(vocab, ccfg, seed, n_iter):
    """JAX's candidate pools, iteration by iteration (its rng schedule)."""
    rng = jax.random.PRNGKey(seed)
    pools = []
    for _ in range(n_iter):
        rng, k1, _ = jax.random.split(rng, 3)
        pools.append(JCC.candidate_pool(k1, vocab, ccfg.n_candidates,
                                        ccfg.seed_tokens))
    return pools


@pytest.mark.parametrize("mode", ["ptoken", "pt_dynamic"])
@pytest.mark.parametrize("search", ["greedy_search", "greedy_search_ref"])
def test_greedy_search_matches_jax_tokens(tiny, mode, search, monkeypatch):
    """With JAX's pools injected, the port's fast search and its reference
    search each find the prefix tokens and per-iteration best_tok of their
    JAX counterpart, and its base / best L_q (the two scorers differ under
    pt_dynamic: the reference's prefix rows enter the ranges)."""
    japi, jp, api, tp = tiny
    qcfg = QMODES[mode]
    ccfg = CushionConfig(max_prefix_len=3, tau=1.5, n_candidates=16,
                         seed_tokens=(1,))
    jsample = {i: _sample(japi, i) for i in range(3)}
    jres = getattr(JCC, search)(japi, jp, lambda i: jsample[i], qcfg, ccfg,
                                jax.random.PRNGKey(0), chunk=8,
                                verbose=False)
    it = iter(_jax_pools(japi.cfg.vocab_size, ccfg, 0, 3))
    monkeypatch.setattr(TCC, "candidate_pool", lambda *a, **k: next(it))
    res = getattr(TCC, search)(api, tp, lambda i: to_torch(jsample[i]),
                               qcfg, ccfg, torch.Generator(), chunk=8,
                               verbose=False)
    np.testing.assert_array_equal(res.prefix_ids, jres.prefix_ids)
    assert [h["best_tok"] for h in res.history] == \
        [h["best_tok"] for h in jres.history]
    print(f"[{search} {mode}] base / best L_q: max relative |port - JAX| "
          + str(max(abs(h[k] / jh[k] - 1) for h, jh in
                    zip(res.history, jres.history)
                    for k in ("base_err", "best_err"))))
    for h, jh in zip(res.history, jres.history):
        np.testing.assert_allclose(
            [h["base_err"], h["best_err"]],
            [jh["base_err"], jh["best_err"]], rtol=RTOL[mode])


def test_candidate_pool_properties():
    vocab, ccfg = 512, CushionConfig(n_candidates=24, seed_tokens=(1, 700))
    p1 = TCC.candidate_pool(torch.Generator().manual_seed(3), vocab,
                            ccfg.n_candidates, ccfg.seed_tokens)
    p2 = TCC.candidate_pool(torch.Generator().manual_seed(3), vocab,
                            ccfg.n_candidates, ccfg.seed_tokens)
    p3 = TCC.candidate_pool(torch.Generator().manual_seed(4), vocab,
                            ccfg.n_candidates, ccfg.seed_tokens)
    np.testing.assert_array_equal(p1, p2)          # a seed gives one pool
    assert not np.array_equal(p1, p3)
    assert np.all(np.diff(p1) > 0)                 # sorted, unique
    assert p1.min() >= 0 and p1.max() < vocab
    specials = [t for t in TCC.SPECIAL_TOKENS + (1, 700) if t < vocab]
    assert set(specials) <= set(p1.tolist())       # 700 >= vocab: dropped
    assert len(p1) >= ccfg.n_candidates - len(TCC.SPECIAL_TOKENS)
    assert len(p1) <= TCC._pool_pad_len(vocab, ccfg, 8)
    assert TCC._pool_pad_len(vocab, ccfg, 8) % 8 == 0
    # the same cap as the reference
    assert TCC._pool_pad_len(vocab, ccfg, 8) == \
        JCC._pool_pad_len(vocab, ccfg, 8)


def test_discover_extracts_the_searched_prefix(tiny):
    """discover(skip_tune) = greedy_search then extract_cushion of the
    prefix it found, in the model dtype."""
    japi, _, api, tp = tiny
    ccfg = CushionConfig(max_prefix_len=3, tau=1.5, n_candidates=8,
                         seed_tokens=(1,))
    sample = lambda i: to_torch(_sample(japi, i, n=16))   # noqa: E731
    cush, sr, tr = TCC.discover(api, tp, sample, iter(()),
                                QMODES["ptoken"], ccfg,
                                torch.Generator().manual_seed(0),
                                skip_tune=True, verbose=False)
    assert tr is None and 1 <= len(sr.prefix_ids) <= 3
    want = api.extract_cushion(tp, torch.as_tensor(sr.prefix_ids), None,
                               QMODES["ptoken"])
    for k in ("k", "v"):
        assert torch.equal(cush["kv"][k], want["kv"][k])
        assert cush["kv"][k].dtype == torch.float32


def test_make_batch_shapes(tiny):
    """make_batch: next-token labels, ids in the vocabulary, a seed gives
    one batch (drawn from a torch.Generator: not JAX's ids)."""
    _, _, api, _ = tiny
    b1 = api.make_batch(torch.Generator().manual_seed(4), 3, 10)
    b2 = api.make_batch(torch.Generator().manual_seed(4), 3, 10)
    assert b1["tokens"].shape == b1["labels"].shape == (3, 10)
    assert b1["tokens"].dtype == torch.int32
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert 0 <= int(b1["tokens"].min()) and int(b1["labels"].max()) < 512
    assert api.text_len(10) == 10


def test_search_without_kv_scoring_falls_back_to_the_reference(tiny):
    """A family without an attention-KV-only prefix artifact (none is
    ported yet) searches with greedy_search_ref: the same result."""
    from repro_torch.models.registry import ModelAPI

    class NoKV(ModelAPI):
        supports_kv_scoring = False

    japi, _, api, tp = tiny
    nokv = NoKV(api.cfg, api.device)
    ccfg = CushionConfig(max_prefix_len=3, tau=1.5, n_candidates=8,
                         seed_tokens=(1,))
    sample = lambda i: to_torch(_sample(japi, i, n=16))   # noqa: E731
    got = TCC.greedy_search(nokv, tp, sample, QMODES["none"], ccfg,
                            torch.Generator().manual_seed(1), chunk=8,
                            verbose=False)
    want = TCC.greedy_search_ref(api, tp, sample, QMODES["none"], ccfg,
                                 torch.Generator().manual_seed(1), chunk=8,
                                 verbose=False)
    np.testing.assert_array_equal(got.prefix_ids, want.prefix_ids)
    assert [h["best_tok"] for h in got.history] == \
        [h["best_tok"] for h in want.history]
