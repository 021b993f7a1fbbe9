"""Port parity, the VLM (``repro_torch.models.vlm``: the dense stack with
the stub frontend's patches before the tokens) against the JAX package on
the same weights (JAX's, carried across through ``models/convert.py``),
cushion, scales, patches and numpy inputs, in f32, on
``reduced(internvl2-26b)``: 4 layers, d_model 64, 16 patches.

Tolerances, measured on the CPU with JAX's functions jitted (the tests
print what they measure: ``pytest -s``). The VLM is the dense family with
an input in front, so the dense bars hold:

* ``forward``: logits within 1e-4 (measured up to 4.7e-6); under a
  quantized mode one position may sit up to 0.1 off (a code flipped
  upstream, the MoE bar of ROADMAP queue 3; measured one position 9.8e-3
  off under pt_dynamic with the cushion). A site's L_q within 1e-4
  relative under ``none`` and 2e-3 under the quantized modes; amin / amax
  / absmax_ch within 1e-5, or within 1e-2 relative where a position is
  off (the flipped code moves the statistics downstream of it: measured
  3.4e-3 at the ``down`` site's absmax_ch).
* Caches: fp within 1e-5; int8 codes off by at most one at under 0.1% of
  entries, the cushion block bit-exact.
* Greedy tokens of every engine and of the search: identical.
* Search scores within 1e-4 relative under ``none`` and 2e-3 under the
  dynamic modes, the same argmin; calibration scales within 1e-5
  relative; SmoothQuant's folded leaves within 8 f32 ulp of JAX's
  (``test_torch_smoothquant.py``'s bar).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import (CushionConfig, QuantConfig, get_config,  # noqa: E402
                           reduced)
from repro.core import calibration as JCal  # noqa: E402
from repro.core import cushioncache as JCC  # noqa: E402
from repro.core import smoothquant as JSQ  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro.serving import ContinuousEngine as JContinuous  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import calibration as TCal  # noqa: E402
from repro_torch.core import cushioncache as TCC  # noqa: E402
from repro_torch.core import smoothquant as TSQ  # noqa: E402
from repro_torch.launch import serve, tune  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import vlm as TV  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.scheduler import ContinuousEngine, Request  # noqa: E402

QN = QuantConfig()
QD = QuantConfig(mode="pt_dynamic")
QW8 = QuantConfig(mode="pt_static", true_int8=True)
QPT = QuantConfig(mode="ptoken_dynamic")
QMODES = {"none": QN, "pt_dynamic": QD, "pt_static": QW8,
          "ptoken_dynamic": QPT}
TIE = 0.1
ARCH = "internvl2-26b"
P = 16


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def configs():
    return (reduced(get_config(ARCH), dtype="float32"),
            t_reduced(t_get_config(ARCH), dtype="float32"))


def _batch(japi, seed, B, n):
    """A JAX batch of n positions in all (16 of them patches)."""
    return japi.make_batch(jax.random.PRNGKey(seed), B, n)


@pytest.fixture(scope="module")
def vlm():
    jcfg, tcfg = configs()
    japi = j_build(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(1))
    jcushion = japi.extract_cushion(
        jparams, jnp.asarray([7, 2, 11, 5], jnp.int32), None, QN)
    calib = _batch(japi, 5, 2, P + 24)
    jscales, _ = JCal.calibrate(japi, jparams, [calib], QW8,
                                cushion=jcushion)
    params = convert.params_from_numpy(np_tree(jparams))
    return dict(
        jcfg=jcfg, tcfg=tcfg, japi=japi, api=build(tcfg, "cpu"),
        jparams=jparams, params=params.tree(),
        jcushion=jcushion,
        cushion=convert.cushion_from_numpy(np_tree(jcushion)),
        jscales=jscales, scales=convert.scales_from_numpy(
            np_tree(JCal.scales_to_plain(jscales))),
        calib=calib, batch=_batch(japi, 6, 2, P + 12),
        vocab=jcfg.vocab_size)


def _pick(s, mode):
    qcfg = QMODES[mode]
    static = qcfg.mode == "pt_static"
    return (qcfg, s["jscales"] if static else None,
            s["scales"] if static else None)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_build_aliases_and_batch():
    _, tcfg = configs()
    api = build(tcfg, "cpu")
    assert api.mod is TV and api.sites == TT.SITES
    assert api.supports_kv_scoring and not api.supports_chunked_prefill
    assert api.cache_batch_axes == {"k": 1, "v": 1}
    assert api.paged_kv_leaves == ("k", "v")
    assert api.text_len(40) == 24 and api.text_len(10) == 1
    b = api.make_batch(torch.Generator().manual_seed(0), 3, 40)
    assert b["tokens"].shape == b["labels"].shape == (3, 24)
    assert b["patches"].shape == (3, P, 64)
    assert b["patches"].dtype == torch.float32
    assert 0.01 < float(b["patches"].std()) < 0.03
    again = api.make_batch(torch.Generator().manual_seed(0), 3, 40)
    assert torch.equal(again["patches"], b["patches"])
    assert set(build(t_reduced(t_get_config("smollm-360m")), "cpu")
               .make_batch(torch.Generator(), 1, 8)) == {"tokens", "labels"}


@pytest.mark.parametrize("mode,cushion", [(m, True) for m in QMODES]
                         + [("none", False), ("pt_dynamic", False)])
def test_forward_logits_and_taps_match_jax(vlm, mode, cushion):
    s = vlm
    qcfg, js, ts = _pick(s, mode)
    jcu = s["jcushion"] if cushion else None
    tcu = s["cushion"] if cushion else None
    jl, jt = jax.jit(lambda p, b: s["japi"].forward(
        p, b, qcfg, scales=js, cushion=jcu, collect=True, remat=False))(
            s["jparams"], s["batch"])
    tl, tt = s["api"].forward(s["params"], to_torch(s["batch"]), qcfg,
                              scales=ts, cushion=tcu, collect=True)
    assert tl.shape == (2, P + 12, s["vocab"])
    err = np.abs(tl.numpy() - np.asarray(jl)).max(-1)
    print(f"[{mode}, cushion {cushion}] logits max |port - JAX| "
          f"{err.max():.2e}")
    if mode != "none":
        assert (err > 1e-4).sum() <= 1 and err.max() <= TIE, err
    else:
        assert err.max() <= 1e-4, err.max()
    q_tol = 1e-4 if mode == "none" else 2e-3
    # a flipped code moves the statistics downstream of it at its position
    s_tol = 1e-2 if (err > 1e-4).any() else 0
    for site in TV.SITES:
        for key in ("qerr", "amin", "amax", "absmax_ch"):
            np.testing.assert_allclose(
                tt["layers"][site][key].numpy(),
                np.asarray(jt["layers"][site][key]),
                rtol=q_tol if key == "qerr" else s_tol,
                atol=0 if key == "qerr" else 1e-5, err_msg=f"{site}.{key}")
    np.testing.assert_allclose(tt["head"]["qerr"].numpy(),
                               np.asarray(jt["head"]["qerr"]), rtol=q_tol)
    # the patches are positions: the forward sees [patches; text]
    full, _ = TT.forward(s["params"], to_torch(s["batch"])["tokens"],
                         s["tcfg"], qcfg, scales=ts, cushion=tcu,
                         prepend_embeds=to_torch(s["batch"])["patches"])
    np.testing.assert_array_equal(full.numpy(), tl.numpy())


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_loss_fn_is_ce_over_the_text_only(vlm, lam):
    s = vlm
    b = s["batch"]
    jl, jaux = jax.jit(lambda p, b: s["japi"].loss_fn(
        p, b, QD, cushion=s["jcushion"], collect=True, remat=False,
        lam=lam))(s["jparams"], b)
    tl, taux = s["api"].loss_fn(s["params"], to_torch(b), QD,
                                cushion=s["cushion"], collect=True, lam=lam)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(taux["qerr"]), float(jaux["qerr"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-3)
    # CE over the text positions: the logits from position P on
    logits, _ = s["api"].forward(s["params"], to_torch(b), QD,
                                 cushion=s["cushion"])
    from repro_torch.models.common import cross_entropy
    ce = cross_entropy(logits[:, P:], to_torch(b)["labels"])
    np.testing.assert_allclose(float(taux["ce"]), float(ce), rtol=1e-6)


def test_prefill_decode_match_forward_offset_by_the_patches(vlm):
    """Prefill [patches; the first text tokens], decode the rest: the
    teacher-forced forward logits at the same positions (P further on)."""
    s = vlm
    api, params = s["api"], s["params"]
    b = to_torch(s["batch"])
    full, _ = api.forward(params, b, QN, cushion=s["cushion"])
    split = 6
    cache = api.init_cache(2, 64)
    lg, cache, pos = api.prefill(params, {"tokens": b["tokens"][:, :split],
                                          "patches": b["patches"]},
                                 cache, QN, cushion=s["cushion"])
    assert int(pos) == 4 + P + split
    np.testing.assert_allclose(lg[:, 0].numpy(),
                               full[:, P + split - 1].numpy(), rtol=1e-4,
                               atol=1e-4)
    for i in range(split, 12):
        lg, cache = api.decode_step(params, b["tokens"][:, i], pos, cache,
                                    QN)
        pos = pos + 1
        np.testing.assert_allclose(lg.numpy(), full[:, P + i].numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_prefill_decode_match_jax(vlm, kv):
    """W8A8 under the cushion: the prefill's logits and cache, then three
    decode steps, against JAX."""
    s = vlm
    kv_dtype = None if kv == "fp" else "int8"
    japi, api = s["japi"], s["api"]
    jcache = japi.init_cache(2, 64, kv_dtype=kv_dtype, prefix_len=4)
    tcache = api.init_cache(2, 64, kv_dtype=kv_dtype, prefix_len=4)
    jl, jcache, jpos = jax.jit(lambda p, b, c: japi.prefill(
        p, b, c, QW8, cushion=s["jcushion"], scales=s["jscales"]))(
            s["jparams"], s["batch"], jcache)
    tl, tcache, tpos = api.prefill(s["params"], to_torch(s["batch"]),
                                   tcache, QW8, cushion=s["cushion"],
                                   scales=s["scales"])
    assert int(tpos) == int(jpos) == 4 + P + 12
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    jc = np_tree(jcache)
    if kv_dtype is None:
        for k in ("k", "v"):
            np.testing.assert_allclose(tcache[k].numpy(), jc[k], atol=1e-5)
    else:
        for k in ("kc", "vc"):
            np.testing.assert_array_equal(tcache[k].numpy(), jc[k])
        for k in ("k", "v"):
            d = np.abs(tcache[k].numpy().astype(np.int32)
                       - jc[k].astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, k
    jdec = jax.jit(lambda p, t, pos, c: japi.decode_step(
        p, t, pos, c, QW8, scales=s["jscales"]))
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for step in range(3):
        jl, jcache = jdec(s["jparams"], jnp.asarray(tok), jpos + step,
                          jcache)
        tl, tcache = api.decode_step(s["params"], torch.from_numpy(tok),
                                     tpos + step, tcache, QW8,
                                     scales=s["scales"])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_decode_per_row_pos_matches_single_slot(vlm):
    """Two slots prefilled with their patches to different depths decode
    as one batch with a (B,) pos (``tests/test_serving.py``'s check)."""
    s = vlm
    api, params = s["api"], s["params"]
    rows, poss, toks, ref = [], [], [], []
    for i, n in enumerate((P + 20, P + 26)):
        b = api.make_batch(torch.Generator().manual_seed(10 + i), 1, n)
        c = api.init_cache(1, 96)
        lg, c, p = api.prefill(params, b, c, QN, cushion=s["cushion"])
        tok = lg[:, -1].argmax(-1).to(torch.int32)
        c1 = {k: v.clone() for k, v in c.items()}
        lr, _ = api.decode_step(params, tok, p, c1, QN)
        rows.append(c)
        poss.append(p)
        toks.append(tok[0])
        ref.append(lr[0])
    pool = {k: torch.cat([r[k] for r in rows], dim=ax)
            for k, ax in api.cache_batch_axes.items()}
    lg2, _ = api.decode_step(params, torch.stack(toks),
                             torch.stack(poss).to(torch.int32), pool, QN)
    for i in range(2):
        np.testing.assert_allclose(lg2[i].numpy(), ref[i].numpy(),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# engines and the scheduler
# ---------------------------------------------------------------------------

def _requests(japi, n, budgets):
    jb = [_batch(japi, 200 + i, 1, P + [20, 26][i % 2]) for i in range(n)]
    j = [JRequest(uid=i, batch=b, max_new_tokens=m)
         for i, (b, m) in enumerate(zip(jb, budgets))]
    t = [Request(uid=i, batch=to_torch({k: b[k] for k in
                                        ("tokens", "patches")}),
                 max_new_tokens=m)
         for i, (b, m) in enumerate(zip(jb, budgets))]
    return j, t


@pytest.mark.parametrize("pool", ["contiguous", "paged"])
def test_int8_pool_matches_engine_and_jax(vlm, pool):
    """Five requests with patches through 2 int8 slots (W8A8,
    int8-resident): JAX's tokens, slots and ServeStats, and the port's
    static B=1 Engine's tokens, which are JAX's Engine's."""
    s = vlm
    jreqs, treqs = _requests(s["japi"], 5, [5, 3, 6, 4, 5])
    kw = dict(n_slots=2, max_seq=128, kv_dtype="int8", prequant=True)
    if pool == "paged":
        kw.update(paged=True, page_size=32)
    ce = ContinuousEngine(s["api"], s["params"], QW8, cushion=s["cushion"],
                          scales=s["scales"], **kw)
    jce = JContinuous(s["japi"], s["jparams"], QW8, cushion=s["jcushion"],
                      scales=s["jscales"], **kw)
    outs = ce.run(treqs)
    jouts = jce.run(jreqs)
    assert [o.uid for o in outs] == [o.uid for o in jouts]
    for a, b in zip(jouts, outs):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.slot == a.slot
    assert ce.stats.as_dict() == jce.stats.as_dict()
    assert ce.stats.recycles >= 1
    eng = Engine(s["api"], s["params"], QW8, cushion=s["cushion"],
                 scales=s["scales"], max_seq=128, kv_dtype="int8",
                 prequant=True)
    jeng = JEngine(s["japi"], s["jparams"], QW8, cushion=s["jcushion"],
                   scales=s["jscales"], max_seq=128, kv_dtype="int8",
                   prequant=True)
    for r, jr, o in zip(treqs[:2], jreqs[:2], outs):
        got = eng.generate(r.batch, r.max_new_tokens).tokens[0]
        np.testing.assert_array_equal(got, o.tokens)
        np.testing.assert_array_equal(
            got, jeng.generate(jr.batch, jr.max_new_tokens).tokens[0])


def test_patch_requests_count_patches_and_skip_chunks_and_stems(vlm):
    """A request's positions count its patches; with chunk_tokens set it
    admits blocking, and a prefix-cache pool never looks it up or
    registers it (its positions are not its token ids): JAX's tokens and
    stats."""
    s = vlm
    jreqs, treqs = _requests(s["japi"], 4, [4, 3, 4, 3])
    # the same text twice: a token-keyed lookup would share its stem
    for reqs in (jreqs, treqs):
        reqs[2].batch["tokens"] = reqs[0].batch["tokens"]
    kw = dict(n_slots=2, max_seq=128, paged=True, page_size=16,
              prefix_cache=True, chunk_tokens=8)
    ce = ContinuousEngine(s["api"], s["params"], QN, cushion=s["cushion"],
                          **kw)
    assert ce._positions_needed(treqs[1]) == 4 + P + 26 + 3
    jce = JContinuous(s["japi"], s["jparams"], QN, cushion=s["jcushion"],
                      **kw)
    calls = []
    inner = ce._pool.lookup_stem
    ce._pool.lookup_stem = lambda t: calls.append(1) or inner(t)
    outs = ce.run(treqs)
    jouts = jce.run(jreqs)
    for a, b in zip(jouts, outs):
        np.testing.assert_array_equal(b.tokens, a.tokens)
    assert calls == []
    st = ce.stats.as_dict()
    assert st == jce.stats.as_dict()
    assert st["prefill_chunks"] == 0 and st["prefix_hits"] == 0
    # 4 + 16 + 20 + 89 = 129 positions: over the pool's 128 with the
    # patches counted, 113 without them
    big = Request(uid=9, batch=treqs[0].batch, max_new_tokens=89)
    ce.start()
    with pytest.raises(ValueError, match="positions"):
        ce.try_admit(big)


# ---------------------------------------------------------------------------
# the method
# ---------------------------------------------------------------------------

def test_forward_with_token_prefix_both_forms(vlm):
    """The prefix sits before the patches: the (m,) form equals a forward
    with [embed(prefix); patches] prepended, and the stacked (N, m) form's
    rows equal the single forwards (groups=N)."""
    s = vlm
    api, params = s["api"], s["params"]
    b = to_torch(_batch(s["japi"], 7, 1, P + 10))
    ids = torch.tensor([5, 9, 1], dtype=torch.int32)
    lg, taps = api.forward_with_token_prefix(params, ids, b, QD,
                                             collect=True, n_skip=3)
    jl, jtaps = s["japi"].forward_with_token_prefix(
        s["jparams"], jnp.asarray([5, 9, 1], jnp.int32),
        _batch(s["japi"], 7, 1, P + 10), QD, collect=True, n_skip=3,
        remat=False)
    assert lg.shape == (1, 3 + P + 10, s["vocab"])
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(TT.total_qerr(taps)),
                               float(JT.total_qerr(jtaps)), rtol=2e-3)
    stack = torch.tensor([[5, 9, 1], [2, 2, 7]], dtype=torch.int32)
    sl, st = api.forward_with_token_prefix(params, stack, b, QD,
                                           collect=True, n_skip=3)
    per = TT.total_qerr(st, groups=2)
    for i in range(2):
        li, ti = api.forward_with_token_prefix(params, stack[i], b, QD,
                                               collect=True, n_skip=3)
        np.testing.assert_allclose(sl[i:i + 1].numpy(), li.numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(per[i]), float(TT.total_qerr(ti)),
                                   rtol=1e-5)


SCORE_MODES = {"none": (QN, 1e-4), "pt_dynamic": (QD, 2e-3)}


@pytest.mark.parametrize("mode", list(SCORE_MODES))
def test_score_candidates_match_jax(vlm, mode):
    """prefix_kv (the prefix's KV without patches), prefix_qerr and
    score_candidates (each candidate between the cushion and the patches,
    stacked with groups=N) against JAX's vmapped scorer."""
    s = vlm
    qcfg, rtol = SCORE_MODES[mode]
    japi, api = s["japi"], s["api"]
    batch = _batch(japi, 8, 1, P + 12)
    padded = [1, 4, 0]
    cands = np.asarray([2, 30, 99, 7, 1, 200], np.int32)

    @jax.jit
    def jscore(p, pad, c, b):
        kv = japi.prefix_kv(p, pad, qcfg)
        return (kv, japi.score_candidates(p, kv, jnp.int32(2), c, b, qcfg),
                japi.prefix_qerr(p, kv, jnp.int32(2), b, qcfg))

    jkv, jfast, jbase = jscore(s["jparams"], jnp.asarray(padded, jnp.int32),
                               jnp.asarray(cands), batch)
    with torch.no_grad():
        pkv = api.prefix_kv(s["params"], torch.tensor(padded), qcfg)
        tfast = api.score_candidates(s["params"], pkv, 2,
                                     torch.from_numpy(cands),
                                     to_torch(batch), qcfg).numpy()
        tbase = float(api.prefix_qerr(s["params"], pkv, 2, to_torch(batch),
                                      qcfg))
    np.testing.assert_allclose(pkv["k"].numpy(), np.asarray(jkv["k"]),
                               atol=1e-5)
    jfast = np.asarray(jfast)
    print(f"[{mode}] scores: max relative |port - JAX| "
          f"{np.abs(tfast / jfast - 1).max():.2e}")
    np.testing.assert_allclose(tfast, jfast, rtol=rtol)
    np.testing.assert_allclose(tbase, float(jbase), rtol=rtol)
    assert int(np.argmin(tfast)) == int(np.argmin(jfast))


def _jax_pools(vocab, ccfg, seed, n_iter):
    rng = jax.random.PRNGKey(seed)
    pools = []
    for _ in range(n_iter):
        rng, k1, _ = jax.random.split(rng, 3)
        pools.append(JCC.candidate_pool(k1, vocab, ccfg.n_candidates,
                                        ccfg.seed_tokens))
    return pools


@pytest.mark.parametrize("search", ["greedy_search", "greedy_search_ref"])
def test_greedy_search_matches_jax_tokens(vlm, search, monkeypatch):
    s = vlm
    ccfg = CushionConfig(max_prefix_len=3, tau=1.5, n_candidates=16,
                         seed_tokens=(1,))
    jsample = {i: _batch(s["japi"], 1000 + i, 1, P + 12) for i in range(3)}
    jres = getattr(JCC, search)(s["japi"], s["jparams"],
                                lambda i: jsample[i], QD, ccfg,
                                jax.random.PRNGKey(0), chunk=8,
                                verbose=False)
    it = iter(_jax_pools(s["vocab"], ccfg, 0, 3))
    monkeypatch.setattr(TCC, "candidate_pool", lambda *a, **k: next(it))
    res = getattr(TCC, search)(s["api"], s["params"],
                               lambda i: to_torch(jsample[i]), QD, ccfg,
                               torch.Generator(), chunk=8, verbose=False)
    np.testing.assert_array_equal(res.prefix_ids, jres.prefix_ids)
    assert [h["best_tok"] for h in res.history] == \
        [h["best_tok"] for h in jres.history]


def test_extract_cushion_and_calibration_match_jax(vlm):
    """The cushion is the prefix tokens' KV alone (no patches); the scales
    take the dense layout, calibrated with patches under the cushion."""
    s = vlm
    got = s["api"].extract_cushion(s["params"], torch.tensor([7, 2, 11, 5]),
                                   None, QN)
    assert set(got) == {"kv"}
    for k in ("k", "v"):
        assert got["kv"][k].shape == (4, 4, 2, 16)
        np.testing.assert_allclose(got["kv"][k].numpy(),
                                   s["cushion"]["kv"][k].numpy(), rtol=0,
                                   atol=1e-5)
    tsc, _ = TCal.calibrate(s["api"], s["params"], [to_torch(s["calib"])],
                            QW8, cushion=s["cushion"])
    assert set(tsc) == set(TV.SITES) | {"head"}
    for site in tsc:
        np.testing.assert_allclose(tsc[site].scale.numpy(),
                                   np.asarray(s["jscales"][site].scale),
                                   rtol=1e-5)
        np.testing.assert_allclose(tsc[site].zero.numpy(),
                                   np.asarray(s["jscales"][site].zero),
                                   rtol=0, atol=0)


def test_prefix_tune_matches_jax_first_losses(vlm):
    s = vlm
    batches = [_batch(s["japi"], 3000 + i, 2, P + 12) for i in range(3)]
    ccfg = CushionConfig(tune_steps=3, tune_lr=1e-3, lam=0.05, log_every=2)
    jtr = JCC.prefix_tune(s["japi"], s["jparams"], s["jcushion"],
                          iter(batches), QN, ccfg, verbose=False)
    ttr = TCC.prefix_tune(s["api"], s["params"], s["cushion"],
                          (to_torch(b) for b in batches), QN, ccfg,
                          verbose=False)
    err = max(abs(t[k] / j[k] - 1) for t, j in zip(ttr.log, jtr.log)
              for k in ("loss", "ce", "range", "qerr", "gnorm"))
    print(f"tuning logs, none: max relative |port - JAX| {err:.2e}")
    assert err <= 1e-5, err


def test_smoothquant_fold_matches_jax(vlm):
    """SmoothQuant takes the VLM (the dense fold): every folded leaf within
    8 f32 ulp of JAX's, from statistics calibrated with patches."""
    s = vlm
    _, jstats = JCal.calibrate(s["japi"], s["jparams"], [s["calib"]], QW8)
    jsm = JSQ.apply_smoothquant(s["jparams"], jstats, s["jcfg"], alpha=0.8)
    stats = convert.cushion_from_numpy(np_tree(jstats))
    tsm = TSQ.apply_smoothquant(s["params"], stats, s["tcfg"], alpha=0.8)
    got = jax.tree_util.tree_flatten_with_path(np_tree(tsm.tree()))[0]
    want = jax.tree_util.tree_flatten_with_path(np_tree(jsm))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    worst = 0.0
    for (path, g), (_, w) in zip(got, want):
        d = np.abs(g - w) / np.spacing(np.abs(w))
        worst = max(worst, float(d.max()))
    print(f"SmoothQuant on the VLM: largest leaf difference {worst:.0f} ulp")
    assert worst <= 8, worst
    assert not np.array_equal(np_tree(tsm.tree())["layers"]["ln2"]["g"],
                              np.asarray(s["jparams"]["layers"]["ln2"]["g"]))


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def test_launchers_serve_continuous_and_tune_on_cpu(tmp_path, monkeypatch):
    """``--arch internvl2-26b`` at the reduced size on the CPU: the trace's
    requests carry patches and count them among their positions; tune
    draws batches with patches; the static path refuses a VLM."""
    red = t_reduced(t_get_config(ARCH), dtype="float32")
    for mod in (serve, tune):
        monkeypatch.setattr(mod, "get_config",
                            lambda a: red if a == ARCH else None)
    api = build(red, "cpu")
    reqs = serve.poisson_trace(api, 0, 3, 0.0, (P + 12, P + 20), (3,))
    assert [r.batch["tokens"].shape[1] for r in reqs] == [12, 20, 12]
    assert all(r.batch["patches"].shape == (1, P, 64) for r in reqs)
    again = serve.poisson_trace(api, 0, 3, 0.0, (P + 12, P + 20), (3,))
    assert torch.equal(again[1].batch["patches"], reqs[1].batch["patches"])
    out = tmp_path / "art"
    tune.main(["--device", "cpu", "--arch", ARCH, "--out-dir", str(out),
               "--max-prefix-len", "2", "--candidates", "8",
               "--sample-len", str(P + 8), "--steps", "2", "--log-every",
               "2", "--seq-len", str(P + 8), "--eval-batches", "1",
               "--with-scales"])
    outs = serve.main(["--device", "cpu", "--arch", ARCH, "--mode",
                       "continuous", "--quant", "pt_static", "--prequant",
                       "--kv-dtype", "int8", "--cushion", str(out),
                       "--rate", "0", "--n-requests", "3", "--prompt-len",
                       str(P + 8), "--tokens", "3"])
    assert len(outs) == 3
    serve.main(["--device", "cpu", "--arch", ARCH, "--n-layers", "2",
                "--mode", "continuous", "--quant", "pt_static", "--paged",
                "--page-size", "32", "--rate", "0", "--n-requests", "2",
                "--prompt-len", str(P + 8), "--tokens", "2",
                "--cushion-len", "2"])
    with pytest.raises(SystemExit, match="continuous"):
        serve.main(["--device", "cpu", "--arch", ARCH, "--tokens", "2"])
