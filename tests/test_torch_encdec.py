"""Port parity, the encoder-decoder (``repro_torch.models.encdec``) and the
non-causal mode of the attention kernels' plain versions, against the JAX
package on the same weights (JAX's, carried across through
``models/convert.py``), cushion, scales and numpy inputs, in f32, on
``reduced(whisper-base)``: 2 encoder and 4 decoder layers, d_model 64, 4
heads of 16, 32 frames.

Tolerances, measured on the CPU with JAX's functions jitted (the tests
print what they measure: ``pytest -s``):

* Non-causal attention at T != S: the plain forward within 1e-5 of the
  Pallas kernel (interpret mode) and of ``_sdpa_dense`` with no mask; the
  plain backward within 1e-5 of its largest entry against autograd of the
  plain forward and against ``jax.grad`` of ``_sdpa_dense``.
* ``encode``, ``cross_attention`` and ``forward``: logits within 1e-4
  under ``none``, ``pt_dynamic`` and ``pt_static``, a site's L_q within
  1e-4 relative under ``none`` and 2e-3 under the quantized modes, amin /
  amax / absmax_ch within 1e-5 absolute and relative, for the encoder's
  sites (``enc_layers``), the decoder's and the head's. Under
  ``ptoken_dynamic`` an encoder code flipped by a one-ulp difference of
  its input (measured: the second encoder layer's MLP, from inputs 7e-7
  apart, moves one position's state by 9e-4) reaches every decoder
  position through the cross-attention: logits within ``TIE`` = 0.1
  (measured 3.3e-2), the caches within TIE (measured 2.5e-2), L_q within
  ``PT_TOL`` = 5e-2 relative (measured 3.9e-2, the decoder's ``xq``), as
  the hybrid's ptoken bar, and the ranges within 5e-2 relative or TIE
  absolute (measured 1.9e-2 on one channel max of ``down``); the greedy
  tokens stay identical.
* Caches (self- and cross-attention KV) within 1e-5; the prefill's and
  decode's logits within 1e-4.
* Greedy tokens of both engines and of the search: identical.
* Calibration scales within 1e-5 relative; the tuning logs under ``none``
  within 1e-5 relative and the tuned cushion within 1e-5 per element.
* The search's L_q: the method's pt_dynamic bar, 1e-2 relative (ROADMAP
  queue 3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.store import CheckpointManager as JStore  # noqa: E402
from repro.configs import (CushionConfig, QuantConfig, get_config,  # noqa: E402
                           reduced)
from repro.core import calibration as JCal  # noqa: E402
from repro.core import cushioncache as JCC  # noqa: E402
from repro.core import quantization as JQ  # noqa: E402
from repro.core import smoothquant as JSQ  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash_attn  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro.serving import ContinuousEngine as JContinuous  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch.checkpoint.store import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import calibration as TCal  # noqa: E402
from repro_torch.core import cushioncache as TCC  # noqa: E402
from repro_torch.core import smoothquant as TSQ  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_plain, flash_attention_plain)
from repro_torch.launch import serve, tune  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import encdec as TED  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.scheduler import ContinuousEngine, Request  # noqa: E402

QN = QuantConfig()
QD = QuantConfig(mode="pt_dynamic")
QD8 = QuantConfig(mode="pt_dynamic", true_int8=True)
QW8 = QuantConfig(mode="pt_static", true_int8=True)
QPT = QuantConfig(mode="ptoken_dynamic")
QMODES = {"none": QN, "pt_dynamic": QD, "pt_static": QW8,
          "ptoken_dynamic": QPT}
ARCH = "whisper-base"
# the ptoken_dynamic bars (an encoder code flipped upstream, see above):
# logits, caches, L_q and ranges (relative)
TIE, PT_CACHE, PT_TOL = 0.1, 0.1, 5e-2


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def configs():
    return (reduced(get_config(ARCH), dtype="float32"),
            t_reduced(t_get_config(ARCH), dtype="float32"))


@pytest.fixture(scope="module")
def whisper():
    jcfg, tcfg = configs()
    japi = j_build(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(1))
    jcushion = japi.extract_cushion(
        jparams, jnp.asarray([7, 2, 11], jnp.int32), None, QN)
    rs = np.random.RandomState(0)
    Te, D = jcfg.encdec.encoder_seq, jcfg.d_model
    frames = (rs.randn(2, Te, D) * 0.02).astype(np.float32)
    calib = {"tokens": rs.randint(0, jcfg.vocab_size, (2, 12))
             .astype(np.int32), "frames": frames}
    jscales, _ = JCal.calibrate(japi, jparams, [jax.tree.map(jnp.asarray,
                                                             calib)],
                                QW8, cushion=jcushion)
    params = convert.params_from_numpy(np_tree(jparams))
    return dict(
        jcfg=jcfg, tcfg=tcfg, japi=japi, api=build(tcfg, "cpu"),
        jparams=jparams, params=params.tree(), jcushion=jcushion,
        cushion=convert.cushion_from_numpy(np_tree(jcushion)),
        jscales=jscales, scales=convert.scales_from_numpy(
            np_tree(JCal.scales_to_plain(jscales))),
        calib=calib, frames=frames,
        tokens=rs.randint(0, jcfg.vocab_size, (2, 10)).astype(np.int32),
        vocab=jcfg.vocab_size)


def _batch(s, frames=None):
    return {"tokens": s["tokens"],
            "frames": s["frames"] if frames is None else frames}


# ---------------------------------------------------------------------------
# the non-causal mode of the attention kernels' plain versions
# ---------------------------------------------------------------------------

def _qkv(S, T, seed, H=4, Kh=2, hd=16):
    rs = np.random.RandomState(seed)
    return (rs.randn(2, H, S, hd).astype(np.float32),
            rs.randn(2, Kh, T, hd).astype(np.float32),
            rs.randn(2, Kh, T, hd).astype(np.float32))


@pytest.mark.parametrize("S,T", [(5, 37), (24, 9), (1, 33)])
def test_noncausal_plain_matches_pallas_and_sdpa(S, T):
    """Every key j < T visible to every query, T independent of S, GQA."""
    q, k, v = _qkv(S, T, S + T)
    t = torch.from_numpy
    ours = flash_attention_plain(t(q), t(k), t(v), causal=False)
    pallas = j_flash_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False, bq=8, bkv=8, interpret=True)
    dense = JC._sdpa_dense(*(jnp.asarray(a.transpose(0, 2, 1, 3))
                             for a in (q, k, v)), None, None)
    for other in (np.asarray(pallas),
                  np.asarray(dense).transpose(0, 2, 1, 3)):
        np.testing.assert_allclose(ours.numpy(), other, rtol=1e-5,
                                   atol=1e-5)


def test_noncausal_bwd_plain_matches_autograd_and_jax():
    """S = 7 queries over T = 40 keys, GQA (H 4, Kh 2)."""
    q, k, v = _qkv(7, 40, 3)
    do = np.random.RandomState(4).randn(*q.shape).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a.copy()).requires_grad_()
                  for a in (q, k, v))
    o, lse = flash_attention_plain(tq, tk, tv, causal=False, return_lse=True)
    (o * torch.from_numpy(do)).sum().backward()
    got = flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                    o.detach(), lse.detach(),
                                    torch.from_numpy(do), causal=False)

    def jf(q_, k_, v_):
        out = JC._sdpa_dense(q_, k_, v_, None, None)
        return jnp.sum(out * jnp.asarray(do.transpose(0, 2, 1, 3)))

    jg = jax.grad(jf, argnums=(0, 1, 2))(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)))
    for g, auto, want in zip(got, (tq.grad, tk.grad, tv.grad), jg):
        want = np.asarray(want).transpose(0, 2, 1, 3)
        for other in (auto.numpy(), want):
            np.testing.assert_allclose(g.numpy(), other, rtol=0,
                                       atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the model: encode, cross-attention, forward, loss
# ---------------------------------------------------------------------------

def test_encode_and_cross_attention_match_jax(whisper):
    s = whisper
    jout, _ = JED.encode(s["jparams"], jnp.asarray(s["frames"]), s["jcfg"],
                         QN, remat=False)
    tout, _ = TED.encode(s["params"], torch.from_numpy(s["frames"]),
                         s["tcfg"], QN)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)
    jl0 = jax.tree.map(lambda a: a[0], s["jparams"]["decoder"])
    tl0 = {k: (v[0] if not isinstance(v, dict)
               else {n: t[0] for n, t in v.items()})
           for k, v in s["params"]["decoder"].items()}
    jkv = JED.enc_kv(jl0["xattn"], jout, s["jcfg"])
    tkv = TED.enc_kv(tl0["xattn"], tout, s["tcfg"])
    x = np.random.RandomState(5).randn(2, 6, 64).astype(np.float32)
    jo = JED.cross_attention(jl0["xattn"], jnp.asarray(x), jkv, s["jcfg"],
                             QN, None, None)
    to = TED.cross_attention(tl0["xattn"], torch.from_numpy(x), tkv,
                             s["tcfg"], QN, None, None)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)


@pytest.mark.parametrize("mode", list(QMODES))
def test_forward_logits_and_taps_match_jax(whisper, mode):
    s = whisper
    qcfg = QMODES[mode]
    static = mode == "pt_static"
    js, ts = (s["jscales"], s["scales"]) if static else (None, None)
    jl, jt = jax.jit(lambda p, b: s["japi"].forward(
        p, b, qcfg, scales=js, cushion=s["jcushion"], collect=True,
        remat=False))(s["jparams"], jax.tree.map(jnp.asarray, _batch(s)))
    tl, tt = s["api"].forward(s["params"], to_torch(_batch(s)), qcfg,
                              scales=ts, cushion=s["cushion"], collect=True)
    err = np.abs(tl.numpy() - np.asarray(jl)).max()
    print(f"[{mode}] logits max |port - JAX| {err:.2e}")
    flip = mode == "ptoken_dynamic"
    assert err <= (TIE if flip else 1e-4), err
    assert set(tt) == set(jt)
    q_tol = 1e-4 if mode == "none" else (PT_TOL if flip else 2e-3)
    r_tol, r_atol = (PT_TOL, TIE) if flip else (1e-5, 1e-5)
    tols = {"qerr": (q_tol, 0), "amin": (r_tol, r_atol),
            "amax": (r_tol, r_atol), "absmax_ch": (r_tol, r_atol)}
    for group, sites in (("enc_layers", TED.ENC_SITES),
                         ("layers", TED.DEC_SITES)):
        assert set(tt[group]) == set(jt[group]), group
        for site in sites:
            for key, (rtol, atol) in tols.items():
                np.testing.assert_allclose(
                    tt[group][site][key].numpy(),
                    np.asarray(jt[group][site][key]), rtol=rtol, atol=atol,
                    err_msg=f"{group}.{site}.{key}")
    np.testing.assert_allclose(tt["head"]["qerr"].numpy(),
                               np.asarray(jt["head"]["qerr"]), rtol=q_tol)
    np.testing.assert_allclose(float(TED.total_qerr(tt)),
                               float(JED.T.total_qerr(jt)), rtol=q_tol)


@pytest.mark.parametrize("lam", [0.5])
def test_loss_fn_matches_jax(whisper, lam):
    s = whisper
    toks = np.random.RandomState(8).randint(0, s["vocab"], (2, 11)) \
        .astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frames": s["frames"]}
    jl, jaux = jax.jit(lambda p, b: s["japi"].loss_fn(
        p, b, QD, cushion=s["jcushion"], collect=True, remat=False,
        lam=lam, n_skip=2))(s["jparams"], jax.tree.map(jnp.asarray, batch))
    tl, taux = s["api"].loss_fn(s["params"], to_torch(batch), QD,
                                cushion=s["cushion"], collect=True, lam=lam,
                                n_skip=2)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(taux["qerr"]), float(jaux["qerr"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-3)


def test_cushion_zeros_and_extract_cushion_match_jax(whisper):
    """The cushion is the decoder's self-attention KV of the prefix, run
    under zero frames (a null acoustic context)."""
    s = whisper
    z, jz = s["api"].cushion_zeros(3), s["japi"].cushion_zeros(3)
    assert {k: tuple(v.shape) for k, v in z["kv"].items()} == \
        {k: v.shape for k, v in jz["kv"].items()}
    got = s["api"].extract_cushion(s["params"], torch.tensor([7, 2, 11]),
                                   None, QN)
    assert set(got) == {"kv"}
    for k in ("k", "v"):
        np.testing.assert_allclose(got["kv"][k].numpy(),
                                   s["cushion"]["kv"][k].numpy(), atol=1e-5)


def test_calibration_scales_match_jax(whisper):
    s = whisper
    tsc, tstats = TCal.calibrate(s["api"], s["params"],
                                 [to_torch(s["calib"])], QW8,
                                 cushion=s["cushion"])
    assert set(tsc) == {"enc", "dec", "head"}
    assert set(tsc["enc"]) == set(TED.ENC_SITES)
    assert set(tsc["dec"]) == set(TED.DEC_SITES)
    flat = [(("head",), tsc["head"], s["jscales"]["head"])]
    for g in ("enc", "dec"):
        flat += [((g, k), v, s["jscales"][g][k]) for k, v in tsc[g].items()]
    for name, t, j in flat:
        np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale),
                                   rtol=1e-5, err_msg=str(name))
        np.testing.assert_array_equal(t.zero.numpy(), np.asarray(j.zero))
    assert tsc["enc"]["qkv"].scale.shape == (2,)
    assert tsc["dec"]["xq"].scale.shape == (4,)
    assert tstats["enc_layers"]["mlp_in"]["absmax_ch"].shape == (2, 64)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "pt_dynamic_int8"])
def test_prefill_decode_match_jax(whisper, mode):
    """With the cushion: the prefill's logits and all four caches, then
    three decode steps, against JAX; every leaf is written in place."""
    s = whisper
    qcfg = {"none": QN, "pt_dynamic_int8": QD8, "ptoken_dynamic": QPT}[mode]
    japi, api = s["japi"], s["api"]
    B, S = s["tokens"].shape
    jcache = japi.init_cache(B, 32)
    tcache = api.init_cache(B, 32)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    leaves = {k: v for k, v in tcache.items()}
    jl, jcache, jpos = jax.jit(lambda p, b, c: japi.prefill(
        p, b, c, qcfg, cushion=s["jcushion"]))(
            s["jparams"], jax.tree.map(jnp.asarray, _batch(s)), jcache)
    tl, tcache, tpos = api.prefill(s["params"], to_torch(_batch(s)), tcache,
                                   qcfg, cushion=s["cushion"])
    assert int(tpos) == int(jpos) == 3 + S
    assert all(tcache[k] is leaves[k] for k in leaves)

    flip = mode == "ptoken_dynamic"

    def cmp(tl_, jl_, tc, jc):
        err = np.abs(tl_.numpy() - np.asarray(jl_)).max()
        print(f"[{mode}] logits max |port - JAX| {err:.2e}")
        assert err <= (TIE if flip else 1e-4), err
        for k, v in np_tree(jc).items():
            np.testing.assert_allclose(tc[k].numpy(), v,
                                       atol=PT_CACHE if flip else 1e-5,
                                       err_msg=k)

    cmp(tl, jl, tcache, jcache)
    jdec = jax.jit(lambda p, t, pos, c: japi.decode_step(p, t, pos, c,
                                                         qcfg))
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for step in range(3):
        jl, jcache = jdec(s["jparams"], jnp.asarray(tok), jpos + step,
                          jcache)
        tl, tcache = api.decode_step(s["params"], torch.from_numpy(tok),
                                     tpos + step, tcache, qcfg)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    cmp(tl, jl, tcache, jcache)
    assert all(tcache[k] is leaves[k] for k in leaves)


def test_pt_static_is_refused_where_jax_refuses(whisper):
    """The reference's prefill calls the head without scales: its Engine
    fails under pt_static (with int8-resident weights a ValueError at the
    head; with per-call weights an AssertionError). The port's engines
    refuse the mode when they are made, with the reason; its prefill and
    decode step refuse it too."""
    s = whisper
    jb = jax.tree.map(jnp.asarray, {k: v[:1] for k, v in _batch(s).items()})
    # traced, not compiled: the reference raises while it traces
    jpre = jax.eval_shape(lambda p: JQ.prequantize_tree(p, QW8),
                          s["jparams"])
    for params, err in ((jpre, ValueError), (s["jparams"], AssertionError)):
        with pytest.raises(err):
            jax.eval_shape(lambda p, b, c: s["japi"].prefill(
                p, b, c, QW8, scales=s["jscales"]), params, jb,
                s["japi"].init_cache(1, 32))
    why = "lm_head without site scales"
    for pre in (False, True):
        with pytest.raises(ValueError, match=why):
            Engine(s["api"], s["params"], QW8, scales=s["scales"],
                   max_seq=64, prequant=pre)
    with pytest.raises(ValueError, match=why):
        ContinuousEngine(s["api"], s["params"], QW8, scales=s["scales"],
                         n_slots=2, max_seq=64)
    tb = to_torch({k: v[:1] for k, v in _batch(s).items()})
    with pytest.raises(ValueError, match=why):
        s["api"].prefill(s["params"], tb, s["api"].init_cache(1, 32), QW8,
                         scales=s["scales"])


def test_int8_kv_and_paged_are_refused(whisper):
    s = whisper
    with pytest.raises(ValueError, match="kv_dtype"):
        s["japi"].init_cache(1, 16, kv_dtype="int8")
    with pytest.raises(ValueError, match="kv_dtype"):
        s["api"].init_cache(1, 16, kv_dtype="int8")
    assert s["api"].paged_kv_leaves == s["japi"].paged_kv_leaves == ()
    with pytest.raises(ValueError, match="pageable"):
        ContinuousEngine(s["api"], s["params"], QN, n_slots=2, max_seq=64,
                         paged=True, page_size=32)


@pytest.mark.parametrize("mode", ["none", "pt_dynamic_int8",
                                  "ptoken_dynamic"])
def test_engine_tokens_match_jax(whisper, mode):
    s = whisper
    qcfg = {"none": QN, "pt_dynamic_int8": QD8, "ptoken_dynamic": QPT}[mode]
    jeng = JEngine(s["japi"], s["jparams"], qcfg, cushion=s["jcushion"],
                   max_seq=64)
    eng = Engine(s["api"], s["params"], qcfg, cushion=s["cushion"],
                 max_seq=64)
    jt = jeng.generate(jax.tree.map(jnp.asarray, _batch(s)), 6).tokens
    tt = eng.generate(to_torch(_batch(s)), 6).tokens
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert (eng.weight_bytes_fp, eng.weight_bytes_int8) == \
        (jeng.weight_bytes_fp, jeng.weight_bytes_int8)


def _requests(s, n, budgets):
    rs = np.random.RandomState(100)
    Te, D = s["jcfg"].encdec.encoder_seq, s["jcfg"].d_model
    batches = [{"tokens": rs.randint(0, s["vocab"], (1, [8, 12][i % 2]))
                .astype(np.int32),
                "frames": (rs.randn(1, Te, D) * 0.02).astype(np.float32)}
               for i in range(n)]
    j = [JRequest(uid=i, batch=jax.tree.map(jnp.asarray, b),
                  max_new_tokens=m)
         for i, (b, m) in enumerate(zip(batches, budgets))]
    t = [Request(uid=i, batch=to_torch(b), max_new_tokens=m)
         for i, (b, m) in enumerate(zip(batches, budgets))]
    return j, t


def test_pool_matches_engine_and_jax(whisper):
    """Five requests, each with its own frames, through 2 fp slots (so
    slots recycle and each admission carries its encoder states into the
    slot): JAX's tokens, slots and ServeStats, and the port's static B=1
    Engine's tokens."""
    s = whisper
    jreqs, treqs = _requests(s, 5, [5, 3, 6, 4, 5])
    kw = dict(n_slots=2, max_seq=64, chunk_tokens=8)
    ce = ContinuousEngine(s["api"], s["params"], QN, cushion=s["cushion"],
                          **kw)
    jce = JContinuous(s["japi"], s["jparams"], QN, cushion=s["jcushion"],
                      **kw)
    outs, jouts = ce.run(treqs), jce.run(jreqs)
    assert [o.uid for o in outs] == [o.uid for o in jouts]
    for a, b in zip(jouts, outs):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.slot == a.slot
    assert ce.stats.as_dict() == jce.stats.as_dict()
    assert ce.stats.recycles >= 1 and ce.stats.prefill_chunks == 0
    eng = Engine(s["api"], s["params"], QN, cushion=s["cushion"], max_seq=64)
    for r, o in zip(treqs, outs):
        np.testing.assert_array_equal(
            eng.generate(r.batch, r.max_new_tokens).tokens[0], o.tokens)


# ---------------------------------------------------------------------------
# the method, the artifact, SmoothQuant
# ---------------------------------------------------------------------------

def _jax_pools(vocab, ccfg, seed, n_iter):
    rng = jax.random.PRNGKey(seed)
    pools = []
    for _ in range(n_iter):
        rng, k1, _ = jax.random.split(rng, 3)
        pools.append(JCC.candidate_pool(k1, vocab, ccfg.n_candidates,
                                        ccfg.seed_tokens))
    return pools


def test_greedy_search_falls_back_and_matches_jax_tokens(whisper,
                                                         monkeypatch):
    """No KV-reuse scoring (the decoder reads each sample's frames): the
    search takes ``greedy_search_ref``, tiles the frames with the
    candidates, and with JAX's candidate pools finds JAX's tokens."""
    s = whisper
    assert not s["api"].supports_kv_scoring
    ccfg = CushionConfig(max_prefix_len=2, tau=1.5, n_candidates=16,
                         seed_tokens=(1,))
    jsample = {i: s["japi"].make_batch(jax.random.PRNGKey(1000 + i), 1, 12)
               for i in range(1)}
    jres = JCC.greedy_search(s["japi"], s["jparams"], lambda i: jsample[i],
                             QD, ccfg, jax.random.PRNGKey(0), chunk=8,
                             verbose=False)
    it = iter(_jax_pools(s["vocab"], ccfg, 0, 1))
    monkeypatch.setattr(TCC, "candidate_pool", lambda *a, **k: next(it))
    res = TCC.greedy_search(s["api"], s["params"],
                            lambda i: to_torch(jsample[i]), QD, ccfg,
                            torch.Generator(), chunk=8, verbose=False)
    np.testing.assert_array_equal(res.prefix_ids, jres.prefix_ids)
    assert [h["best_tok"] for h in res.history] == \
        [h["best_tok"] for h in jres.history]
    for h, jh in zip(res.history, jres.history):
        np.testing.assert_allclose([h["base_err"], h["best_err"]],
                                   [jh["base_err"], jh["best_err"]],
                                   rtol=1e-2)


def test_prefix_tune_matches_jax(whisper):
    """Three tuning steps under ``none``: the cushion reaches the loss
    through the decoder's causal self-attention and through the
    cross-attention's queries; logs and the tuned cushion as JAX's."""
    s = whisper
    batches = [s["japi"].make_batch(jax.random.PRNGKey(3000 + i), 2, 10)
               for i in range(3)]
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
    for k in ("k", "v"):
        assert not torch.equal(ttr.cushion["kv"][k], s["cushion"]["kv"][k])
        np.testing.assert_allclose(ttr.cushion["kv"][k].numpy(),
                                   np.asarray(jtr.cushion["kv"][k]),
                                   atol=1e-5)


def test_artifact_with_nested_scales_round_trips_both_ways(whisper,
                                                           tmp_path):
    """A cushion with {"enc", "dec", "head"} scales, saved by either store,
    restores in the other with the same bytes and fingerprint."""
    s = whisper
    tree = {"cushion": s["cushion"],
            "scales": TCal.scales_to_plain(s["scales"])}
    fp = TCC.cushion_fingerprint(s["cushion"])
    assert fp == JCC.cushion_fingerprint(s["jcushion"])
    CheckpointManager(str(tmp_path / "t")).save(1, tree, extra={"f": fp})
    jtree, _ = JStore(str(tmp_path / "t")).restore_tree(1)
    JStore(str(tmp_path / "j")).save(
        1, {"cushion": s["jcushion"],
            "scales": JCal.scales_to_plain(s["jscales"])})
    ttree, _ = CheckpointManager(str(tmp_path / "j")).restore_tree(1)
    for a, b in ((np_tree(jtree), tree), (ttree, tree)):
        for (pa, x), (pb, y) in zip(
                jax.tree_util.tree_flatten_with_path(np_tree(a))[0],
                jax.tree_util.tree_flatten_with_path(np_tree(b))[0]):
            assert pa == pb
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    back = TCal.scales_from_plain(ttree["scales"])
    assert set(back) == {"enc", "dec", "head"}
    assert TCC.cushion_fingerprint(ttree["cushion"]) == fp


def test_smoothquant_raises_for_encdec(whisper):
    s = whisper
    with pytest.raises(NotImplementedError, match="no exact fold"):
        JSQ.apply_smoothquant(s["jparams"], {"layers": {}}, s["jcfg"])
    with pytest.raises(NotImplementedError, match="no exact fold"):
        TSQ.apply_smoothquant(s["params"], {"layers": {}}, s["tcfg"])


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def test_launchers_serve_continuous_and_tune_on_cpu(tmp_path, monkeypatch):
    """``--arch whisper-base`` at the reduced size on the CPU: every trace
    request carries its own frames; tune draws batches with frames; the
    static path and pt_static are refused with their reasons."""
    red = configs()[1]
    for mod in (serve, tune):
        monkeypatch.setattr(mod, "get_config",
                            lambda a: red if a == ARCH else None)
    api = build(red, "cpu")
    reqs = serve.poisson_trace(api, 0, 3, 0.0, (8, 12), (3,))
    assert [r.batch["frames"].shape for r in reqs] == [(1, 32, 64)] * 3
    assert not torch.equal(reqs[0].batch["frames"], reqs[1].batch["frames"])
    out = tmp_path / "art"
    tune.main(["--device", "cpu", "--arch", ARCH, "--out-dir", str(out),
               "--max-prefix-len", "2", "--candidates", "8",
               "--sample-len", "8", "--steps", "2", "--log-every", "2",
               "--seq-len", "8", "--eval-batches", "1", "--with-scales"])
    outs = serve.main(["--device", "cpu", "--arch", ARCH, "--mode",
                       "continuous", "--quant", "pt_dynamic", "--cushion",
                       str(out), "--rate", "0", "--n-requests", "3",
                       "--prompt-len", "8", "--tokens", "3"])
    assert len(outs) == 3
    with pytest.raises(SystemExit, match="frames"):
        serve.main(["--device", "cpu", "--arch", ARCH, "--tokens", "2"])
    with pytest.raises(SystemExit, match="lm_head without site scales"):
        serve.main(["--device", "cpu", "--arch", ARCH, "--mode",
                    "continuous", "--quant", "pt_static", "--tokens", "2"])
