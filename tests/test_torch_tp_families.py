"""Port parity, tensor-parallel serving of the MoE, VLM and hybrid families
and of axes that do not divide by tp: ``repro_torch`` over
``torch.distributed`` (gloo, one ``launch/mesh.spawn_tp`` a world size,
every case in it) against the JAX package's unsharded engines, in f32 on
the reduced configs (olmoe: 4 query and 4 KV heads, 8 experts; internvl2:
4 query and 2 KV heads, 16 patches; jamba: one period, 4 query and 2 KV
heads, 128 Mamba channels, 8 experts).

* the rank's layout (``serving/engine.tp_layout``) cuts an axis exactly
  where the reference's specs name tp, and the placement
  (``shard_tree``) cuts JAX's shard shapes there, with the documented
  differences: qkv by heads (every KV head where they do not divide), the
  Mamba ``w_in`` by each half's channels, ``A_log`` by rows, ``w_x``
  whole, ``conv_b`` cut;
* tp = 2, each family, the static ``Engine`` under ``none`` (fp and int8
  KV) and ``pt_static`` with int8-resident weights and int8 KV: prefill
  logits within JAX's own tp bar (2e-4) of JAX's unsharded engine under
  ``none``, and its 10 greedy tokens; under ``pt_static`` within 1e-4 of
  the port's unsharded engine and its tokens (the experts' partial
  outputs summed in f32, the other row-parallel sites in int32), and of
  JAX's in every row where the unsharded port holds them: all rows of
  olmoe and internvl2 (bit-exact on this input), one of jamba's two (in
  the other an f32 rounding difference of the Mamba mixer flips a W8A8
  code against JAX on one rank too, ROADMAP queue 3);
* tp = 4: olmoe fp (the reference's case) and the VLM and the hybrid,
  whose 2 KV heads are whole on every rank (each rank's one query head
  reads its group's KV head of the whole cache, ``kv_window``);
* axes that do not divide: internvl2 with a vocabulary of 257 at tp = 2
  (the embedding and the head whole on every rank, no collective there),
  ``paper_tiny`` at tp = 3, where only d_ff divides;
* each family's ``ContinuousEngine`` at tp = 2, contiguous and paged int8
  pools: JAX's tokens and slots, the ranks' admissions equal;
* jamba's int8 cushion block is whole and bit-identical on every rank,
  and each rank's Mamba cushion state is its channel slice of the
  artifact;
* ``serve.py --tp 2`` serves ``--tp 1``'s tokens (jamba static,
  internvl2 through a paged pool, xlstm static, whisper through a
  contiguous pool).

The encoder-decoder and the xLSTM (reduced whisper-base: 4 heads of 16,
d_ff 128, 2 + 4 layers, 32 frames; reduced xlstm-350m: 2 pairs, 4 heads,
a head width of 32), in the same spawns:

* their layout follows the specs: whisper cuts heads, d_ff and the
  vocabulary (``xattn/wo`` by rows, ``xattn/wq`` / ``wkv`` whole); the
  xLSTM cuts the vocabulary and the mLSTM memory's values, no block
  weight;
* tp = 2 against JAX's unsharded ``Engine``: prefill logits within 2e-4
  and every token under ``none``; JAX's tokens under W8A8 (whisper
  ``pt_dynamic`` with true int8, the xLSTM ``pt_static`` with
  int8-resident ``w_proj``), whose logits are the unsharded port's within
  1e-4; tp = 4 under ``none``;
* the contiguous ``ContinuousEngine`` at tp = 2: the unsharded port's
  tokens, slots and scheduling counters (and JAX's tokens), a rank's pool
  smaller than one rank's;
* each rank holds its value slice of the xLSTM cushion's mLSTM memory and
  the rest of the state whole;
* the unsharded port's whisper ``pt_dynamic`` logits part from JAX's by
  one code flipped at a rounding boundary, pinned to its site.

Tensor-parallel training and tuning of the VLM, the encoder-decoder and
the xLSTM, in the same spawns (``tests/_train_ref.py`` has the JAX side
and the bars): ``shard_train_step`` on a (data 1, model 2) mesh, two steps
of each reduced family (d_ff 256) under ``none`` and ``pt_dynamic``: the
first step's loss, CE and gradient norm within 1e-5 relative of JAX's
one device under ``none``, every leaf's first moment within 2e-6 of its
largest entry of the port's tp = 1 where a rank holds it whole (1e-5
where it holds its part), ``pt_dynamic`` at ROADMAP queue 3's training
bars; internvl2 at tp = 4 with its KV heads whole; whisper with one KV
head (the cross-attention's window of whole KV heads); ``prefix_tune
(mesh=)`` of whisper and the xLSTM against JAX's one device, the ranks'
cushions equal after every step; and which leaves a rank reads in part
(``engine.tp_leaf_parts``, each family's ``cushion_summed``).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import QuantConfig, get_config, reduced  # noqa: E402
from repro.core import calibration as JCal  # noqa: E402
from repro.core import quantization as JQ  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro.serving import ContinuousEngine as JContinuous  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import quantization as TQ  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import xlstm as XL  # noqa: E402
from repro_torch.serving.engine import (leaf_cut, shard_tree,  # noqa: E402
                                        tp_config, tp_layout)
from _tp_probe import run_cases  # noqa: E402
import _train_ref as TRF  # noqa: E402

QN = QuantConfig()
QW8 = QuantConfig(mode="pt_static", true_int8=True)
TOL = 2e-4                # JAX's own tp bar (tests/test_sharding.py)
W8_TOL = 1e-4             # the families' W8A8 bar where no code flips
N_TOKENS = 10
ARCHS = ("olmoe-1b-7b", "internvl2-26b", "jamba-v0.1-52b")
# (name, qcfg, prequant, kv_dtype)
STATIC = [("none-fp", QN, False, None), ("none-int8", QN, False, "int8"),
          ("w8a8-prequant-int8", QW8, True, "int8")]
# (name, kv_dtype, paged)
POOLS = [("int8", "int8", False), ("paged-int8", "int8", True)]
BUDGETS = [5, 3, 6, 4]
QD8 = QuantConfig(mode="pt_dynamic", true_int8=True)
# the encoder-decoder and the xLSTM, and each one's static cases (name,
# qcfg, prequant): W8A8 as the card serves it (whisper: pt_dynamic with
# true int8, the reference cannot serve its pt_static; the xLSTM:
# pt_static with int8-resident w_proj)
REC_ARCHS = ("whisper-base", "xlstm-350m")
REC_STATIC = {"whisper-base": [("none-fp", QN, False),
                               ("pt_dynamic-int8", QD8, False)],
              "xlstm-350m": [("none-fp", QN, False),
                             ("w8a8-prequant", QW8, True)]}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def fake_mesh(tp):
    return types.SimpleNamespace(shape={"data": 1, "tp": tp},
                                 axis_names=("data", "tp"))


def _setup(arch, **over):
    jcfg = get_config(arch)
    tcfg = t_get_config(arch)
    if arch != "paper_tiny":
        jcfg = reduced(jcfg, dtype="float32", **over)
        tcfg = t_reduced(tcfg, dtype="float32", **over)
    japi = j_build(jcfg)
    params = japi.init_params(jax.random.PRNGKey(0))
    cushion = japi.extract_cushion(params, jnp.asarray([1, 2, 3], jnp.int32),
                                   None, QN)
    cal = [japi.make_batch(jax.random.PRNGKey(100 + i), 2, 32)
           for i in range(2)]
    scales, _ = JCal.calibrate(japi, params, cal, QW8, cushion=cushion)
    batch = {k: v for k, v in japi.make_batch(jax.random.PRNGKey(7), 2,
                                              24).items() if k != "labels"}
    reqs = [JRequest(uid=i, batch={
        k: v for k, v in japi.make_batch(jax.random.PRNGKey(200 + i), 1,
                                         (20, 26)[i % 2]).items()
        if k != "labels"}, max_new_tokens=n)
        for i, n in enumerate(BUDGETS)]
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, japi=japi, params=params,
                cushion=cushion, scales=scales, batch=batch, reqs=reqs,
                np_params=np_tree(params), np_cushion=np_tree(cushion),
                np_scales=np_tree(JCal.scales_to_plain(scales)),
                np_batch=np_tree(batch))


@pytest.fixture(scope="module")
def fams():
    return {a: _setup(a) for a in ARCHS}


@pytest.fixture(scope="module")
def recs():
    """The encoder-decoder and the xLSTM, reduced (a batch of whisper
    carries its frames)."""
    return {a: _setup(a) for a in REC_ARCHS}


@pytest.fixture(scope="module")
def odd():
    """The indivisible cases: internvl2 with 257 tokens, paper_tiny."""
    return {"vocab257": _setup("internvl2-26b", vocab_size=257),
            "paper_tiny": _setup("paper_tiny")}


def _case(s, name, **kw):
    return dict(cfg=s["tcfg"], params=s["np_params"],
                cushion=s["np_cushion"], scales=s["np_scales"], max_seq=128,
                name=name, **kw)


def _static(s, name, qcfg, pq, kv, **kw):
    return _case(s, f"{s['arch']}/{name}", kind="static", qcfg=qcfg,
                 prequant=pq, kv_dtype=kv, n_tokens=N_TOKENS, logits=True,
                 **s["np_batch"], **kw)


def _pool(s, name, kv, paged):
    reqs = [dict(np_tree(r.batch), max_new_tokens=r.max_new_tokens)
            for r in s["reqs"]]
    return _case(s, f"{s['arch']}/pool-{name}", kind="continuous", qcfg=QN,
                 kv_dtype=kv, paged=paged, page_size=32, n_slots=2,
                 requests=reqs)


def _rec_static(s, name, qcfg, pq):
    return _case(s, f"{s['arch']}/{name}", kind="static", qcfg=qcfg,
                 prequant=pq, kv_dtype=None, n_tokens=N_TOKENS, logits=True,
                 **s["np_batch"])


def _rec_pool(s):
    """A contiguous pool of 2 slots over the 4 requests: fp for whisper,
    W8A8 with int8-resident ``w_proj`` for the xLSTM."""
    reqs = [dict(np_tree(r.batch), max_new_tokens=r.max_new_tokens)
            for r in s["reqs"]]
    w8 = s["arch"] == "xlstm-350m"
    return _case(s, f"{s['arch']}/pool", kind="continuous",
                 qcfg=QW8 if w8 else QN, prequant=w8, kv_dtype=None,
                 n_slots=2, requests=reqs)


def _rec_cases(recs):
    return [_rec_static(s, *m) for a, s in recs.items()
            for m in REC_STATIC[a]] + [_rec_pool(s) for s in recs.values()]


def _by_name(cases, outs):
    return {c["name"]: [o[i] for o in outs] for i, c in enumerate(cases)}


# tensor-parallel training and tuning of the three families without
# experts: each reduced config (d_ff 256, so that a rank's w_down rows at
# tp = 2 hold whole weight groups of 128 under pt_dynamic) from JAX's
# weights, TRAIN_STEPS steps of shard_train_step on seeded batches against
# JAX's first step on one device and the port's one rank; whisper with one
# KV head, whole on both ranks, against the port's one rank; prefix_tune
# (mesh=) of whisper and the xLSTM (recs' models and cushions) against
# JAX's one device
TRAIN_ARCHS = ("internvl2-26b", "whisper-base", "xlstm-350m")
TRAIN_MODES = ("none", "pt_dynamic")
TRAIN_STEPS = 2
TUNE_ARCHS = ("whisper-base", "xlstm-350m")
TUNE_STEPS, TUNE_LAM = 3, 0.05
# the tuned cushion against JAX's: whisper's KV as the dense family's
# (test_torch_sharding.py), the xLSTM's state at test_torch_xlstm.py's bar
TUNE_CUSHION_TOL = {"whisper-base": 1e-6, "xlstm-350m": 1e-4}


def _train_over(arch):
    return {} if arch == "xlstm-350m" else {"d_ff": 256}


@pytest.fixture(scope="module")
def trains():
    """Per family: the port's reduced config, JAX's weights as numpy, the
    batches, and JAX's first step on one device in each mode."""
    out = {}
    for arch in TRAIN_ARCHS:
        jcfg = reduced(get_config(arch), dtype="float32", **_train_over(arch))
        tcfg = t_reduced(t_get_config(arch), dtype="float32",
                         **_train_over(arch))
        japi = j_build(jcfg)
        jp = japi.init_params(jax.random.PRNGKey(0))
        tb = TRF.family_batches(tcfg, TRAIN_STEPS, seed=40)
        if arch == "xlstm-350m":
            # under pt_dynamic the jitted reference parts from its eager
            # self by 5.5e-2 of a leaf's largest entry here (the mLSTM
            # gates' bias b_if), past the bar, while the port's one rank
            # holds the eager one within 2.4e-6: the port's quantizers are
            # the eager reference's, so that is the one held
            first = dict(TRF.first_steps(japi, jp, tb[0], ("none",)),
                         **TRF.first_steps(japi, jp, tb[0], ("pt_dynamic",),
                                           eager=True))
        else:
            first = TRF.first_steps(japi, jp, tb[0], TRAIN_MODES)
        out[arch] = dict(tcfg=tcfg, np_params=np_tree(jp), batches=tb,
                         first=first)
    return out


@pytest.fixture(scope="module")
def jtunes(recs):
    """JAX's one-device prefix_tune of whisper and the xLSTM under none
    from recs' weights and cushions, and the batches."""
    from repro.configs import CushionConfig
    from repro.core import cushioncache as JCC
    out = {}
    for arch in TUNE_ARCHS:
        s = recs[arch]
        japi = s["japi"]
        batches = [np_tree(japi.make_batch(jax.random.PRNGKey(3000 + i), 2,
                                           24)) for i in range(TUNE_STEPS)]
        ccfg = CushionConfig(tune_steps=TUNE_STEPS, tune_lr=1e-3,
                             lam=TUNE_LAM, log_every=TUNE_STEPS)
        out[arch] = dict(batches=batches, run=JCC.prefix_tune(
            japi, s["params"], s["cushion"],
            iter([jax.tree.map(jnp.asarray, b) for b in batches]), QN, ccfg,
            verbose=False))
    return out


def _train_case(cfg, name, mode, steps, batches, **kw):
    from repro_torch.configs import QuantConfig as TQuantConfig
    return dict(kind="train", name=name, cfg=cfg, batches=batches,
                batch_rows=TRF.B, seq=24, steps=steps, lr=1e-3, warmup=10,
                one_rank=True, first_moment=True, return_params=True,
                qcfg=TQuantConfig(mode=mode), **kw)


def _train_cases(trains, jtunes, recs):
    from repro_torch.configs import CushionConfig as TCushion
    from repro_torch.configs import QuantConfig as TQuantConfig
    cases = [_train_case(t["tcfg"], f"train/{a}/{m}", m, TRAIN_STEPS,
                         t["batches"], params=t["np_params"])
             for a, t in trains.items() for m in TRAIN_MODES]
    kv1 = t_reduced(t_get_config("whisper-base"), dtype="float32",
                    n_kv_heads=1)
    cases.append(_train_case(kv1, "train/whisper-kv-whole", "none", 1,
                             TRF.family_batches(kv1, 1, seed=41), seed=0))
    ccfg = TCushion(tune_steps=TUNE_STEPS, tune_lr=1e-3, lam=TUNE_LAM,
                    log_every=TUNE_STEPS)
    cases += [dict(kind="tune", name=f"tune/{a}", cfg=recs[a]["tcfg"],
                   params=recs[a]["np_params"], cushion=recs[a]["np_cushion"],
                   batches=jtunes[a]["batches"], qcfg=TQuantConfig(),
                   ccfg=ccfg) for a in TUNE_ARCHS]
    return cases


@pytest.fixture(scope="module")
def tp2(fams, odd, recs, trains, jtunes):
    """Every tp = 2 case in one spawn: {name: [rank 0's report, ...]}."""
    cases = [_static(s, n, q, pq, kv) for s in fams.values()
             for n, q, pq, kv in STATIC]
    cases += [_pool(s, n, kv, pg) for s in fams.values()
              for n, kv, pg in POOLS]
    cases += [dict(_static(odd["vocab257"], "none-fp", QN, False, None),
                   name="vocab257")]
    cases += _rec_cases(recs)
    cases += _train_cases(trains, jtunes, recs)
    outs = M.spawn_tp(run_cases, 2, cases, device="cpu", every_rank=True,
                      timeout_s=900)
    return _by_name(cases, outs)


@pytest.fixture(scope="module")
def rec_one(recs):
    """The encoder-decoder's and the xLSTM's cases on one rank, without a
    mesh: {name: report}."""
    cases = _rec_cases(recs)
    outs = run_cases(M.make_tp_mesh(1, device="cpu"),
                     [dict(c, mesh=False) for c in cases])
    return {c["name"]: o for c, o in zip(cases, outs)}


@pytest.fixture(scope="module")
def tp4(fams, recs, trains):
    cases = [_static(fams[a], "none-fp", QN, False, None) for a in ARCHS]
    cases += [_rec_static(recs[a], "none-fp", QN, False) for a in REC_ARCHS]
    # internvl2's training with its 2 KV heads whole on every rank (the
    # production pattern: internvl2-26b's 8 at tp = 16)
    t = trains["internvl2-26b"]
    cases.append(_train_case(t["tcfg"], "train/internvl2-26b/none", "none",
                             TRAIN_STEPS, t["batches"],
                             params=t["np_params"]))
    return _by_name(cases, M.spawn_tp(run_cases, 4, cases, device="cpu",
                                      every_rank=True, timeout_s=900))


@pytest.fixture(scope="module")
def tp3(odd):
    cases = [dict(_static(odd["paper_tiny"], "none-fp", QN, False, None),
                  name="paper_tiny")]
    return _by_name(cases, M.spawn_tp(run_cases, 3, cases, device="cpu",
                                      every_rank=True, timeout_s=900))


def _jax_engine(s, qcfg, prequant, kv):
    static = qcfg.mode == "pt_static"
    return JEngine(s["japi"], s["params"], qcfg, cushion=s["cushion"],
                   scales=s["scales"] if static else None, max_seq=128,
                   kv_dtype=kv, prequant=prequant)




def _jax_ref(s, qcfg, prequant, kv):
    """JAX's unsharded engine: (prefill's last logits, 10 tokens)."""
    eng = _jax_engine(s, qcfg, prequant, kv)
    with JSH.use_mesh(None):
        cache = eng._init_cache(s["batch"]["tokens"].shape[0])
        logits, _, _ = eng._prefill(eng.params, s["batch"], cache)
    logits = np.asarray(logits[:, -1] if logits.ndim == 3 else logits)
    return logits, eng.generate(s["batch"], N_TOKENS).tokens


def _held(ranks, want_logits, want_tokens, tol, rows=None):
    """Every rank's prefill logits within ``tol`` of ``want_logits`` and
    its tokens equal to ``want_tokens`` (in ``rows``, default all), the
    ranks' logits equal."""
    rows = slice(None) if rows is None else rows
    for rep in ranks:
        assert rep["backend"] == "gloo"
        err = float(np.abs(rep["logits"] - want_logits)[rows].max())
        print(f"rank {rep['rank']}: prefill logits max |port tp - want| "
              f"{err:.3g}")
        np.testing.assert_allclose(rep["logits"][rows], want_logits[rows],
                                   rtol=tol, atol=tol)
        np.testing.assert_array_equal(rep["tokens"][rows],
                                      want_tokens[rows])
        np.testing.assert_array_equal(rep["logits"], ranks[0]["logits"])


# ---------------------------------------------------------------------------
# 1. The rank's layout and its cut
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _jax_param_specs(tree, mesh):
    paths = jax.tree_util.tree_leaves(JSH.tree_paths(tree))
    leaves = jax.tree_util.tree_leaves(tree)
    return {p: tuple(JSH.rules_pspec(p, x.shape, mesh, JSH.serve_rules()))
            for p, x in zip(paths, leaves)}


# leaves the port cuts otherwise than the reference's spec (each said at
# the cut, serving/engine.shard_tree): a rank computes whole heads and
# whole channels
OTHERWISE = ("attn/wqkv", "attn/bqkv", "mamba/w_in", "mamba/w_x",
             "mamba/A_log", "mamba/conv_b")


@pytest.mark.parametrize("tp", [2, 3, 4])
@pytest.mark.parametrize("arch", ARCHS + ("paper_tiny",))
def test_layout_and_cut_follow_the_specs(fams, odd, arch, tp):
    """An axis is cut where JAX's spec of its leaves names tp; each leaf of
    a prequantized tree is cut on the spec's axis to JAX's shard shape,
    but for the documented differences; a leaf the spec keeps whole is
    whole (conv_b aside)."""
    s = fams[arch] if arch in fams else odd["paper_tiny"]
    jp = JQ.prequantize_tree(s["params"], QW8)
    full = TQ.prequantize_tree(
        convert.params_from_numpy(s["np_params"]).tree(), QW8)
    jspecs = _jax_param_specs(jp, fake_mesh(tp))
    assert _flat(SH.params_shardings(full, fake_mesh(tp),
                                     SH.serve_rules())) == jspecs
    cfg = s["tcfg"]
    lay = tp_layout(cfg, tp)
    shard = _flat(shard_tree(full, cfg, M.TPMesh(tp - 1, tp, None,
                                                 torch.device("cpu"), None)))
    flat_full = _flat(full)
    for p, spec in jspecs.items():
        shape = tuple(flat_full[p].shape)
        spec = (None,) * (len(shape) - len(spec)) + spec
        c = leaf_cut(p, cfg, tp)
        got = tuple(shard[p].shape)
        if c is not None:
            dim = c[1] % len(shape)
            assert c[0] in lay.cut
            want = list(shape)
            if "attn/wqkv" in p or "attn/bqkv" in p:
                K = cfg.n_kv_heads // (tp if "kv_heads" in lay.cut else 1)
                want[dim] = (cfg.n_heads // tp + 2 * K) * cfg.head_dim
            else:
                want[dim] //= tp
            assert got == tuple(want), p
        else:
            assert got == shape, p
        if any(o in p for o in OTHERWISE):
            continue
        # every other leaf: cut exactly where the spec names tp
        assert (c is not None) == ("tp" in spec), (p, spec, lay.cut)
        if c is not None:
            assert spec[c[1] % len(shape)] == "tp", p
    # the layout says each axis as the specs do
    assert ("vocab" in lay.cut) == (cfg.vocab_size % tp == 0)
    assert ("d_ff" in lay.cut) == (cfg.d_ff % tp == 0)
    if cfg.moe is not None:
        assert ("experts" in lay.cut) == (cfg.moe.num_experts % tp == 0)
    if arch == "jamba-v0.1-52b":
        assert ("inner" in lay.cut) == (SSM.dims(cfg)[0] % tp == 0)


def test_layouts_of_the_served_models():
    """Full width at tp = 2: olmoe cuts heads, experts and vocabulary;
    internvl2's odd vocabulary (92,553) is whole; jamba cuts everything.
    The reduced VLM and hybrid at tp = 4 keep their 2 KV heads whole."""
    def cut(arch, tp, red=False):
        cfg = t_get_config(arch)
        if red:
            cfg = t_reduced(cfg, dtype="float32")
        return set(tp_layout(cfg, tp).cut)
    assert cut("olmoe-1b-7b", 2) >= {"heads", "kv_heads", "experts",
                                     "vocab"}
    assert cut("internvl2-26b", 2) == {"heads", "kv_heads", "d_ff"}
    assert cut("jamba-v0.1-52b", 2) == {"heads", "kv_heads", "d_ff",
                                        "vocab", "experts", "inner"}
    for arch in ("internvl2-26b", "jamba-v0.1-52b"):
        got = cut(arch, 4, red=True)
        assert "heads" in got and "kv_heads" not in got
    assert cut("paper_tiny", 3) == {"d_ff"}


# ---------------------------------------------------------------------------
# 2. The static Engine at tp = 2 against JAX's unsharded one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,qcfg,prequant,kv", STATIC,
                         ids=[s[0] for s in STATIC])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_engine_matches_jax(fams, tp2, arch, name, qcfg, prequant, kv):
    """Under ``none``, JAX's unsharded logits within 2e-4 and its tokens.
    Under ``pt_static``, the port's unsharded engine's logits within 1e-4
    and its tokens (what sharding adds), and JAX's in every row where the
    unsharded port holds JAX's: in jamba one row of this input parts
    from JAX on one rank as well, where an f32 rounding difference of the
    Mamba mixer flips a W8A8 code (ROADMAP queue 3); no other row may."""
    s = fams[arch]
    want_logits, want = _jax_ref(s, qcfg, prequant, kv)
    ranks = tp2[f"{arch}/{name}"]
    if qcfg.mode == "none":
        _held(ranks, want_logits, want, TOL)
        return
    case = _static(s, name, qcfg, prequant, kv)
    one = run_cases(M.make_tp_mesh(1, device="cpu"),
                    [dict(case, mesh=False)])[0]
    _held(ranks, one["logits"], one["tokens"], W8_TOL)
    same = [b for b in range(want.shape[0])
            if np.allclose(one["logits"][b], want_logits[b], rtol=W8_TOL,
                           atol=W8_TOL)
            and np.array_equal(one["tokens"][b], want[b])]
    print(f"{arch} W8A8: rows where one rank holds JAX's: {same}")
    assert len(same) >= want.shape[0] - (arch == "jamba-v0.1-52b")
    _held(ranks, want_logits, want, W8_TOL, rows=same)


def test_jamba_w8a8_parting_pinned(fams, monkeypatch):
    """Where the unsharded port's W8A8 parts from JAX's in jamba's row 0
    (``test_tp2_engine_matches_jax``): every quantized site's input, in
    prefill order, in both packages. The first f32 op to differ is the
    first RMSNorm's mean of squares (a 64-wide row summed in another order:
    <= 2 ulp); every site's input before the parting is within 2e-6 and
    all its codes equal, in both rows. The first code that flips is one
    code of the attention's ``o`` site in row 0, whose JAX input lands
    within 1e-4 of a rounding boundary (x / s + z = 90.50001 there, 90.5 in
    the port, which rounds half to even). The Mamba scan is JAX's bit for
    bit (``test_torch_ssm.py``); it is not the cause."""
    import repro.models.common as JC
    import repro_torch.models.common as TC
    s = fams["jamba-v0.1-52b"]
    jrec, trec = [], []
    jq, tq = JC.qlinear, TC.qlinear

    def j_qlinear(x, w, b, qcfg, scales, site, *a, **kw):
        ss = JC.get_site(scales, site)
        jax.debug.callback(lambda v, sc, z: jrec.append(
            (site, np.asarray(v), float(sc), float(z))), x, ss.scale,
            ss.zero, ordered=True)
        return jq(x, w, b, qcfg, scales, site, *a, **kw)

    def t_qlinear(x, w, b, qcfg, scales, site, *a, **kw):
        ss = TC.get_site(scales, site)
        trec.append((site, x.detach().numpy().copy(), float(ss.scale),
                     float(ss.zero)))
        return tq(x, w, b, qcfg, scales, site, *a, **kw)
    monkeypatch.setattr(JC, "qlinear", j_qlinear)
    monkeypatch.setattr(TC, "qlinear", t_qlinear)
    jax.clear_caches()
    eng = _jax_engine(s, QW8, True, "int8")
    jax.effects_barrier()
    jrec.clear()
    with JSH.use_mesh(None):
        eng._prefill(eng.params, s["batch"], eng._init_cache(2))
    jax.effects_barrier()
    case = dict(_static(s, "w8a8", QW8, True, "int8"), n_tokens=1,
                mesh=False)
    run_cases(M.make_tp_mesh(1, device="cpu"), [case])
    assert len(trec) >= len(jrec) > 14

    def codes(x, sc, z):
        return np.clip(np.round(x / np.float32(sc) + np.float32(z)), 0, 255)
    first = None
    for i, (j, t) in enumerate(zip(jrec, trec)):
        assert j[0] == t[0] and j[2:] == t[2:]
        jx = j[1][:, :t[1].shape[1]]        # JAX pads the prompt
        flips = np.argwhere(codes(jx, *j[2:]) != codes(t[1], *t[2:]))
        if len(flips):
            first = (i, j[0], flips, jx, t[1], j[2:])
            break
        assert np.abs(jx - t[1]).max() <= 2e-6, (i, j[0])
    assert first is not None
    i, site, flips, jx, tx, (sc, z) = first
    print(f"first flipped code: site #{i} ({site}) at {flips.tolist()}: "
          f"JAX x/s+z {jx[tuple(flips[0])] / sc + z!r}, port "
          f"{tx[tuple(flips[0])] / sc + z!r}")
    assert site == "o" and len(flips) == 1 and flips[0][0] == 0
    v = float(jx[tuple(flips[0])]) / sc + z
    assert abs(abs(v - np.floor(v)) - 0.5) < 1e-4
    # the first f32 op that differs: the first norm's mean of squares
    emb = np.take(s["np_params"]["embed"]["w"],
                  np.asarray(s["np_batch"]["tokens"]), axis=0)
    jms = np.asarray(jax.jit(lambda x: jnp.mean(jnp.square(x), axis=-1))(
        emb))
    tms = torch.from_numpy(emb).square().mean(-1).numpy()
    ulp = np.spacing(np.abs(jms))
    print(f"mean of squares: {int((jms != tms).sum())} of {jms.size} rows "
          f"differ, by <= {float((np.abs(jms - tms) / ulp).max()):.0f} ulp")
    assert (jms != tms).any() and (np.abs(jms - tms) <= 2 * ulp).all()


def test_jamba_cushion_on_every_rank(fams, tp2):
    """The int8 cushion block kc / vc is whole and bit-identical to the
    artifact on both ranks (kc_tp / vc_tp its KV heads' slice); each
    rank's Mamba cushion state is its channel slice of the artifact, bit
    for bit."""
    s = fams["jamba-v0.1-52b"]
    art = {k: np.asarray(v, np.float32)
           for k, v in s["cushion"]["kv"].items()}
    st = {k: np.asarray(v, np.float32)
          for k, v in s["cushion"]["state"].items()}
    n = SSM.dims(s["tcfg"])[0] // 2
    kn = s["tcfg"].n_kv_heads // 2
    for name in ("none-int8", "w8a8-prequant-int8"):
        for rank, rep in enumerate(tp2[f"jamba-v0.1-52b/{name}"]):
            cu = rep["cushion"]
            for c, k in (("kc", "k"), ("vc", "v")):
                np.testing.assert_array_equal(cu[c], art[k])
                np.testing.assert_array_equal(
                    cu[c + "_tp"], art[k][:, :, kn * rank:kn * (rank + 1)])
            cs = rep["cushion_state"]
            np.testing.assert_array_equal(
                cs["h"], st["h"][..., n * rank:n * (rank + 1), :])
            np.testing.assert_array_equal(
                cs["conv"], st["conv"][..., n * rank:n * (rank + 1)])


# ---------------------------------------------------------------------------
# 3. tp = 4, whole KV heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_tp4_engine_matches_jax(fams, tp4, arch):
    s = fams[arch]
    want_logits, want = _jax_ref(s, QN, False, None)
    ranks = tp4[f"{arch}/none-fp"]
    _held(ranks, want_logits, want, TOL)
    if arch != "olmoe-1b-7b":
        # the 2 KV heads whole on every rank: the fp cache rows [0:m) hold
        # the whole cushion on each
        m = 3
        art = np.asarray(s["cushion"]["kv"]["k"], np.float32)
        for rep in ranks:
            rows = rep["cushion"]["k_rows"]
            assert rows.shape[-2] == s["tcfg"].n_kv_heads
            np.testing.assert_array_equal(
                rows, np.broadcast_to(art[:, None], rows.shape))
            assert rows.shape[2] == m


# ---------------------------------------------------------------------------
# 4. Axes that do not divide
# ---------------------------------------------------------------------------

def test_odd_vocabulary_served_whole(odd, tp2):
    s = odd["vocab257"]
    assert "vocab" not in tp_layout(s["tcfg"], 2).cut
    want_logits, want = _jax_ref(s, QN, False, None)
    _held(tp2["vocab257"], want_logits, want, TOL)


def test_paper_tiny_tp3_only_d_ff_cut(odd, tp3):
    s = odd["paper_tiny"]
    want_logits, want = _jax_ref(s, QN, False, None)
    _held(tp3["paper_tiny"], want_logits, want, TOL)


# ---------------------------------------------------------------------------
# 5. The ContinuousEngine at tp = 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pools(fams):
    out = {}
    for arch, s in fams.items():
        for name, kv, paged in POOLS:
            ce = JContinuous(s["japi"], s["params"], QN, n_slots=2,
                             max_seq=128, cushion=s["cushion"], kv_dtype=kv,
                             paged=paged, page_size=32)
            out[f"{arch}/pool-{name}"] = {o.uid: (o.tokens, o.slot)
                                          for o in ce.run(s["reqs"])}
    return out


@pytest.mark.parametrize("name,kv,paged", POOLS, ids=[p[0] for p in POOLS])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_continuous_matches_jax(fams, tp2, jax_pools, arch, name, kv,
                                    paged):
    key = f"{arch}/pool-{name}"
    want = jax_pools[key]
    ranks = tp2[key]
    for rep in ranks:
        assert sorted(rep["tokens"]) == sorted(want)
        for uid, (toks, slot) in want.items():
            np.testing.assert_array_equal(rep["tokens"][uid], toks)
        slots = {uid: slot for uid, slot, _ in rep["admissions"]}
        assert slots == {uid: slot for uid, (_, slot) in want.items()}
        assert rep["admissions"] == ranks[0]["admissions"]
        assert rep["stats"]["recycles"] >= 1


# ---------------------------------------------------------------------------
# 6. The encoder-decoder and the xLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 3, 4])
@pytest.mark.parametrize("arch", REC_ARCHS)
def test_recurrent_layout_and_cut_follow_the_specs(recs, arch, tp):
    """Every leaf of whisper and the xLSTM is cut exactly where JAX's serve
    spec names tp, to JAX's shard shape, but for the fused ``wqkv``
    (heads, as the other families): whisper's ``xattn/wo`` by rows (the
    rule ``attn/wo$`` finds it), ``xattn/wq`` and ``xattn/wkv`` whole; the
    xLSTM's block weights all whole (the reference's ``xlstm/`` rules
    match none of its paths), its embedding and head by vocabulary. The
    xLSTM's layout also cuts the mLSTM memory's values where the head
    width divides, a state axis that no leaf holds."""
    s = recs[arch]
    jspecs = _jax_param_specs(s["params"], fake_mesh(tp))
    full = convert.params_from_numpy(s["np_params"]).tree()
    cfg = s["tcfg"]
    lay = tp_layout(cfg, tp)
    shard = _flat(shard_tree(full, cfg, M.TPMesh(tp - 1, tp, None,
                                                 torch.device("cpu"), None)))
    flat_full = _flat(full)
    for p, spec in jspecs.items():
        shape = tuple(flat_full[p].shape)
        spec = (None,) * (len(shape) - len(spec)) + spec
        c = leaf_cut(p, cfg, tp)
        got = tuple(shard[p].shape)
        want = list(shape)
        if c is not None:
            dim = c[1] % len(shape)
            if "attn/wqkv" in p:
                want[dim] = 3 * cfg.n_heads // tp * cfg.head_dim
            else:
                want[dim] //= tp
                assert spec[dim] == "tp", p
        assert got == tuple(want), p
        if "attn/wqkv" not in p:
            assert (c is not None) == ("tp" in spec), (p, spec, lay.cut)
        if arch == "xlstm-350m" and p.startswith("layers/"):
            assert c is None and "tp" not in spec, p
        if "xattn/wq" in p or "xattn/wkv" in p:
            assert c is None and "tp" not in spec, p
    assert ("vocab" in lay.cut) == (cfg.vocab_size % tp == 0)
    if arch == "whisper-base":
        assert ("heads" in lay.cut) == (cfg.n_heads % tp == 0)
        assert leaf_cut("decoder/xattn/wo", cfg, tp) == (
            ("heads", -2, "block") if "heads" in lay.cut else None)
    else:
        assert set(lay.cut) <= {"vocab", "values"}
        assert ("values" in lay.cut) == (XL.dims(cfg)[2] % tp == 0)


def test_recurrent_layouts_at_full_width():
    """whisper-base at tp = 2 and 4 cuts its 8 heads and its d_ff, not its
    odd vocabulary (51,865); xlstm-350m cuts its vocabulary (50,304) and
    the mLSTM values (512 a head) at 2, 3 (the vocabulary only: 512 does
    not divide by 3) and 4."""
    wh, xl = t_get_config("whisper-base"), t_get_config("xlstm-350m")
    for tp in (2, 4):
        assert set(tp_layout(wh, tp).cut) == {"heads", "kv_heads", "d_ff"}
        assert set(tp_layout(xl, tp).cut) == {"vocab", "values"}
        rank = tp_config(xl, tp)
        assert XL.value_width(rank) == 512 // tp
        assert (rank.n_heads, rank.vocab_size) == (4, 50304 // tp)
    assert set(tp_layout(xl, 3).cut) == {"vocab"}


def _one_rank_counters(stats):
    """``ServeStats`` without what a rank holds less of (its weights and
    its pool): the scheduling counters."""
    return {k: v for k, v in stats.items()
            if not k.startswith("weight_bytes") and k != "pool_bytes"}


@pytest.mark.parametrize("arch,name", [(a, m[0]) for a in REC_ARCHS
                                       for m in REC_STATIC[a]])
def test_tp2_recurrent_engine_matches_jax(recs, tp2, rec_one, arch, name):
    """Under ``none`` JAX's unsharded logits within 2e-4 (the reference's
    tp bar) and its tokens; under W8A8 JAX's tokens, and the unsharded
    port's logits within 1e-4 (what sharding adds: every row-parallel
    site of whisper sums int32, the xLSTM's gather of the mLSTM values
    adds zeros). The unsharded port's gap to JAX's logits is printed: for
    whisper's ``pt_dynamic`` one code flipped at a rounding boundary
    (``test_whisper_pt_dynamic_parting_pinned``)."""
    s = recs[arch]
    qcfg, pq = {m[0]: m[1:] for m in REC_STATIC[arch]}[name]
    want_logits, want = _jax_ref(s, qcfg, pq, None)
    ranks = tp2[f"{arch}/{name}"]
    if qcfg.mode == "none":
        _held(ranks, want_logits, want, TOL)
        return
    one = rec_one[f"{arch}/{name}"]
    _held(ranks, one["logits"], want, W8_TOL)
    gap = float(np.abs(one["logits"] - want_logits).max())
    print(f"{arch} {name}: one rank's prefill logits max |port - JAX| "
          f"{gap:.3g}")
    np.testing.assert_array_equal(one["tokens"], want)


def test_whisper_pt_dynamic_parting_pinned(recs, monkeypatch):
    """Where the unsharded port's whisper logits under true-int8
    ``pt_dynamic`` part from JAX's (``test_tp2_recurrent_engine_matches_jax``
    prints the gap, 0.0263): every true-int8 site's input and its dynamic
    range, in prefill order, in both packages. Two roundings the port
    cannot match meet at one code: the first f32 op to differ is the
    encoder's first LayerNorm (a 64-wide row's mean and variance summed in
    another order than XLA's: every site's input is then within 2e-6 of
    JAX's), and jitted JAX multiplies a range by 1 / 255 where the port
    divides by 255, as the eager reference does
    (``test_torch_train.py::test_reference_quantizer_jit_and_eager_differ``):
    with the ranges' ends apart by the inputs' ulps, the scales differ by
    up to 8 ulp (0 to 5 measured). No code flips at the encoder's 8 sites
    nor at the first decoder layer's 6; the first that flips is one code of
    the second decoder layer's ``qkv`` site (the 15th site), row 1,
    position 6, feature 22, where JAX's x / s + z is 77.5 exactly (rounded
    half to even to 78) and the port's 77.49997 (77). Either rounding
    alone leaves it at 77.499985: it takes both."""
    import repro.core.quantization as JQU
    import repro_torch.core.quantization as TQU
    s = recs["whisper-base"]
    jrec, trec = [], []
    jt, tt = JQU.true_int_dot, TQU.true_int_dot

    def j_true(x, w, cfg, site):
        sx, zx = JQU.params_from_minmax(*JQU.act_minmax(x, False), 8, False)
        jax.debug.callback(lambda v, a, b: jrec.append(
            (np.asarray(v), np.float32(a), np.float32(b))), x, sx, zx,
            ordered=True)
        return jt(x, w, cfg, site)

    def t_true(x, w, cfg, site, row_parallel=False, rng=None):
        mn, mx = TQU.act_minmax(x, False, 1, False) if rng is None else rng
        sx, zx = TQU.params_from_minmax(mn, mx, 8, False)
        trec.append((x.detach().numpy().copy(), np.float32(sx),
                     np.float32(zx)))
        return tt(x, w, cfg, site, row_parallel, rng)
    monkeypatch.setattr(JQU, "true_int_dot", j_true)
    monkeypatch.setattr(TQU, "true_int_dot", t_true)
    jax.clear_caches()
    eng = _jax_engine(s, QD8, False, None)
    jax.effects_barrier()
    jrec.clear()
    with JSH.use_mesh(None):
        eng._prefill(eng.params, s["batch"], eng._init_cache(2))
    jax.effects_barrier()
    case = dict(_rec_static(s, "pt_dynamic", QD8, False), n_tokens=1,
                mesh=False)
    run_cases(M.make_tp_mesh(1, device="cpu"), [case])
    ne, L = s["tcfg"].encdec.encoder_layers, s["tcfg"].n_layers
    # the encoder's sites, then each decoder layer's six, then the head
    assert len(jrec) == len(trec) == 4 * ne + 6 * L + 1

    def codes(x, sc, z):
        return np.clip(np.round(x / sc + z), 0, 255)
    first = None
    for i, (j, t) in enumerate(zip(jrec, trec)):
        assert j[0].shape == t[0].shape and j[2] == t[2], i
        ulps = abs(float(j[1]) - float(t[1])) / np.spacing(t[1])
        print(f"site #{i}: scales {ulps:.0f} ulp apart")
        assert ulps <= 8, (i, ulps)
        flips = np.argwhere(codes(*j) != codes(*t))
        if len(flips):
            first = (i, flips)
            break
        assert np.abs(j[0] - t[0]).max() <= 2e-6, i
    assert first is not None
    i, flips = first
    j, t = jrec[i], trec[i]
    at = tuple(flips[0])
    v_j, v_t = j[0][at] / j[1] + j[2], t[0][at] / t[1] + t[2]
    print(f"first flipped code: site #{i} at {flips.tolist()}: JAX x/s+z "
          f"{v_j!r}, port {v_t!r}; alone: JAX's x at the port's scale "
          f"{j[0][at] / t[1] + t[2]!r}, the port's x at JAX's "
          f"{t[0][at] / j[1] + j[2]!r}")
    assert (i, len(flips), at) == (4 * ne + 6, 1, (1, 6, 22))
    assert v_j == np.float32(77.5) and np.round(v_t) == 77
    for alone in (j[0][at] / t[1] + t[2], t[0][at] / j[1] + j[2]):
        assert np.round(alone) == 77
    # the first f32 op that differs: the encoder's first LayerNorm
    frames = np.array(s["np_batch"]["frames"], np.float32)
    jmu, jvar = jax.jit(lambda x: (jnp.mean(x, -1), jnp.var(x, -1)))(frames)
    tf = torch.from_numpy(frames)
    tmu, tvar = tf.mean(-1).numpy(), tf.var(-1, unbiased=False).numpy()
    diff = (np.asarray(jmu) != tmu) | (np.asarray(jvar) != tvar)
    print(f"LayerNorm statistics: {int(diff.sum())} of {diff.size} rows "
          f"differ")
    assert diff.any()
    assert np.abs(np.asarray(jvar) - tvar).max() <= 4 * np.spacing(
        np.abs(tvar)).max()


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_tp4_recurrent_engine_matches_jax(recs, tp4, arch):
    """tp = 4: whisper one head a rank, the xLSTM 8 of each head's 32
    values a rank; JAX's logits within 2e-4 and its tokens."""
    s = recs[arch]
    want_logits, want = _jax_ref(s, QN, False, None)
    _held(tp4[f"{arch}/none-fp"], want_logits, want, TOL)


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_tp2_recurrent_pool_matches_one_rank(recs, tp2, rec_one, arch):
    """The contiguous pool at tp = 2 (4 requests, 2 slots: slots recycle,
    each admission scatters its cross KV or its state into the rank's part
    of the slot): the unsharded port's tokens, slots, admissions and
    scheduling counters on every rank, JAX's tokens and slots, and a
    rank's pool smaller than one rank's."""
    s = recs[arch]
    one = rec_one[f"{arch}/pool"]
    case = _rec_pool(s)
    ce = JContinuous(s["japi"], s["params"], case["qcfg"], n_slots=2,
                     max_seq=128, cushion=s["cushion"],
                     scales=s["scales"] if case["prequant"] else None,
                     prequant=case["prequant"])
    jout = {o.uid: (o.tokens, o.slot) for o in ce.run(s["reqs"])}
    for rep in tp2[f"{arch}/pool"]:
        assert sorted(rep["tokens"]) == sorted(one["tokens"]) == \
            sorted(jout)
        for uid, toks in one["tokens"].items():
            np.testing.assert_array_equal(rep["tokens"][uid], toks)
            np.testing.assert_array_equal(toks, jout[uid][0])
        assert rep["admissions"] == one["admissions"]
        assert {u: sl for u, sl, _ in rep["admissions"]} == \
            {u: sl for u, (_, sl) in jout.items()}
        assert _one_rank_counters(rep["stats"]) == \
            _one_rank_counters(one["stats"])
        assert rep["stats"]["recycles"] >= 1
        assert rep["stats"]["pool_bytes"] < one["stats"]["pool_bytes"]
        assert rep["stats"]["weight_bytes_fp"] < \
            one["stats"]["weight_bytes_fp"]


def test_xlstm_state_cut_on_every_rank(recs, tp2):
    """Each rank's xLSTM cushion state (as its prefill reads it) is the
    mLSTM memory's value slice of the artifact, and every other leaf the
    artifact's whole, bit for bit."""
    s = recs["xlstm-350m"]
    art = {f"{g}.{k}": np.asarray(v, np.float32)
           for g, d in s["cushion"]["state"].items() for k, v in d.items()}
    n = XL.dims(s["tcfg"])[2] // 2
    for name in ("none-fp", "w8a8-prequant"):
        for rank, rep in enumerate(tp2[f"xlstm-350m/{name}"]):
            cs = rep["cushion_state"]
            assert sorted(cs) == sorted(art)
            for k, v in art.items():
                want = v[..., n * rank:n * (rank + 1)] if k == "m.C" else v
                np.testing.assert_array_equal(cs[k], want, err_msg=k)


# ---------------------------------------------------------------------------
# 7. The launcher
# ---------------------------------------------------------------------------

_SERVE_W8 = ["--quant", "pt_static", "--prequant", "--kv-dtype", "int8"]


@pytest.mark.parametrize("arch,extra", [
    ("jamba-v0.1-52b", _SERVE_W8),
    ("internvl2-26b", _SERVE_W8 + ["--mode", "continuous", "--paged",
                                   "--page-size", "32", "--rate", "0",
                                   "--n-requests", "3"]),
    ("xlstm-350m", ["--quant", "pt_static", "--prequant"]),
    ("whisper-base", ["--mode", "continuous", "--rate", "0",
                      "--n-requests", "3"]),
], ids=["jamba-static", "internvl2-paged", "xlstm-static",
        "whisper-continuous"])
def test_serve_tp2_gives_tp1_tokens(arch, extra):
    """``serve.py --tp 2`` (the reduced config, a 4-token cushion) serves
    the tokens of ``--tp 1``: the static path for the hybrid and the xLSTM
    (W8A8, int8-resident weights; the hybrid with int8 KV), a paged W8A8
    pool for the VLM (each request's patches the same on both ranks), a
    contiguous fp pool for whisper (each request's frames)."""
    argv = ["--device", "cpu", "--smoke", "--arch", arch,
            "--cushion-len", "4", "--tokens", "6", "--prompt-len", "24",
            *extra]
    one = serve.main(argv)
    two = serve.main(argv + ["--tp", "2"])
    if isinstance(one, list):
        assert len(one) == 3
        assert [o.uid for o in two] == [o.uid for o in one]
        for a, b in zip(one, two):
            np.testing.assert_array_equal(b.tokens, a.tokens)
    else:
        np.testing.assert_array_equal(two.tokens, one.tokens)


# ---------------------------------------------------------------------------
# 8. Tensor-parallel training and tuning of the VLM, the encoder-decoder and
#    the xLSTM
# ---------------------------------------------------------------------------

def _ranks_agree(ranks):
    """The ranks' metrics, and every entry each holds whole (a leaf's
    entries past its ``TPPart.own``), bit for bit; returns how many leaves
    every rank holds whole."""
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
    n = 0
    for path, leaf in ranks[0]["leaves"].items():
        own = leaf["part"][0]
        if own < 0:
            continue
        for r in ranks[1:]:
            np.testing.assert_array_equal(
                TRF.flat(r["params"])[path][..., own:],
                TRF.flat(ranks[0]["params"])[path][..., own:], err_msg=path)
        n += own == 0
    return n


def _held_to_one_rank(ranks, what):
    """Each rank's first moment after one step against the port's one
    rank cut to its part: every leaf it holds whole within
    ``TRF.WHOLE_LEAF`` of the leaf's largest entry (a missing sum over tp
    halves a gradient, a sum too many doubles it), its own parts within
    ``TRF.FIRST_STEP`` (their products read activations whose
    row-parallel sums add in another order)."""
    for r in ranks:
        got, want = TRF.flat(r["mu1"]), TRF.flat(r["one"]["mu1"])
        whole = {p for p, lf in r["leaves"].items() if lf["part"][0] == 0}
        for keep, bar in ((whole, TRF.WHOLE_LEAF),
                          (set(want) - whole, TRF.FIRST_STEP)):
            TRF.leafwise({p: got[p] for p in keep},
                         {p: want[p] for p in keep}, want, bar,
                         f"{what} rank {r['tp_rank']} vs tp = 1 "
                         f"({'whole' if keep is whole else 'cut'} leaves)")


def _against_jax(ranks, first, mode, what):
    """The first step against JAX's one device: under ``none`` the loss,
    CE and gradient norm within ``TRF.FIRST_STEP`` relative; under
    ``pt_dynamic`` the loss within ``TRF.QAT_TOL``'s and the first moment,
    each rank's part, within its bar of a leaf's largest entry, against
    JAX's and the port's one rank's."""
    m0, j = ranks[0]["metrics"][0], first[mode]
    rel = {k: abs(m0[k] / j[k] - 1) for k in ("loss", "ce", "grad_norm")}
    print(f"{what} {mode}: first step vs JAX, relative {rel}")
    if mode == "none":
        assert max(rel.values()) <= TRF.FIRST_STEP
        return
    loss_tol, grad_tol = TRF.QAT_TOL[mode]
    assert rel["loss"] <= loss_tol
    jmu = TRF.flat(j["mu1"])
    for r in ranks:
        assert abs(m0["loss"] / r["one"]["metrics"][0]["loss"] - 1) \
            <= loss_tol
        cfg = r["cfg"]
        TRF.leafwise(TRF.flat(r["mu1"]),
                     TRF.cut(j["mu1"], cfg, r["tp_rank"], r["tp"]), jmu,
                     grad_tol, f"{what} {mode} rank {r['tp_rank']} vs JAX")
        want = TRF.flat(r["one"]["mu1"])
        TRF.leafwise(TRF.flat(r["mu1"]), want, want, grad_tol,
                     f"{what} {mode} rank {r['tp_rank']} vs one rank")


@pytest.mark.parametrize("mode", TRAIN_MODES)
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_tp2_family_train_matches_jax_and_one_rank(trains, tp2, arch, mode):
    """``shard_train_step`` on a (data 1, model 2) mesh, two steps of each
    reduced family: the ranks agree bit for bit where they hold the same
    thing; the first step against JAX's ``make_train_step`` loss on one
    device (the function GSPMD partitions) and, under ``none``, every
    leaf's gradient against the port's one rank. What each holds whole:
    internvl2 its norms, embedding and head where the vocabulary is cut
    (4 query and 2 KV heads, both cut); whisper the cross-attention's
    ``wq`` / ``wkv`` (read through windows, summed over tp) and the
    encoder's norms (their gradient through ``enc_out``'s copy-to-tp);
    the xLSTM every block weight (q, k, v and the gates enter the mixing
    through a copy-to-tp)."""
    ranks = [dict(r, cfg=trains[arch]["tcfg"], tp=2)
             for r in tp2[f"train/{arch}/{mode}"]]
    assert _ranks_agree(ranks) >= 3
    assert all(r["collectives"][0] > 0 for r in ranks)
    _against_jax(ranks, trains[arch]["first"], mode, f"[{arch} tp 2]")
    if mode == "none":
        _held_to_one_rank(ranks, f"[{arch} tp 2]")
    leaves = ranks[0]["leaves"]
    if arch == "whisper-base":
        for leaf in ("decoder/xattn/wq", "decoder/xattn/wkv"):
            assert tuple(leaves[leaf]["part"]) == (0, True), leaf
    if arch == "xlstm-350m":
        assert all(tuple(lf["part"]) == (0, False)
                   for p, lf in leaves.items() if p.startswith("layers/"))


def test_tp4_vlm_train_with_whole_kv_heads(trains, tp4):
    """internvl2 at tp = 4: one query head a rank, the 2 KV heads whole on
    every rank (its ``wqkv`` the rank's query columns, then every KV
    head's, summed over tp): JAX's first step under ``none`` and every
    leaf's gradient the port's one rank's."""
    arch = "internvl2-26b"
    ranks = [dict(r, cfg=trains[arch]["tcfg"], tp=4)
             for r in tp4[f"train/{arch}/none"]]
    hd = trains[arch]["tcfg"].head_dim
    assert tuple(ranks[0]["leaves"]["layers/attn/wqkv"]["part"]) == (hd,
                                                                     True)
    _ranks_agree(ranks)
    _against_jax(ranks, trains[arch]["first"], "none", f"[{arch} tp 4]")
    _held_to_one_rank(ranks, f"[{arch} tp 4]")


def test_tp2_whisper_whole_kv_heads_sum_the_encoder(tp2):
    """whisper with one KV head at tp = 2: the heads are cut and the KV
    head is whole on both ranks, so every rank forms the whole
    cross-attention KV from ``enc_out`` and reads its group's window of
    it (``kv_window``): the encoder's gradient and ``xattn/wkv``'s are the
    rank's shares, summed over tp; every leaf against the port's one
    rank."""
    ranks = tp2["train/whisper-kv-whole"]
    assert tuple(ranks[0]["leaves"]["decoder/xattn/wkv"]["part"]) == (0,
                                                                       True)
    _ranks_agree(ranks)
    _held_to_one_rank(ranks, "[whisper one KV head tp 2]")


@pytest.mark.parametrize("arch", TUNE_ARCHS)
def test_tp2_family_prefix_tune_matches_jax(recs, jtunes, tp2, arch):
    """``prefix_tune(mesh=)`` on a model axis of two ranks against JAX's
    one device under ``none``: the logs within 1e-5 relative, the tuned
    cushion within ``TUNE_CUSHION_TOL``, the ranks' cushions equal after
    every step. The xLSTM's mLSTM state (``C`` read by its value slice, ``n``
    and ``m`` towards it) has its gradient summed over tp, its sLSTM state
    not (``xlstm.cushion_summed``); whisper's KV as the dense family's."""
    jtr, ranks = jtunes[arch]["run"], tp2[f"tune/{arch}"]
    assert ranks[0]["fingerprint"] == ranks[1]["fingerprint"]
    for r in ranks:
        assert [x["step"] for x in r["log"]] == list(range(TUNE_STEPS))
        assert all(x["ranks_equal"] == 1.0 for x in r["log"])
    worst = {key: max(abs(a[key] / b[key] - 1)
                      for a, b in zip(ranks[0]["log"], jtr.log))
             for key in ("loss", "ce", "range", "qerr", "gnorm")}
    print(f"[{arch}] tune tp 2 vs JAX, max relative log difference: "
          f"{worst}")
    assert max(worst.values()) < 1e-5
    got = TRF.flat(ranks[0]["cushion"])
    want = TRF.flat(np_tree(jtr.cushion))
    start = TRF.flat(recs[arch]["np_cushion"])
    for path, w in want.items():
        err = float(np.abs(got[path] - w).max())
        move = float(np.abs(w - start[path]).max())
        print(f"[{arch}] tuned {path}: max |tp2 - JAX| {err:.2e}, max move "
              f"{move:.2e}")
        assert move > 1e-4, path
        assert err <= TUNE_CUSHION_TOL[arch], path


def test_marks_of_the_leaves_read_in_part():
    """Which leaves a rank reads in part: whisper's ``xattn/wq`` / ``wkv``
    where its heads are cut (tp = 2), not where every rank computes its 8
    heads whole (tp = 16, the dry-run's mesh); no xLSTM block weight; the
    cushion's KV where the heads are cut, the xLSTM's mLSTM state (not
    its sLSTM state) where the values are, the hybrid's Mamba state where
    its channels are."""
    from repro_torch.models import transformer as TT
    from repro_torch.serving.engine import tp_leaf_parts
    wh = t_get_config("whisper-base")
    meta = _meta_tree(wh)
    for tp, summed in ((2, True), (16, False)):
        parts = _flat(tp_leaf_parts(meta, wh, tp))
        for leaf in ("decoder/xattn/wq", "decoder/xattn/wkv"):
            assert tuple(parts[leaf]) == (0, summed), (tp, leaf)
        assert tuple(parts["decoder/xattn/wo"])[0] == (-1 if summed else 0)
    xl = t_get_config("xlstm-350m")
    parts = _flat(tp_leaf_parts(_meta_tree(xl), xl, 2))
    assert all(tuple(v) == (0, False) for p, v in parts.items()
               if p.startswith("layers/"))
    rank = tp_config(xl, 2)
    cush = XL.cushion_zeros(xl, 0, "meta")
    got = _flat(XL.cushion_summed(cush, rank))
    assert got == {f"state/{g}/{k}": g == "m"
                   for g in ("m", "s") for k in cush["state"][g]}
    assert not any(_flat(XL.cushion_summed(cush, tp_config(xl, 3))).values())
    kv = {"kv": {"k": None, "v": None}}
    assert TT.cushion_summed(kv, tp_config(wh, 2)) == {
        "kv": {"k": True, "v": True}}
    assert TT.cushion_summed(kv, tp_config(wh, 16)) == {
        "kv": {"k": False, "v": False}}
    # the hybrid's Mamba state where its channels are cut
    from repro_torch.models import hybrid as HY
    jb = t_get_config("jamba-v0.1-52b")
    hy = {**kv, "state": {"h": None, "conv": None}}
    assert HY.cushion_summed(hy, tp_config(jb, 2)) == {
        "kv": {"k": True, "v": True},
        "state": {"h": True, "conv": True}}


def _meta_tree(cfg):
    from repro_torch.models.registry import build
    return build(cfg, "meta").init_params().tree()
