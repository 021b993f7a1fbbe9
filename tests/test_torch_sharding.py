"""Port parity, tensor-parallel serving: ``repro_torch`` over
``torch.distributed`` against the JAX package's sharding rules and its
unsharded engines, on f32 ``paper_tiny`` (8 query heads, 4 KV heads).

* the port's rules (``distributed/sharding.py``) give JAX's spec for every
  parameter leaf (fp and prequantized) and every family's cache leaf, at
  tp = 1, 2 and 4 (JAX is given a stand-in mesh of ``shape`` and
  ``axis_names``, which its rules read);
* the placement (``serving/engine.shard_tree``) cuts JAX's shard shapes,
  with the fused qkv columns cut by heads;
* a tp = 1 mesh is the unsharded engine, bit for bit;
* two gloo ranks (``launch/mesh.spawn_tp``, one spawn a world size, every
  case in it) serve the static ``Engine`` with JAX's tokens and prefill
  logits within JAX's own tp bar (2e-4), the cushion block bit-identical on
  both ranks; int8-resident W8A8 gives the port's tp = 1 logits exactly
  (the row-parallel sites sum int32 accumulators); one tp = 4 case;
* the ``ContinuousEngine`` (contiguous fp, contiguous int8 with per-slot
  scales, paged int8) gives JAX's unsharded pool's tokens, and the ranks
  admit together when rank 1's clock runs three times as fast;
* ``decode_attention_tp`` / ``_tp_paged``, each rank's slice computed in one
  process, concatenate to JAX's ``flash_decode_ref``;
* the dry-run (``launch/dryrun.py``) counts, on its meta rank of a tp = 2
  mesh, the all-reduces and their bytes that a gloo rank of the same
  spawn issues for the same prefill and decode step;
* what is not sharded yet raises, citing the ROADMAP (the MoE, VLM and
  hybrid families and the axes that do not divide are served and held in
  ``test_torch_tp_families.py``);
* tensor-parallel training of the dense family, in the same spawn
  (``tests/_train_ref.py`` has the JAX side and the bars):
  ``shard_train_step`` on a (data 1, model 2) mesh, six steps of
  paper_tiny on test_torch_train.py's batches, against JAX's one-device
  ``make_train_step`` and the port's one rank, each cut to the rank's
  part: under ``none`` the first step's loss, CE and gradient norm within
  1e-5 relative (measured 0, 0 and 1.8e-7 against JAX), the parameters
  after six steps at the resume bar with the Adam allowance; under
  ``pt_dynamic``, ``ptoken_dynamic`` and ``pt_static`` ROADMAP queue 3's
  training bars (the loss 1e-3; the first step's first moment 5e-2 /
  3e-2 / 5e-2 of a leaf's largest entry: measured 2.2e-2 / 7.0e-3 /
  2.7e-2 against JAX); the ranks' metrics and whole leaves bit for bit;
  two reduced dense configs whose leaves a rank holds whole (the query
  heads do not divide, smollm-360m's case; the KV heads do not,
  deepseek-67b's at tp = 16): one step's first moment within 2e-6 of a
  leaf's largest entry of tp = 1's (measured 9.8e-7); ``prefix_tune
  (mesh=)`` at tp = 2 against JAX's one device at the method's bars; the
  dry-run's all-reduces of one train step on its meta rank equal a gloo
  rank's.
"""
import dataclasses
import types

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
from repro.core import quantization as JQ  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro.serving import ContinuousEngine as JContinuous  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import QuantConfig as TQuantConfig  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import quantization as TQ  # noqa: E402
from repro_torch.distributed import collectives as DC  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.serving.engine import (Engine, check_tp_serving,  # noqa: E402
                                        shard_tree, tp_config)
from repro_torch.serving.scheduler import ContinuousEngine  # noqa: E402
from _tp_probe import run_cases  # noqa: E402
import _train_ref as TRF  # noqa: E402

QN = QuantConfig()
QW8 = QuantConfig(mode="pt_static", true_int8=True)
TOL = 2e-4                # JAX's own tp bar (tests/test_sharding.py)
N_TOKENS = 10
# (name, qcfg, prequant, kv_dtype)
STATIC = [("none-fp", QN, False, None), ("none-int8", QN, False, "int8"),
          ("w8a8-fpw", QW8, False, None),
          ("w8a8-prequant-int8", QW8, True, "int8")]
# (name, kv_dtype, paged)
POOLS = [("fp", None, False), ("int8", "int8", False),
         ("paged-int8", "int8", True)]
BUDGETS = [5, 3, 6, 4]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def fake_mesh(tp):
    """JAX's stand-in mesh: its rules read only these two attributes."""
    return types.SimpleNamespace(shape={"data": 1, "tp": tp},
                                 axis_names=("data", "tp"))


@pytest.fixture(scope="module")
def ref():
    cfg = get_config("paper_tiny")
    japi = j_build(cfg)
    params = japi.init_params(jax.random.PRNGKey(0))
    cushion = japi.extract_cushion(params, jnp.asarray([1, 2, 3], jnp.int32),
                                   None, QN)
    cal = [japi.make_batch(jax.random.PRNGKey(100 + i), 2, 32)
           for i in range(2)]
    scales, _ = JCal.calibrate(japi, params, cal, QW8, cushion=cushion)
    batch = japi.make_batch(jax.random.PRNGKey(7), 2, 24)
    reqs = [JRequest(uid=i, batch=japi.make_batch(
        jax.random.PRNGKey(100 + i), 1, (20, 26)[i % 2]), max_new_tokens=n)
        for i, n in enumerate(BUDGETS)]
    return dict(cfg=cfg, japi=japi, params=params, cushion=cushion,
                scales=scales, batch=batch, reqs=reqs,
                np_params=np_tree(params), np_cushion=np_tree(cushion),
                np_scales=np_tree(JCal.scales_to_plain(scales)),
                tokens=np.asarray(batch["tokens"]))


def _jax_prefill_logits(eng, batch):
    with JSH.use_mesh(None):
        cache = eng._init_cache(batch["tokens"].shape[0])
        logits, _, _ = eng._prefill(eng.params, batch, cache)
    return np.asarray(logits[:, -1] if logits.ndim == 3 else logits)


def _case(ref, **kw):
    return dict(cfg=t_get_config("paper_tiny"), params=ref["np_params"],
                cushion=ref["np_cushion"], scales=ref["np_scales"],
                max_seq=128, **kw)


def _static_cases(ref):
    return [_case(ref, name=name, kind="static", qcfg=q, prequant=pq,
                  kv_dtype=kv, tokens=ref["tokens"], n_tokens=N_TOKENS,
                  logits=True)
            for name, q, pq, kv in STATIC]


def _pool_cases(ref):
    reqs = [dict(tokens=np.asarray(r.batch["tokens"]),
                 max_new_tokens=r.max_new_tokens) for r in ref["reqs"]]
    cases = [_case(ref, name=f"pool-{name}", kind="continuous", qcfg=QN,
                   kv_dtype=kv, paged=paged, page_size=32, n_slots=2,
                   requests=reqs)
             for name, kv, paged in POOLS]
    # arrivals 10 ms apart on a clock a rank owns, into a slot for each:
    # when each is admitted depends on the clock, and rank 1's runs three
    # times as fast as rank 0's
    timed = [dict(r, arrival_s=0.01 * i) for i, r in enumerate(reqs)]
    cases.append(_case(ref, name="clock", kind="continuous", qcfg=QN,
                       n_slots=4, requests=timed, clock_rates=[1.0, 3.0]))
    return cases


# the dry-run's collectives against a real rank's (launch/dryrun.py): the
# rank program of a prefill (B = 2, S = 24) and a decode step, fp and W8A8
# with int8-resident weights
COLLECTIVE_CASES = [("fp", QN, False), ("w8a8-prequant", QW8, True)]


def _collective_cases(ref):
    return [dict(name=f"collectives-{name}", kind="collectives",
                 cfg=t_get_config("paper_tiny"), params=ref["np_params"],
                 qcfg=q, prequant=pq, batch=2, seq=24)
            for name, q, pq in COLLECTIVE_CASES]


def _interrupt_case(ref):
    """The fp pool with a SIGINT sent to rank 1 alone after its second
    decode step."""
    case = _pool_cases(ref)[0]
    return dict(case, name="interrupt", interrupt=(1, 2))


# tensor-parallel training (the dense family): paper_tiny in every mode on
# test_torch_train.py's batches; two reduced dense configs whose leaves a
# rank holds whole at tp = 2: the query heads do not divide (smollm-360m's
# 15), or the KV heads do not (deepseek-67b's 8 at tp = 16)
TRAIN_MODES = ("none",) + tuple(TRF.QAT_TOL)
WHOLE = {"heads-whole": t_reduced(t_get_config("smollm-360m"),
                                  dtype="float32", n_layers=2, n_heads=3,
                                  n_kv_heads=1),
         "kv-whole": t_reduced(t_get_config("deepseek-67b"),
                               dtype="float32", n_layers=2, n_heads=4,
                               n_kv_heads=1)}
TUNE_MODES = {"none": QN, "pt_dynamic": QuantConfig(mode="pt_dynamic")}
TUNE_B, TUNE_S, TUNE_STEPS, LAM = 2, 24, 6, 0.1
# a cut activation's two halves (tp, 1, 3, 4): the max once in rank 0's
# channels and twice in rank 1's, -amin tying it in rank 0's, a channel
# max tied within rank 1's half
TIE = np.zeros((2, 1, 3, 4), np.float32)
TIE[:, 0, 0, 1] = 2.0
TIE[1, 0, 2, 3] = 2.0
TIE[0, 0, 1, 0] = -2.0
TIE[:, 0, 1, 2] = (0.5, -0.25)
TIE[1, 0, 0, 2] = TIE[1, 0, 2, 2] = -1.5


@pytest.fixture(scope="module")
def jtrain(ref):
    """JAX's training reference (``tests/_train_ref.py``) from ref's
    weights, and the batches."""
    tb = TRF.batches(ref["cfg"].vocab_size)
    return dict(tb=tb, **TRF.reference(ref["japi"], ref["params"],
                                       t_get_config("paper_tiny"), tb))


@pytest.fixture(scope="module")
def jtune(ref):
    """JAX's one-device prefix_tune in both modes from ref's cushion
    (test_torch_data_parallel.py's run), and the batches."""
    from repro.configs import CushionConfig
    from repro.core import cushioncache as JCC
    japi = ref["japi"]
    batches = [np_tree(japi.make_batch(jax.random.PRNGKey(3000 + i), TUNE_B,
                                       TUNE_S)) for i in range(TUNE_STEPS)]
    ccfg = CushionConfig(tune_steps=TUNE_STEPS, tune_lr=1e-3, lam=LAM,
                         log_every=3)
    return dict(batches=batches, runs={
        mode: JCC.prefix_tune(japi, ref["params"], ref["cushion"],
                              iter([jax.tree.map(jnp.asarray, b)
                                    for b in batches]), q, ccfg,
                              verbose=False)
        for mode, q in TUNE_MODES.items()})


def _train_cases(ref, jtrain, jtune):
    from repro_torch.configs import CushionConfig as TCushion
    base = dict(kind="train", batch_rows=TRF.B, seq=TRF.S, lr=1e-3,
                warmup=10, one_rank=True, first_moment=True)
    cases = [dict(base, name=f"train-{mode}", cfg=t_get_config("paper_tiny"),
                  params=ref["np_params"], batches=jtrain["tb"],
                  steps=TRF.STEPS, qcfg=TQuantConfig(mode=mode),
                  scales=jtrain["scales"] if mode == "pt_static" else None,
                  return_params=True)
             for mode in TRAIN_MODES]
    rs = np.random.RandomState(11)
    for name, cfg in WHOLE.items():
        tok = rs.randint(0, cfg.vocab_size, (2, 17)).astype(np.int32)
        cases.append(dict(base, name=f"train-{name}", cfg=cfg, seed=0,
                          steps=1, batches=[{"tokens": tok[:, :-1],
                                             "labels": tok[:, 1:]}],
                          return_params=True))
    ccfg = TCushion(tune_steps=TUNE_STEPS, tune_lr=1e-3, lam=LAM,
                    log_every=3)
    cases += [dict(kind="tune", name=f"tune-{mode}",
                   cfg=t_get_config("paper_tiny"), params=ref["np_params"],
                   cushion=ref["np_cushion"], batches=jtune["batches"],
                   qcfg=TQuantConfig(mode=mode), ccfg=ccfg)
              for mode in TUNE_MODES]
    cases.append(dict(kind="train_collectives", name="train-collectives",
                      cfg=t_get_config("paper_tiny"),
                      params=ref["np_params"], batch=2, seq=24))
    cases.append(dict(kind="range_tie", name="range-tie-tp", axis="tp",
                      x=TIE))
    return cases


@pytest.fixture(scope="module")
def tp2(ref, jtrain, jtune):
    """Every tp = 2 case in one spawn: {name: [rank 0's report, rank 1's]}."""
    cases = _static_cases(ref) + _pool_cases(ref) + [_interrupt_case(ref)] \
        + _collective_cases(ref) + _train_cases(ref, jtrain, jtune)
    outs = M.spawn_tp(run_cases, 2, cases, device="cpu", every_rank=True,
                      timeout_s=900)
    return {c["name"]: [o[i] for o in outs] for i, c in enumerate(cases)}


@pytest.fixture(scope="module")
def tp1(ref):
    """The same cases on one rank without a mesh, in this process."""
    cases = _static_cases(ref) + _pool_cases(ref)
    outs = run_cases(M.make_tp_mesh(1, device="cpu"),
                     [dict(c, mesh=False) for c in cases])
    return {c["name"]: o for c, o in zip(cases, outs)}


# ---------------------------------------------------------------------------
# 1. Specs
# ---------------------------------------------------------------------------

def _jax_param_specs(tree, mesh, rules=None):
    rules = JSH.serve_rules() if rules is None else rules
    paths = jax.tree_util.tree_leaves(JSH.tree_paths(tree))
    leaves = jax.tree_util.tree_leaves(tree)
    return {p: tuple(JSH.rules_pspec(p, x.shape, mesh, rules))
            for p, x in zip(paths, leaves)}


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


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("prequant", [False, True], ids=["fp", "prequant"])
def test_param_specs_equal_jax(ref, tp, prequant):
    jp = ref["params"]
    tp_tree = convert.params_from_numpy(ref["np_params"]).tree()
    if prequant:
        jp = JQ.prequantize_tree(jp, QW8)
        tp_tree = TQ.prequantize_tree(tp_tree, QW8)
    mesh = fake_mesh(tp)
    for rules, jrules in ((SH.serve_rules(), JSH.serve_rules()),
                          (SH.DEFAULT_RULES, JSH.DEFAULT_RULES)):
        assert _flat(SH.params_shardings(tp_tree, mesh, rules)) \
            == _jax_param_specs(jp, mesh, jrules)


FAMILIES = ("paper_tiny", "olmoe-1b-7b", "internvl2-26b", "jamba-v0.1-52b",
            "whisper-base", "xlstm-350m")


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("prequant", [False, True], ids=["fp", "prequant"])
@pytest.mark.parametrize("arch", FAMILIES[1:])
def test_param_specs_equal_jax_families(arch, tp, prequant):
    """``test_param_specs_equal_jax`` for the MoE, VLM, hybrid,
    encoder-decoder and xLSTM families (reduced, JAX's weights): every
    leaf's spec under the serve and the training rules, fp and
    prequantized."""
    jcfg = reduced(get_config(arch), dtype="float32")
    jp = j_build(jcfg).init_params(jax.random.PRNGKey(0))
    tp_tree = convert.params_from_numpy(np_tree(jp)).tree()
    if prequant:
        jp = JQ.prequantize_tree(jp, QW8)
        tp_tree = TQ.prequantize_tree(tp_tree, QW8)
    mesh = fake_mesh(tp)
    for rules, jrules in ((SH.serve_rules(), JSH.serve_rules()),
                          (SH.DEFAULT_RULES, JSH.DEFAULT_RULES)):
        assert _flat(SH.params_shardings(tp_tree, mesh, rules)) \
            == _jax_param_specs(jp, mesh, jrules)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_roles_and_specs_equal_jax(arch, tp):
    jcfg = get_config(arch)
    tcfg = t_get_config(arch)
    if arch != "paper_tiny":
        jcfg = reduced(jcfg, dtype="float32")
        tcfg = t_reduced(tcfg, dtype="float32")
    japi, api = j_build(jcfg), build(tcfg, "cpu")
    mesh = fake_mesh(tp)
    kvs = [None, "int8"] if arch in FAMILIES[:4] else [None]
    for kv in kvs:
        for per_slot in (False, True):
            roles = japi.cache_roles(kv, per_slot_scales=per_slot)
            assert api.cache_roles(kv, per_slot_scales=per_slot) == roles
            cache = jax.eval_shape(lambda: japi.init_cache(
                2, 64, kv_dtype=kv, **({"prefix_len": 3} if kv else {})))
            got = SH.cache_shardings(roles, cache, mesh)
            flat_c = jax.tree_util.tree_flatten_with_path(cache)[0]
            assert len(flat_c) == len(_flat(got))
            for kp, leaf in flat_c:
                keys = [k.key for k in kp]
                r, g = roles, got
                for k in keys:
                    r = r.get(k, ()) if isinstance(r, dict) else ()
                    g = g[k]
                assert g == tuple(JSH.roles_pspec(r, leaf.shape, mesh)), \
                    (arch, kv, keys)


def test_drop_indivisible_and_role_resolution():
    m2 = fake_mesh(2)
    assert SH.roles_pspec(("M",), (8,), m2) == ("tp",)
    assert SH.roles_pspec(("M",), (7,), m2) == (None,)
    assert SH.roles_pspec((None, "B", None, "M"), (4, 2, 64, 2), m2) \
        == (None, "data", None, "tp")
    for roles, shape in [(("M",), (8,)), (("M",), (7,)),
                         ((None, "B", None, "M"), (4, 2, 64, 2)),
                         ((None, "M"), (4, 6))]:
        for tp in (1, 2, 4):
            assert SH.roles_pspec(roles, shape, fake_mesh(tp)) == tuple(
                JSH.roles_pspec(roles, shape, fake_mesh(tp)))
    train = types.SimpleNamespace(shape={"data": 1, "model": 2},
                                  axis_names=("data", "model"))
    assert SH.to_pspec(("M", "B"), train) == ("model", "data")
    assert SH.to_pspec(("M", "B"), m2) == ("tp", "data")


# ---------------------------------------------------------------------------
# 2. Placement
# ---------------------------------------------------------------------------

def test_placement_shapes_and_heads(ref):
    cfg = t_get_config("paper_tiny")
    full = TQ.prequantize_tree(
        convert.params_from_numpy(ref["np_params"]).tree(), QW8)
    jspecs = _jax_param_specs(JQ.prequantize_tree(ref["params"], QW8),
                              fake_mesh(2))
    shards = [shard_tree(full, cfg, M.TPMesh(r, 2, None,
                                             torch.device("cpu"), None))
              for r in range(2)]
    flat_full = _flat(full)
    for r in range(2):
        flat = _flat(shards[r])
        assert set(flat) == set(jspecs)
        for p, spec in jspecs.items():
            shape = flat_full[p].shape
            spec = spec + (None,) * (len(shape) - len(spec))
            want = tuple(d // 2 if a == "tp" else d
                         for d, a in zip(shape, spec))
            assert tuple(flat[p].shape) == want, p
    attn = [s["layers"]["attn"] for s in shards]
    N = full["layers"]["attn"]["wqkv"]["w_int"].shape[-1]
    assert attn[0]["wqkv"]["w_int"].shape[-1] == N // 2
    assert attn[0]["wqkv"]["colsum"].shape[-1] == N // 2
    assert attn[0]["wo"]["colsum"].shape == \
        full["layers"]["attn"]["wo"]["colsum"].shape      # whole
    # the heads line up: a rank's split of its columns is its heads' split
    lcfg = tp_config(cfg, 2)
    q, k, v = TC._split_qkv(full["layers"]["attn"]["wqkv"]["w_int"], cfg)
    for r in range(2):
        lq, lk, lv = TC._split_qkv(attn[r]["wqkv"]["w_int"], lcfg)
        assert torch.equal(lq, q[..., 4 * r:4 * r + 4, :])
        assert torch.equal(lk, k[..., 2 * r:2 * r + 2, :])
        assert torch.equal(lv, v[..., 2 * r:2 * r + 2, :])
        lo = 4 * r * cfg.head_dim
        assert torch.equal(attn[r]["wo"]["w_int"],
                           full["layers"]["attn"]["wo"]["w_int"]
                           [:, lo:lo + 4 * cfg.head_dim])
        for lb, b, h in zip(TC._split_qkv(attn[r]["bqkv"], lcfg),
                            TC._split_qkv(full["layers"]["attn"]["bqkv"],
                                          cfg), (4, 2, 2)):
            assert torch.equal(lb, b[..., h * r:h * (r + 1), :])
        emb = full["embed"]["w"]
        assert torch.equal(shards[r]["embed"]["w"],
                           emb[256 * r:256 * (r + 1)])


# ---------------------------------------------------------------------------
# 3. A tp = 1 mesh is the unsharded engine
# ---------------------------------------------------------------------------

def test_trivial_tp1_mesh_matches_no_mesh(ref, tp1):
    cases = _static_cases(ref)
    outs = run_cases(M.make_tp_mesh(1, device="cpu"), cases)
    for c, o in zip(cases, outs):
        r = tp1[c["name"]]
        assert np.array_equal(o["logits"], r["logits"]), c["name"]
        assert np.array_equal(o["tokens"], r["tokens"]), c["name"]
        assert o["cushion"].keys() == r["cushion"].keys()
        for k in r["cushion"]:
            assert np.array_equal(o["cushion"][k], r["cushion"][k])


# ---------------------------------------------------------------------------
# 4. / 5. The static Engine at tp = 2 and 4 against JAX's unsharded one
# ---------------------------------------------------------------------------

def _jax_engine(ref, qcfg, prequant, kv):
    static = qcfg.mode == "pt_static"
    return JEngine(ref["japi"], ref["params"], qcfg, cushion=ref["cushion"],
                   scales=ref["scales"] if static else None, max_seq=128,
                   kv_dtype=kv, prequant=prequant)


def _check_cushion(rep, ref, rank, tp):
    """The cushion block on a rank: whole and bit-identical to the artifact
    in an int8 cache (its heads' slice beside it), the rank's heads in an
    fp cache's rows [0:m)."""
    want = {k: np.asarray(ref["cushion"]["kv"][k], np.float32)
            for k in ("k", "v")}
    n = want["k"].shape[2] // tp
    cu = rep["cushion"]
    if "kc" in cu:
        for c, k in (("kc", "k"), ("vc", "v")):
            np.testing.assert_array_equal(cu[c], want[k])
            if tp > 1:
                np.testing.assert_array_equal(
                    cu[c + "_tp"], want[k][:, :, n * rank:n * (rank + 1)])
    else:
        for c, k in (("k_rows", "k"), ("v_rows", "v")):
            local = want[k][:, :, n * rank:n * (rank + 1)]
            np.testing.assert_array_equal(
                cu[c], np.broadcast_to(local[:, None], cu[c].shape))


@pytest.mark.parametrize("name,qcfg,prequant,kv", STATIC,
                         ids=[s[0] for s in STATIC])
def test_tp2_engine_matches_jax(ref, tp2, tp1, name, qcfg, prequant, kv):
    jeng = _jax_engine(ref, qcfg, prequant, kv)
    want_logits = _jax_prefill_logits(jeng, ref["batch"])
    want = jeng.generate(ref["batch"], N_TOKENS).tokens
    ranks = tp2[name]
    for rank, rep in enumerate(ranks):
        assert rep["backend"] == "gloo"
        np.testing.assert_allclose(rep["logits"], want_logits, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(rep["tokens"], want)
        np.testing.assert_array_equal(rep["logits"], ranks[0]["logits"])
        _check_cushion(rep, ref, rank, 2)
    if prequant:
        # W8A8 with int32 sums at the row-parallel sites: exactly tp = 1
        np.testing.assert_array_equal(ranks[0]["logits"],
                                      tp1[name]["logits"])


@pytest.mark.parametrize("name,qcfg,prequant", COLLECTIVE_CASES,
                         ids=[c[0] for c in COLLECTIVE_CASES])
def test_dryrun_collectives_equal_a_real_rank(tp2, name, qcfg, prequant):
    """The dry-run's meta rank of a (data=1, tp=2) mesh counts the
    all-reduces, and their bytes, that each gloo rank issues for the same
    prefill and decode step (the other kinds: none on either side)."""
    from repro_torch.launch import dryrun as D
    mesh = M.dryrun_mesh((1, 2), ("data", "tp"))
    tq = TQuantConfig(mode=qcfg.mode, true_int8=qcfg.true_int8)
    for kind in ("prefill", "decode"):
        got = D.measure_program(D.serving_program(
            t_get_config("paper_tiny"), kind, 2, 24, mesh=mesh, qcfg=tq,
            prequant=prequant))["cost"]
        for rank in tp2[f"collectives-{name}"]:
            real = rank[kind]
            assert real["all-reduce"] > 0
            assert got.collective_counts == {
                **{k: 0 for k in got.collective_counts},
                "all-reduce": real["all-reduce"]}, (kind, rank["rank"])
            assert got.collective_bytes == real["bytes"], (kind,
                                                           rank["rank"])


# ---------------------------------------------------------------------------
# Tensor-parallel training of the dense family
# ---------------------------------------------------------------------------

def _whole_leaves_equal(ranks):
    """Across the ranks: the metrics and every entry held whole (a leaf's
    entries past its ``TPPart.own``) bit for bit."""
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
        n += 1
    return n


@pytest.mark.parametrize("mode", TRAIN_MODES)
def test_tp2_train_matches_jax_and_one_rank(jtrain, tp2, mode):
    """``shard_train_step`` on a (data 1, model 2) mesh, six steps of
    paper_tiny: against JAX's ``make_train_step`` on one device (the
    function GSPMD partitions) and the port's one-rank step, each cut to
    the rank's part. ``none``: the first step's loss, CE and gradient norm
    within 1e-5 relative, the parameters after six steps at the resume
    bar with the Adam allowance; the quantized modes: ROADMAP queue 3's
    training bars (the loss, and the first step's first moment of a
    leaf's largest entry). The ranks equal bit for bit where they hold the
    same thing."""
    cfg = t_get_config("paper_tiny")
    ranks = tp2[f"train-{mode}"]
    assert _whole_leaves_equal(ranks) >= 3          # the norms at least
    m0 = ranks[0]["metrics"][0]
    lrs = TRF.lr_sum()
    for r in ranks:
        assert r["collectives"][0] > 0
        one = r["one"]
        rel = {k: abs(m0[k] / one["metrics"][0][k] - 1)
               for k in ("loss", "ce", "grad_norm")}
        print(f"[{mode}] rank {r['tp_rank']} vs one rank, step 0: {rel}")
    if mode == "none":
        jm = jtrain["metrics"]
        rel = {k: abs(m0[k] / jm[0][k] - 1) for k in ("loss", "ce",
                                                       "grad_norm")}
        print(f"[none] tp 2 vs JAX, step 0, relative: {rel}")
        assert max(rel.values()) <= TRF.FIRST_STEP
        for m, j in zip(ranks[0]["metrics"], jm):
            assert m["lr"] == j["lr"]
        for r in ranks:
            TRF.assert_params_close(
                TRF.flat(r["params"]),
                TRF.cut(jtrain["params"], cfg, r["tp_rank"], 2), lrs,
                f"[none] rank {r['tp_rank']} vs JAX after six steps")
            for m, o in zip(r["metrics"], r["one"]["metrics"]):
                for k in ("loss", "ce", "grad_norm"):
                    np.testing.assert_allclose(m[k], o[k],
                                               rtol=TRF.FIRST_STEP)
            for path, d in r["one"]["diffs"].items():
                assert d["past"] <= TRF.ADAM_SHARE, path
                assert d["worst_past"] <= lrs, path
        return
    loss_tol, grad_tol = TRF.QAT_TOL[mode]
    jl, jmu = jtrain["qat"][mode]
    rel = abs(m0["loss"] / jl - 1)
    print(f"[{mode}] tp 2 vs JAX, step 0 loss relative {rel:.2e}")
    assert rel <= loss_tol
    for r in ranks:
        assert abs(m0["loss"] / r["one"]["metrics"][0]["loss"] - 1) \
            <= loss_tol
        TRF.leafwise(TRF.flat(r["mu1"]),
                     TRF.cut(jmu, cfg, r["tp_rank"], 2), TRF.flat(jmu),
                     grad_tol, f"[{mode}] rank {r['tp_rank']} vs JAX, "
                     f"first moment")
        want = TRF.flat(r["one"]["mu1"])
        TRF.leafwise(TRF.flat(r["mu1"]), want, want, grad_tol,
                     f"[{mode}] rank {r['tp_rank']} vs one rank")


@pytest.mark.parametrize("name", list(WHOLE))
def test_tp2_leaves_held_whole_take_tp1_gradients(tp2, name):
    """A leaf a rank holds whole gets the one-rank gradient (one step's
    first moment, 0.1 x the clipped gradient) within 2e-6 of its largest
    entry: where every rank computes the query heads whole, nothing is
    summed (a sum would double them); where a KV head's query heads lie on
    both ranks, its ``wqkv`` / ``bqkv`` columns are summed over tp (a
    missing sum would halve them)."""
    ranks = tp2[f"train-{name}"]
    part = ranks[0]["leaves"]["layers/attn/wqkv"]["part"]
    cfg = WHOLE[name]
    if name == "heads-whole":
        assert tuple(part) == (0, False)
    else:
        assert tuple(part) == (cfg.n_heads // 2 * cfg.head_dim, True)
    assert _whole_leaves_equal(ranks) > 0
    for r in ranks:
        want = TRF.flat(r["one"]["mu1"])
        TRF.leafwise(TRF.flat(r["mu1"]), want, want, TRF.WHOLE_LEAF,
                     f"[{name}] rank {r['tp_rank']} vs tp = 1")


@pytest.mark.parametrize("mode", list(TUNE_MODES))
def test_tp2_prefix_tune_matches_jax(ref, jtune, tp2, mode):
    """``prefix_tune(mesh=)`` on a model axis of two ranks against JAX's
    one device, at test_torch_data_parallel.py's method bars; the ranks'
    cushions equal after every step."""
    jtr, ranks = jtune["runs"][mode], tp2[f"tune-{mode}"]
    assert ranks[0]["fingerprint"] == ranks[1]["fingerprint"]
    for r in ranks:
        assert [x["step"] for x in r["log"]] == list(range(TUNE_STEPS))
        assert all(x["ranks_equal"] == 1.0 for x in r["log"])
    got = ranks[0]
    worst = {key: max(abs(a[key] / b[key] - 1)
                      for a, b in zip(got["log"], jtr.log))
             for key in ("loss", "ce", "range", "qerr", "gnorm")}
    print(f"[{mode}] tp 2 vs JAX, max relative log difference: {worst}")
    if mode == "none":
        assert max(worst.values()) < 1e-5
    else:
        first = {key: abs(got["log"][0][key] / jtr.log[0][key] - 1)
                 for key in ("ce", "range", "qerr")}
        print(f"[{mode}] step 0: {first}")
        assert first["ce"] < 1e-3 and max(first.values()) < 1e-2
        assert max(v for k, v in worst.items() if k != "gnorm") < 5e-2
        # the gradient norm within 0.2 (step 0: 1.6e-2, as one rank's;
        # step 4: 0.14): the range penalty's gradient sits on one element
        # of a site, its argmax, and the ranks' row-parallel sums flip a
        # code where one device's do not, so the trajectories part (at one
        # cushion, after four tp = 2 steps, tp = 2 and one rank's norms
        # differ by 0.7%)
        assert worst["gnorm"] < 0.2
    for k in ("k", "v"):
        a = got["cushion"]["kv"][k]
        want = np.asarray(jtr.cushion["kv"][k])
        move = np.abs(want - ref["np_cushion"]["kv"][k])
        print(f"[{mode}] tuned {k}: max |tp2 - JAX| "
              f"{np.abs(a - want).max():.2e}, mean / mean move "
              f"{np.abs(a - want).mean() / move.mean():.3f}")
        assert move.max() > 1e-3
        if mode == "none":
            np.testing.assert_allclose(a, want, rtol=0, atol=1e-6)
        else:
            assert np.abs(a - want).mean() < 0.25 * move.mean()


def test_extrema_gradients_of_a_cut_activation(tp2):
    """A cut activation's statistics over two ranks (each its channels):
    the range penalty's gradient and ``tp_extrema``'s go to the elements
    equal to the global value, divided by the global count of such
    elements, as ``jax.grad`` of the same function of the whole tensor
    gives it; the gathered channel maxima's as torch's autograd of the
    whole tensor on one rank (through |x| torch's rule: 0 at 0, where
    JAX's is 1)."""
    whole = np.concatenate([TIE[0], TIE[1]], axis=-1)       # (1, 3, 8)

    def jpen(a):
        return jnp.square(jnp.maximum(jnp.max(a), -jnp.min(a)))

    def jext(a):
        return jnp.min(a) + 2 * jnp.max(a)
    ranks = tp2["range-tie-tp"]
    got = {key: np.concatenate([r[key] for r in ranks], axis=-1)
           for key in ("grad", "extrema_grad", "channel_grad")}
    for key, fn in (("grad", jpen), ("extrema_grad", jext)):
        np.testing.assert_allclose(
            got[key], np.asarray(jax.grad(fn)(jnp.asarray(whole))), rtol=0,
            atol=1e-7, err_msg=key)
    t = torch.from_numpy(whole).requires_grad_()
    (t.abs().amax(dim=(0, 1)) * torch.arange(1.0, 9.0)).sum().backward()
    np.testing.assert_allclose(got["channel_grad"], t.grad.numpy(), rtol=0,
                               atol=1e-7)
    assert np.count_nonzero(np.asarray(jax.grad(jpen)(
        jnp.asarray(whole)))) == 4
    for r in ranks:
        assert (r["amin"], r["amax"]) == (-2.0, 2.0)
        np.testing.assert_array_equal(r["absmax_ch"],
                                      np.abs(whole).max(axis=(0, 1)))


def test_dryrun_train_collectives_equal_a_real_rank(tp2):
    """The dry-run's meta rank of a (data=1, model=2) mesh counts the
    all-reduces, and their bytes, that each gloo rank issues for the same
    train step (two microbatches of one row, the FSDP gather, the
    tensor-parallel collectives and their gradients, the clip's norm), and
    the kernels' launches of the step."""
    from repro_torch.launch import dryrun as D
    mesh = M.dryrun_mesh((1, 2), ("data", "model"))
    got = D.measure_program(D.train_program(t_get_config("paper_tiny"), 2,
                                            24, mesh=mesh))
    c = got["cost"]
    for rank in tp2["train-collectives"]:
        assert rank["all-reduce"] > 0
        assert c.collective_counts == {**{k: 0 for k in c.collective_counts},
                                       "all-reduce": rank["all-reduce"]}
        assert c.collective_bytes == rank["bytes"]
    # two microbatches, 4 layers, the forward twice with remat
    assert got["launches"] == {"flash_attention": 16,
                               "flash_attention_bwd": 8}


def test_tp4_engine_matches_jax(ref):
    case = _static_cases(ref)[0]            # none, fp KV
    outs = M.spawn_tp(run_cases, 4, [case], device="cpu", every_rank=True)
    jeng = _jax_engine(ref, QN, False, None)
    want_logits = _jax_prefill_logits(jeng, ref["batch"])
    want = jeng.generate(ref["batch"], N_TOKENS).tokens
    for rank, (rep,) in enumerate(outs):
        np.testing.assert_allclose(rep["logits"], want_logits, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(rep["tokens"], want)
        _check_cushion(rep, ref, rank, 4)


# ---------------------------------------------------------------------------
# 6. / 8. The ContinuousEngine at tp = 2; the ranks' clock decisions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pools(ref):
    out = {}
    for name, kv, paged in POOLS:
        ce = JContinuous(ref["japi"], ref["params"], QN, n_slots=2,
                         max_seq=128, cushion=ref["cushion"], kv_dtype=kv,
                         paged=paged, page_size=32)
        out[name] = {o.uid: o.tokens for o in ce.run(ref["reqs"])}
    return out


@pytest.mark.parametrize("name,kv,paged", POOLS, ids=[p[0] for p in POOLS])
def test_tp2_continuous_matches_jax(ref, tp2, jax_pools, name, kv, paged):
    cfg = ref["cfg"]
    want = jax_pools[name]
    cu = {k: np.asarray(ref["cushion"]["kv"][k], np.float32)
          for k in ("k", "v")}
    for rank, rep in enumerate(tp2[f"pool-{name}"]):
        assert sorted(rep["tokens"]) == sorted(want)
        for uid in want:
            np.testing.assert_array_equal(rep["tokens"][uid], want[uid])
        assert rep["stats"]["recycles"] >= 1
        assert rep["admissions"] == tp2[f"pool-{name}"][0]["admissions"]
        if kv is not None:
            assert rep["k_scale_shape"] == (cfg.n_layers, 2,
                                            cfg.n_kv_heads // 2)
            np.testing.assert_array_equal(rep["cushion"]["kc"], cu["k"])
            np.testing.assert_array_equal(
                rep["cushion"]["kc_tp"], cu["k"][:, :, 2 * rank:2 * rank + 2])
        else:
            # every slot's rows [0:m), recycled ones included, are the
            # rank's heads of the cushion
            local = cu["k"][:, :, 2 * rank:2 * rank + 2]
            rows = rep["slot_rows"]
            for s in range(rows.shape[1]):
                np.testing.assert_array_equal(rows[:, s], local)


def test_interrupt_on_one_rank_drains_every_rank(tp2):
    """ctrl-C on rank 1 alone is read at the top of the loop on every rank
    (a max over the ranks' flags): both stop admitting, finish the live
    slots with the uninterrupted run's tokens and drop the queue, where
    rank 1 alone draining would leave the ranks in different
    collectives."""
    full = tp2["pool-fp"][0]["tokens"]
    ranks = tp2["interrupt"]
    for rep in ranks:
        assert rep["stats"]["interrupted"]
        assert rep["admissions"] == ranks[0]["admissions"]
        assert sorted(rep["tokens"]) == sorted(ranks[0]["tokens"])
        assert 0 < len(rep["tokens"]) < len(full)
        for uid, toks in rep["tokens"].items():
            np.testing.assert_array_equal(toks, full[uid])


def test_ranks_take_rank0_clock_decisions(ref, tp2, tp1, jax_pools):
    ranks = tp2["clock"]
    # alone, rank 1's faster clock admits on another schedule
    alone = run_cases(M.make_tp_mesh(1, device="cpu"), [dict(
        _pool_cases(ref)[-1], mesh=False, clock_rates=[3.0])])[0]
    assert alone["admissions"] != tp1["clock"]["admissions"]
    for rep in ranks:
        assert rep["admissions"] == tp1["clock"]["admissions"]
        for uid, toks in jax_pools["fp"].items():
            np.testing.assert_array_equal(rep["tokens"][uid], toks)


# ---------------------------------------------------------------------------
# 7. decode_attention_tp / decode_attention_tp_paged
# ---------------------------------------------------------------------------

B, K, G, HD, SMAX, MC = 2, 4, 2, 16, 64, 8


def _decode_operands(quantized):
    rs = np.random.RandomState(5)
    q = rs.randn(B, K * G, HD).astype(np.float32)
    pos = np.asarray([33, -1], np.int32)
    if not quantized:
        k = rs.randn(B, SMAX, K, HD).astype(np.float32)
        v = rs.randn(B, SMAX, K, HD).astype(np.float32)
        return dict(q=q, k=k, v=v, pos=pos)
    return dict(q=q, pos=pos,
                k=rs.randint(-127, 128, (B, SMAX, K, HD)).astype(np.int8),
                v=rs.randint(-127, 128, (B, SMAX, K, HD)).astype(np.int8),
                k_scale=rs.rand(K).astype(np.float32) * 0.05 + 0.01,
                v_scale=rs.rand(K).astype(np.float32) * 0.05 + 0.01,
                kc=rs.randn(MC, K, HD).astype(np.float32),
                vc=rs.randn(MC, K, HD).astype(np.float32))


def _rank_slices(o, r, tp):
    """Rank r's operands: its query heads, KV heads and scales; the cushion
    block stays whole (decode_attention_tp slices it)."""
    Hl, Kl = K * G // tp, K // tp
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in o.items()}
    out = dict(q=t["q"][:, r * Hl:(r + 1) * Hl].contiguous(),
               k=t["k"][:, :, r * Kl:(r + 1) * Kl].contiguous(),
               v=t["v"][:, :, r * Kl:(r + 1) * Kl].contiguous(),
               pos=t["pos"])
    if "k_scale" in t:
        out.update(k_scale=t["k_scale"][r * Kl:(r + 1) * Kl].contiguous(),
                   v_scale=t["v_scale"][r * Kl:(r + 1) * Kl].contiguous(),
                   kc=t["kc"], vc=t["vc"])
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
def test_decode_attention_tp_matches_jax_oracle(quantized, paged):
    o = _decode_operands(quantized)
    kw = {k: jnp.asarray(o[k]) for k in ("k_scale", "v_scale", "kc", "vc")
          if k in o}
    want = np.asarray(R.flash_decode_ref(jnp.asarray(o["q"]),
                                         jnp.asarray(o["k"]),
                                         jnp.asarray(o["v"]),
                                         jnp.asarray(o["pos"]), **kw))
    tp = 2
    parts = []
    for r in range(tp):
        s = _rank_slices(o, r, tp)
        mesh = M.TPMesh(r, tp, None, torch.device("cpu"), None)
        extra = {k: s[k] for k in ("k_scale", "v_scale", "kc", "vc")
                 if k in s}
        if paged:
            # each row's positions on pages 1.. of 8 rows, in reverse
            ps = 8
            P = SMAX // ps
            table = torch.zeros((B, P), dtype=torch.int32)
            pages = {n: torch.zeros((1 + B * P, ps) + s[n].shape[2:],
                                    dtype=s[n].dtype) for n in ("k", "v")}
            for b in range(B):
                for j in range(P):
                    phys = 1 + b * P + (P - 1 - j)
                    table[b, j] = phys
                    for n in ("k", "v"):
                        pages[n][phys] = s[n][b, j * ps:(j + 1) * ps]
            out = ops.decode_attention_tp_paged(
                s["q"], pages["k"], pages["v"], table, s["pos"], mesh,
                **extra)
        else:
            out = ops.decode_attention_tp(s["q"], s["k"], s["v"], s["pos"],
                                          mesh, **extra)
        parts.append(out)
    got = torch.cat(parts, dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# 9. Refusals
# ---------------------------------------------------------------------------

def _mesh2():
    return M.TPMesh(0, 2, None, torch.device("cpu"), None)


@pytest.mark.parametrize("arch,qcfg,paged,match", [
    ("whisper-base", QW8, False, "lm_head without site scales"),
    ("whisper-base", QN, True, "nothing to page"),
    ("xlstm-350m", QN, True, "nothing to page"),
], ids=["encdec-pt_static", "encdec-paged", "xlstm-paged"])
def test_unsharded_cases_refuse(arch, qcfg, paged, match):
    """What tensor parallelism refuses for the encoder-decoder and the
    xLSTM at tp = 2 is what one rank refuses too, the reason named before
    any collective: the encoder-decoder's ``pt_static`` (the reference's
    serving head takes no scales) and a paged pool of either family (per
    -request state, nothing to page). Every family serves otherwise
    (``test_torch_tp_families.py`` holds them to JAX), and so do the
    dynamic modes and W4A8 (``test_torch_replica_tp.py``)."""
    cfg = t_reduced(t_get_config(arch), dtype="float32")
    api = build(cfg, "cpu")
    params = api.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match=match):
        if paged:
            ContinuousEngine(api, params, qcfg, paged=True, page_size=32,
                             max_seq=64, mesh=_mesh2())
        else:
            Engine(api, params, qcfg, mesh=_mesh2())
    with pytest.raises(ValueError, match=match):
        check_tp_serving(cfg, qcfg, 2, paged=paged)
    check_tp_serving(cfg, qcfg, 1, paged=False)


def test_unsharded_weight_groups_stop_the_run():
    """A fake-quantized weight group that straddles a rank's rows of a
    row-parallel site (item 6.4b) raises ``NotImplementedError``, not
    ``ValueError``: a continuous pool reads a ValueError at admission as a
    request that can never fit and drops it, where this refusal must stop
    the run (reduced whisper's ``w_down``, 64 rows a rank of tp = 2 under
    groups of 128)."""
    w = torch.randn((64, 8))
    with DC.use_tp(types.SimpleNamespace(size=2, rank=0)):
        with pytest.raises(NotImplementedError, match=r"item 6\.4b"):
            TQ.weight_fake_quant(w, TQuantConfig(mode="pt_dynamic"),
                                 row_parallel=True)
        # a whole group of the rank's rows is served
        TQ.weight_fake_quant(torch.randn((256, 8)),
                             TQuantConfig(mode="pt_dynamic"),
                             row_parallel=True)


@pytest.mark.parametrize("qcfg,wb", [
    (QuantConfig(mode="pt_dynamic", true_int8=True), 8),
    (QuantConfig(mode="ptoken_dynamic"), 8),
    (QW8, 4),
], ids=["pt_dynamic", "ptoken_dynamic", "w4a8"])
def test_dynamic_modes_and_w4a8_shard(qcfg, wb):
    """The dynamic modes and W4A8 pass ``check_tp_serving`` at tp = 2; a
    W4A8 tree's rank shard cuts ``w_packed`` by columns at the
    column-parallel sites (``wqkv``, ``w_up``: its group scales and scaled
    column sums with it) and by whole groups of rows at the row-parallel
    ones (``wo``, ``w_down``: the group scales and column sums whole, as
    the reference keeps them)."""
    cfg = t_get_config("paper_tiny")
    check_tp_serving(cfg, qcfg, 2, wb)
    if wb != 4:
        return
    api = build(cfg, "cpu")
    tree = TQ.prequantize_tree(
        api.init_params(torch.Generator().manual_seed(0)).tree(), qcfg,
        weight_bits=4)
    r1 = shard_tree(tree, cfg, types.SimpleNamespace(rank=1, size=2))
    for key, rows in (("attn", "wo"), ("mlp", "w_down")):
        w, got = tree["layers"][key][rows], r1["layers"][key][rows]
        Kp = w["w_packed"].shape[-2]
        assert torch.equal(got["w_packed"], w["w_packed"][..., Kp // 2:, :])
        assert torch.equal(got["w_scale"], w["w_scale"])
        assert torch.equal(got["colsum"], w["colsum"])
    w, got = tree["layers"]["mlp"]["w_up"], r1["layers"]["mlp"]["w_up"]
    n = w["w_packed"].shape[-1] // 2
    assert torch.equal(got["w_packed"], w["w_packed"][..., n:])
    assert torch.equal(got["w_scale"], w["w_scale"][..., n:])
    assert torch.equal(got["colsum"], w["colsum"][..., n:])
    assert got["w_scale"].shape[-2] == w["w_scale"].shape[-2]


def test_indivisible_heads_replicas_and_data_refuse():
    """Axes that do not divide are served whole (``paper_tiny`` at tp = 3
    in ``test_torch_tp_families.py``); what still raises: a rank whose
    query heads straddle the groups of whole KV heads (H = 12, K = 4 at
    tp = 3), replicas outside the continuous mode, ``serve.py --tp`` on
    what one rank refuses (an xLSTM paged pool, the encoder-decoder's
    pt_static), a data axis on one engine, replica meshes outside a
    spawn."""
    api = build(t_get_config("paper_tiny"), "cpu")
    params = api.init_params(torch.Generator().manual_seed(0))
    straddle = dataclasses.replace(t_get_config("paper_tiny"), n_heads=12,
                                   n_kv_heads=4, d_head=48, d_model=576)
    with pytest.raises(ValueError, match=r"ROADMAP queue 1, item 6\.5b"):
        check_tp_serving(straddle, QN, 3)
    with pytest.raises(SystemExit):
        # the router fronts ContinuousEngine replicas (--replicas 2 --tp 2
        # --mode continuous serves: test_torch_replica_tp.py)
        serve.main(["--device", "cpu", "--tp", "2", "--replicas", "2"])
    # what one rank refuses stops before the ranks spawn
    with pytest.raises(SystemExit, match="nothing to page"):
        serve.main(["--device", "cpu", "--tp", "2", "--arch",
                    "xlstm-350m", "--mode", "continuous", "--paged"])
    with pytest.raises(SystemExit, match="lm_head without site scales"):
        serve.main(["--device", "cpu", "--tp", "2", "--arch",
                    "whisper-base", "--mode", "continuous", "--quant",
                    "pt_static"])
    # a (data=2, tp=2) mesh is made inside the ranks of spawn_mesh; an
    # engine refuses a mesh with a data axis (the reference never serves on
    # one: its data-parallel serving is the router's replicas)
    with pytest.raises(RuntimeError, match="spawn_mesh"):
        M.make_tp_mesh(2, data=2)
    with pytest.raises(ValueError, match="router's replicas"):
        Engine(api, params, QN,
               mesh=M.TPMesh(0, 1, None, torch.device("cpu"), None,
                             data_rank=0, data_size=2))
    with pytest.raises(RuntimeError, match="spawn_mesh"):
        M.make_replica_meshes(2, tp=2)
    # the reference's production meshes need 256 or 512 devices; the
    # message names the dry-run's mesh, not the reference's XLA flag
    with pytest.raises(RuntimeError, match=r"need 256 devices for mesh "
                       r"\(16, 16\); have 1\. The dry-run runs one rank of "
                       r"it on meta tensors: dryrun_mesh\(\(16, 16\), "
                       r"\('data', 'model'\)\)") as err:
        M.make_production_mesh()
    assert "XLA_FLAGS" not in str(err.value)
    with pytest.raises(RuntimeError, match=r"need 512 devices.*"
                       r"dryrun_mesh\(\(2, 16, 16\)"):
        M.make_production_mesh(multi_pod=True)
