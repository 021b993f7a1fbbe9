"""Port parity, data parallelism over a (data, tp) rank mesh: ``prefix_tune
(mesh=)``, ``shard_train_step`` with FSDP shards, ``compressed_psum`` and
``dp_train_step_compressed``, the range penalty's gradient at a tie that
spans ranks, the refusals, ``launch/tune.py --dp`` and ``--smoke``, and
``launch/serve.py``'s ``--ckpt-dir``, ``--smoke`` and ``--calib-batches``,
against the JAX package on the CPU.

Two gloo ranks (``launch/mesh.spawn_mesh``, one spawn for the module) run
every case of ``tests/_dp_probe.py``; the JAX references run in this
process on one device (the reference's ``--dp`` artifact is bit-identical
to its one device's), except ``compressed_psum``, which
needs a two-device JAX mesh and runs in a subprocess with
``--xla_force_host_platform_device_count=2``.

Tolerances, measured on the CPU (``pytest -s`` prints them):

* ``prefix_tune``, paper_tiny f32, six steps on test_torch_tune.py's
  batches (B = 2 x 24, one row a rank): ROADMAP queue 3's method bars.
  Under ``none`` every logged metric within 1e-5 relative of JAX's
  (measured 1.6e-6) and the tuned cushion within 1e-6 per element (2.4e-7;
  the ranks sum CE and the penalty's counts in another order than one
  device). Under ``pt_dynamic`` step 0's CE within 1e-3 and L_q and range
  within 1e-2 (2.3e-4 and 6.7e-3), the six steps' logs within 5e-2 (1.6e-2),
  the mean |port - JAX| of the cushion below a quarter of its mean move
  (test_torch_tune.py's bars: the reference disagrees with itself there).
  Port dp 2 against port dp 1: the logs within 1e-5 relative (1.6e-7) and
  the cushion within 1e-6 (0 measured) in both modes: a global range is
  the one device's exactly (max and min are exact in any order), and only
  the sums' order differs.
* ``shard_train_step``, paper_tiny f32, six steps on test_torch_train.py's
  batches (the launcher's pipeline, B = 2 x 32, one row a rank) against
  JAX's ``make_train_step`` on one device: test_torch_train.py's bars (the
  first step's loss, CE and gradient norm within 1e-6 relative, measured
  8.8e-8; the parameters after six steps at the resume bar, rtol 1e-5 and
  atol 1e-6, but for at most 1e-4 of a leaf's elements, each within the
  summed learning rate); rank 0's one-rank ``make_train_step`` within the
  same bars.
* ``compressed_psum``: within one f32 ulp of the reference's output, the
  int32 code sums equal, within ``amax / 127 + 1e-6`` of the exact mean
  (the reference test's bound), every rank equal.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CushionConfig, QuantConfig, get_config  # noqa: E402
from repro.configs import RunConfig as JRun  # noqa: E402
from repro.core import cushioncache as JCC  # noqa: E402
from repro.core import outliers as JOUT  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch import tune as jtune  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.checkpoint.store import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import cushioncache as TCC  # noqa: E402
from repro_torch.data.pipeline import Pipeline, SyntheticCorpus  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch import tune  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402
from _dp_probe import run_cases  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
QN = QuantConfig(mode="none")
QD = QuantConfig(mode="pt_dynamic")
QMODES = {"none": QN, "pt_dynamic": QD}
# the port's configs for the ranks (which import nothing of the reference)
T_QMODES = {m: TCfg.QuantConfig(mode=m) for m in QMODES}
LAM = 0.1
TUNE_B, TUNE_S, TUNE_STEPS = 2, 24, 6
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 32, 6
RESUME = dict(rtol=1e-5, atol=1e-6)
ADAM_SHARE = 1e-4
# the launcher runs: a small search and four tuning steps
TUNE_ARGS = ["--device", "cpu", "--arch", "paper_tiny", "--max-prefix-len",
             "3", "--candidates", "16", "--sample-len", "16", "--steps", "4",
             "--log-every", "2", "--seq-len", "16", "--eval-batches", "1",
             "--batch", "2"]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree, prefix=""):
    """{path: array} of a nested dict / list tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree, dtype=np.float32)}


@pytest.fixture(scope="module")
def ref():
    """JAX's paper_tiny params, cushion and batches, its single-device
    tuning in both modes and its single-device train steps."""
    jcfg = get_config("paper_tiny")
    japi = j_build(jcfg)
    jp = japi.init_params(jax.random.PRNGKey(0))
    jcush = japi.extract_cushion(jp, jnp.asarray([1, 2, 3], jnp.int32),
                                 None, QN)
    batches = [np_tree(japi.make_batch(jax.random.PRNGKey(3000 + i), TUNE_B,
                                       TUNE_S)) for i in range(TUNE_STEPS)]
    ccfg = CushionConfig(tune_steps=TUNE_STEPS, tune_lr=1e-3, lam=LAM,
                         log_every=3)
    jtr = {mode: JCC.prefix_tune(japi, jp, jcush,
                                 iter([jax.tree.map(jnp.asarray, b)
                                       for b in batches]), q, ccfg,
                                 verbose=False)
           for mode, q in QMODES.items()}
    # test_torch_train.py's batches: the launcher's pipeline
    pipe = Pipeline(SyntheticCorpus(jcfg.vocab_size, seed=0), batch=TRAIN_B,
                    seq_len=TRAIN_S, seed=0)
    tbatches = [pipe.get_batch(i) for i in range(TRAIN_STEPS)]
    run = JRun(model=jcfg, quant=QN, seq_len=TRAIN_S, global_batch=TRAIN_B,
               lr=1e-3, train_steps=12, warmup_steps=10)
    opt = JT.make_optimizer(run)
    step = jax.jit(JT.make_train_step(japi, run, opt))
    p, s = jp, opt.init(jp)
    jmetrics = []
    for b in tbatches:
        p, s, m = step(p, s, jax.tree.map(jnp.asarray, b))
        jmetrics.append({k: float(v) for k, v in m.items()})
    return dict(jcfg=jcfg, japi=japi, jp=jp, np_params=np_tree(jp),
                jcush=jcush, np_cush=np_tree(jcush), batches=batches,
                ccfg=ccfg, jtr=jtr, tbatches=tbatches, jtrain=jmetrics,
                jtrain_params=np_tree(p))


def _tie():
    """(2, 1, 3, 4): the max once on rank 0 and twice on rank 1, -amin
    tying it on rank 0."""
    tie = np.zeros((2, 1, 3, 4), np.float32)
    tie[:, 0, 0, 1] = 2.0
    tie[1, 0, 2, 3] = 2.0
    tie[0, 0, 1, 0] = -2.0
    tie[:, 0, 1, 2] = (0.5, -0.25)
    return tie


COMPRESSED_X = np.random.RandomState(3).randn(2, 256).astype(np.float32) * 3
DP_PARAMS = np.random.RandomState(0).randn(8, 4).astype(np.float32)
DP_BATCH = np.random.RandomState(1).randn(4, 8).astype(np.float32)


def _cases(ref):
    cfg = t_get_config("paper_tiny")
    base = dict(cfg=cfg, params=ref["np_params"])
    ccfg = TCfg.CushionConfig(tune_steps=TUNE_STEPS, tune_lr=1e-3, lam=LAM,
                              log_every=3)
    return [
        *[dict(base, kind="tune", name=f"tune_{mode}", qcfg=q,
               cushion=ref["np_cush"], batches=ref["batches"], ccfg=ccfg)
          for mode, q in T_QMODES.items()],
        dict(base, kind="train", name="train", batches=ref["tbatches"],
             batch_rows=TRAIN_B, seq=TRAIN_S, steps=TRAIN_STEPS, lr=1e-3,
             warmup=10, return_params=True, one_rank=True),
        dict(kind="compressed", name="compressed", x=COMPRESSED_X),
        dict(kind="dp_step", name="dp_step", params=DP_PARAMS,
             batch=DP_BATCH),
        dict(kind="range_tie", name="range_tie", x=_tie()),
        dict(kind="refuse", name="refuse",
             cfg=t_reduced(t_get_config("olmoe-1b-7b"), dtype="float32",
                           n_layers=1)),
    ]


@pytest.fixture(scope="module")
def dp2(ref):
    """Every case on two gloo ranks: {name: [rank 0's, rank 1's]}."""
    cases = _cases(ref)
    outs = M.spawn_mesh(run_cases, 2, 1, cases, device="cpu",
                        every_rank=True, timeout_s=600)
    return {c["name"]: [r[i] for r in outs] for i, c in enumerate(cases)}


@pytest.fixture(scope="module")
def dp1(ref):
    """The tuning cases on one rank, without a process group."""
    cases = [c for c in _cases(ref) if c["kind"] == "tune"]
    outs = run_cases(M.make_tp_mesh(1, device="cpu"), cases)
    return {c["name"]: o for c, o in zip(cases, outs)}


@pytest.mark.parametrize("mode", list(QMODES))
def test_prefix_tune_dp2_matches_jax(ref, dp2, mode):
    """Six tuning steps over two ranks (2 rows each) against JAX's one
    device on the whole 4-row batches."""
    jtr, ranks = ref["jtr"][mode], dp2[f"tune_{mode}"]
    assert ranks[0]["fingerprint"] == ranks[1]["fingerprint"]
    for r in ranks:
        assert [x["step"] for x in r["log"]] == list(range(TUNE_STEPS))
        assert all(x["ranks_equal"] == 1.0 for x in r["log"])
        for k in ("k", "v"):
            np.testing.assert_array_equal(r["cushion"]["kv"][k],
                                          ranks[0]["cushion"]["kv"][k])
    got = ranks[0]
    worst = {key: max(abs(a[key] / b[key] - 1)
                      for a, b in zip(got["log"], jtr.log))
             for key in ("loss", "ce", "range", "qerr", "gnorm")}
    print(f"[{mode}] dp 2 vs JAX, max relative log difference: {worst}")
    if mode == "none":
        assert max(worst.values()) < 1e-5
    else:
        first = {key: abs(got["log"][0][key] / jtr.log[0][key] - 1)
                 for key in ("ce", "range", "qerr")}
        print(f"[{mode}] step 0: {first}")
        assert first["ce"] < 1e-3 and max(first.values()) < 1e-2
        assert max(worst.values()) < 5e-2
    for k in ("k", "v"):
        a = got["cushion"]["kv"][k]
        want = np.asarray(jtr.cushion["kv"][k])
        move = np.abs(want - ref["np_cush"]["kv"][k])
        print(f"[{mode}] tuned {k}: max |dp2 - JAX| "
              f"{np.abs(a - want).max():.2e}, mean / mean move "
              f"{np.abs(a - want).mean() / move.mean():.3f}")
        assert move.max() > 1e-3
        if mode == "none":
            np.testing.assert_allclose(a, want, rtol=0, atol=1e-6)
        else:
            assert np.abs(a - want).mean() < 0.25 * move.mean()


@pytest.mark.parametrize("mode", list(QMODES))
def test_prefix_tune_dp2_matches_dp1(dp2, dp1, mode):
    """Port dp 2 against port dp 1 from the same cushion on the same
    batches; each rank keeps the host-sync bound (6 steps, log_every 3:
    at most 3 transfers)."""
    two, one = dp2[f"tune_{mode}"], dp1[f"tune_{mode}"]
    worst = max(abs(a[key] / b[key] - 1) for a, b in zip(two[0]["log"],
                                                         one["log"])
                for key in ("loss", "ce", "range", "qerr", "gnorm"))
    diff = max(np.abs(two[0]["cushion"]["kv"][k]
                      - one["cushion"]["kv"][k]).max() for k in ("k", "v"))
    print(f"[{mode}] dp 2 vs dp 1: logs {worst:.2e} relative, cushion "
          f"{diff:.2e}")
    assert worst < 1e-5
    assert diff <= 1e-6
    for r in two:
        assert r["host_syncs"] <= TUNE_STEPS / 3 + 1


def _assert_params_close(got, want, total_lr):
    """test_torch_train.py's bar: the resume bar for all but ADAM_SHARE of
    the tree's elements, those within the summed learning rate (Adam's
    first update of an element whose gradient lies within the sides'
    rounding of zero is decided by its last bits; test_torch_train.py's
    one-device run has 40 such elements of 3.41 M, so a leaf of 2,048 may
    hold one: the share is the tree's, where test_torch_train.py takes a
    leaf's)."""
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    n_bad, worst_bad, worst = 0, 0.0, 0.0
    for path in w:
        err = np.abs(g[path] - w[path])
        bad = err > RESUME["atol"] + RESUME["rtol"] * np.abs(w[path])
        n_bad += int(bad.sum())
        if bad.any():
            print(f"{path}: {int(bad.sum())} of {bad.size} past, by "
                  f"{err[bad].max():.3g}")
            worst_bad = max(worst_bad, float(err[bad].max()))
        worst = max(worst, float(err[~bad].max(initial=0.0)))
    assert n_bad <= ADAM_SHARE * sum(a.size for a in w.values())
    assert worst_bad <= total_lr
    print(f"params: max |dp2 - JAX| {worst:.3g} within the bar; {n_bad} "
          f"past it by up to {worst_bad:.3g}")


def test_shard_train_step_matches_jax(ref, dp2):
    """Six FSDP steps over two ranks (one row each) against JAX's
    make_train_step on one device; rank 0's own one-rank make_train_step
    agrees too."""
    r0, r1 = dp2["train"]
    for m0, m1, jm in zip(r0["metrics"], r1["metrics"], ref["jtrain"]):
        assert m0 == m1
        assert m0["lr"] == jm["lr"]
    print("dp 2 vs JAX, relative, a step:", [
        {k: f"{abs(m[k] / jm[k] - 1):.2e}" for k in ("loss", "grad_norm")}
        for m, jm in zip(r0["metrics"], ref["jtrain"])])
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(r0["metrics"][0][k], ref["jtrain"][0][k],
                                   rtol=1e-6, err_msg=k)
    lrs = sum(m["lr"] for m in ref["jtrain"])
    _assert_params_close(r0["params"], ref["jtrain_params"], lrs)
    for k in flat(r0["params"]):
        np.testing.assert_array_equal(flat(r0["params"])[k],
                                      flat(r1["params"])[k])
    for m, o in zip(r0["metrics"], r1["one"]["metrics"]):
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(m[k], o[k], rtol=1e-6)
    for path, d in r1["one"]["diffs"].items():
        assert d["past"] <= ADAM_SHARE and d["worst_past"] <= lrs, path


def test_shard_train_step_keeps_only_its_shards(ref, dp2):
    """Each rank holds the data shard of every "D" leaf and the f32 moments
    of that shard (ZeRO-1): the specs' arithmetic."""
    r0 = dp2["train"][0]
    specs = flat_specs(r0["specs"])
    arrays = flat(ref["np_params"])
    want = sum(a.size * 4 // (2 if "data" in specs[p] else 1)
               for p, a in arrays.items())
    n_sharded = sum("data" in s for s in specs.values())
    assert n_sharded >= len(specs) // 2
    for r in dp2["train"]:
        assert r["full_bytes"] == sum(a.size * 4 for a in arrays.values())
        assert r["shard_bytes"] == want
        assert r["moment_bytes"] == 2 * want
    print(f"a rank holds {want} of {r0['full_bytes']} parameter bytes "
          f"({n_sharded} of {len(specs)} leaves sharded)")
    assert want < 0.55 * r0["full_bytes"]


def flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_specs(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat_specs(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree)}


_JAX_COMPRESSED = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed.collectives import compressed_psum
from repro.distributed.sharding import shard_map_compat
x = jnp.asarray(np.asarray(json.loads(sys.stdin.read()), np.float32))
mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
f = shard_map_compat(lambda v: compressed_psum(v, "data"), mesh,
                     in_specs=P("data"), out_specs=P("data"))
print(json.dumps(np.asarray(jax.jit(f)(x)).tolist()))
"""


def test_compressed_psum_matches_reference(dp2):
    """Two ranks' compressed_psum against the reference's on a two-device
    JAX mesh, in a subprocess."""
    x = COMPRESSED_X
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    out = subprocess.run([sys.executable, "-c", _JAX_COMPRESSED],
                         input=json.dumps(x.tolist()), capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    want = np.asarray(json.loads(out.stdout), np.float32)     # (2, 256)
    r0, r1 = dp2["compressed"]
    np.testing.assert_array_equal(r0["out"], r1["out"])
    np.testing.assert_array_equal(r0["acc"], r1["acc"])
    assert r0["n"] == 2 and r0["scale"] == r1["scale"]
    ulp = np.spacing(np.abs(want[0]).astype(np.float32))
    err = np.abs(r0["out"] - want[0])
    print(f"compressed_psum: max |port - JAX| / ulp "
          f"{(err / ulp).max():.2f}")
    assert (err <= ulp).all()
    np.testing.assert_array_equal(want[0], want[1])
    codes = np.rint(want[0].astype(np.float64) * 2 / r0["scale"])
    np.testing.assert_array_equal(codes, r0["acc"])
    exact = x.mean(axis=0)
    assert np.abs(r0["out"] - exact).max() <= np.abs(x).max() / 127 + 1e-6


def test_dp_train_step_compressed_averages_grads(dp2):
    """The reference test's quadratic step: the loss the mean of the two
    halves', the gradients their mean within the int8 payload's error."""
    p, b = DP_PARAMS, DP_BATCH

    def grad_fn(x):
        w = torch.from_numpy(p).requires_grad_()
        loss = ((torch.from_numpy(x) @ w) ** 2).mean()
        loss.backward()
        return float(loss.detach()), w.grad.numpy()
    l0, g0 = grad_fn(b[:2])
    l1, g1 = grad_fn(b[2:])
    r0, r1 = dp2["dp_step"]
    assert r0["loss"] == r1["loss"]
    np.testing.assert_array_equal(r0["grads"], r1["grads"])
    np.testing.assert_allclose(r0["loss"], (l0 + l1) / 2, rtol=1e-6)
    exact = (g0 + g1) / 2
    scale = max(np.abs(g0).max(), np.abs(g1).max()) / 127
    assert np.abs(r0["grads"] - exact).max() <= scale + 1e-6


def test_range_gradient_at_a_tie_across_ranks(dp2):
    """The max sits once on rank 0 and twice on rank 1, and -amin ties it
    on rank 0: the penalty's gradient goes to those elements, split by the
    global counts, as jax.grad of the penalty of the whole tensor gives it
    (not counted once a rank)."""
    x = _tie()
    whole = np.concatenate([x[0], x[1]], axis=0)         # (2, 3, 4)

    def jpen(a):
        taps = {"layers": {"qkv": {"amin": jnp.min(a), "amax": jnp.max(a)}}}
        return JOUT.activation_range_penalty(taps)
    jg = np.asarray(jax.grad(jpen)(jnp.asarray(whole)))
    got = np.concatenate([r["grad"] for r in dp2["range_tie"]], axis=0)
    np.testing.assert_array_equal(got, jg)
    assert np.count_nonzero(jg) == 4
    for r in dp2["range_tie"]:
        assert (r["amin"], r["amax"]) == (-2.0, 2.0)
        assert r["penalty"] == float(jpen(jnp.asarray(whole)))


def test_experts_and_model_axis_refuse(dp2):
    """A family with experts refuses a data axis of two ranks in both
    entries, the experts themselves under an active data axis too; a model
    axis of two ranks takes the dense family and the xLSTM (the steps are
    made; they run in test_torch_sharding.py's and
    test_torch_tp_families.py's tp = 2 spawns) and refuses the families
    with experts, naming item 6.10b (and 6.11 for the experts)."""
    for r in dp2["refuse"]:
        for key in ("train", "tune"):
            assert r[key] and "ROADMAP queue 1, item 6.11" in r[key]
    two = M.TPMesh(0, 2, None, torch.device("cpu"), None,
                   axes=("data", "model"))
    cfg = t_get_config("paper_tiny")
    api = build(cfg, "cpu")
    params = api.init_params(torch.Generator().manual_seed(0))
    run = TCfg.RunConfig(model=cfg, quant=TCfg.QuantConfig(), seq_len=8,
                         global_batch=2)
    fn, specs, _ = TT.shard_train_step(api, run, TT.make_optimizer(run),
                                       two, params.tree())
    assert callable(fn)
    assert flat_specs(specs)["/layers/attn/wqkv"] == (None, "data", "model")
    cfg = t_reduced(t_get_config("xlstm-350m"), dtype="float32", n_layers=2)
    api = build(cfg, "cpu")
    params = api.init_params(torch.Generator().manual_seed(0))
    run = TCfg.RunConfig(model=cfg, quant=TCfg.QuantConfig(), seq_len=8,
                         global_batch=2)
    fn, specs, _ = TT.shard_train_step(api, run, TT.make_optimizer(run),
                                       two, params.tree())
    assert callable(fn)
    for arch, also in (("jamba-v0.1-52b", "item 6.11"),
                       ("olmoe-1b-7b", "item 6.11")):
        # the hybrid at one period, the layer count its reduction keeps
        cfg = t_reduced(t_get_config(arch), dtype="float32",
                        **({} if arch.startswith("jamba") else
                           {"n_layers": 2}))
        api = build(cfg, "cpu")
        params = api.init_params(torch.Generator().manual_seed(0))
        run = TCfg.RunConfig(model=cfg, quant=TCfg.QuantConfig(), seq_len=8,
                             global_batch=2)
        with pytest.raises(ValueError,
                           match="ROADMAP queue 1, item 6.10b") as e:
            TT.shard_train_step(api, run, TT.make_optimizer(run), two,
                                params.tree())
        assert also is None or also in str(e.value)
    with pytest.raises(SystemExit, match="ROADMAP queue 1, item 6.11"):
        tune.main(["--device", "cpu", "--arch", "olmoe-1b-7b", "--smoke",
                   "--dp", "2", "--out-dir", "unused"])


def test_meshes_of_one_rank_and_their_names(dp2):
    """``single_device_mesh`` is the reference's one-device ("data",) mesh,
    ``make_mesh`` takes the ("data", "model") names of a training mesh
    (the ranks' FSDP specs resolved "D" to "data" on it) and refuses axes
    the port's meshes do not have."""
    one = M.single_device_mesh("cpu")
    assert (one.shape, one.axis_names) == ({"data": 1}, ("data",))
    train = M.make_mesh((1, 1), ("data", "model"), "cpu")
    assert train.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="axes"):
        M.make_mesh((2, 2), ("model", "data"), "cpu")
    specs = flat_specs(dp2["train"][0]["specs"])
    assert specs["/layers/attn/wqkv"] == (None, "data", "model")
    assert "data" not in specs["/layers/ln1/g"]


def _jax_pool_from_port(monkeypatch, seed):
    """JAX's search draws the port's candidate pools (a torch.Generator
    seeded as the port's launcher seeds it), so both searches see the same
    candidates."""
    gen = torch.Generator().manual_seed(seed + 2)
    monkeypatch.setattr(JCC, "candidate_pool", lambda rng, V, n,
                        seed_tokens=(): TCC.candidate_pool(gen, V, n,
                                                           seed_tokens))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A launch/train.py checkpoint of each package (paper_tiny, 2 steps)."""
    d = tmp_path_factory.mktemp("ckpts")
    args = ["--arch", "paper_tiny", "--steps", "2", "--batch", "2", "--seq",
            "16", "--eval-batches", "0", "--save-every", "2"]
    ttrain.main(["--device", "cpu", "--ckpt-dir", str(d / "port")] + args)
    jtrain.main(["--ckpt-dir", str(d / "jax")] + args)
    return {"port": d / "port", "jax": d / "jax"}


def test_tune_launcher_dp2_matches_dp1_and_jax(ckpts, tmp_path,
                                               monkeypatch):
    """``tune.py --dp 2`` and ``--dp 1`` on a checkpoint of the port's
    trainer, and the reference's launcher on the same checkpoint with the
    port's candidate pools: the same prefix ids; the tuned cushions within
    the method's pt_dynamic bars of JAX's and 1e-6 of each other; one
    artifact, every rank's fingerprint equal."""
    arts = {}
    for name, dp in (("dp2", "2"), ("dp1", "1")):
        out = tmp_path / name
        tune.main(TUNE_ARGS + ["--dp", dp, "--ckpt-dir", str(ckpts["port"]),
                               "--out-dir", str(out), "--report-json",
                               str(tmp_path / f"{name}.json")])
        arts[name] = out
    _jax_pool_from_port(monkeypatch, 0)
    jtune.main([a for a in TUNE_ARGS if a not in ("--device", "cpu")]
               + ["--ckpt-dir", str(ckpts["port"]), "--out-dir",
                  str(tmp_path / "jax")])
    trees = {}
    for name, d in (*arts.items(), ("jax", tmp_path / "jax")):
        store = CheckpointManager(str(d))
        assert store.steps() == [1]
        trees[name] = store.restore_tree(1)
    ids = {n: t[1]["extra"]["prefix_ids"] for n, t in trees.items()}
    print("prefix ids", ids)
    assert ids["dp2"] == ids["dp1"] == ids["jax"] and ids["jax"]
    rep = json.loads((tmp_path / "dp2.json").read_text())
    assert len(rep["ranks"]) == 2 and rep["dp"] == 2
    assert {r["fingerprint"] for r in rep["ranks"]} == {
        trees["dp2"][1]["extra"]["fingerprint"]}
    assert all(x["ranks_equal"] == 1.0 for x in rep["tune_log"])
    c = {n: t[0]["cushion"]["kv"] for n, t in trees.items()}
    api = build(t_get_config("paper_tiny"), "cpu")
    params = serve.restore_params(str(ckpts["port"]), api.init_params(
        torch.Generator().manual_seed(0)))
    greedy = api.extract_cushion(params, torch.as_tensor(
        ids["dp2"], dtype=torch.int32), None, TCfg.QuantConfig())["kv"]
    for k in ("k", "v"):
        two, one, jx = (c[n][k].numpy() for n in ("dp2", "dp1", "jax"))
        move = np.abs(jx - greedy[k].numpy())
        print(f"tuned {k}: max |dp2 - dp1| {np.abs(two - one).max():.2e}, "
              f"mean |dp2 - JAX| / mean move "
              f"{np.abs(two - jx).mean() / move.mean():.3f}")
        assert np.abs(two - one).max() <= 1e-6
        assert np.abs(two - jx).mean() < 0.25 * move.mean()


@pytest.mark.parametrize("which", ["port", "jax"])
def test_serve_ckpt_dir_serves_either_packages_checkpoint(ckpts, which):
    """``serve.py --ckpt-dir``: the params of the latest checkpoint, bit for
    bit, whichever package's trainer wrote it; the reference's serve.py on
    the same checkpoint gives the same greedy tokens (fp)."""
    argv = ["--arch", "paper_tiny", "--ckpt-dir", str(ckpts[which]),
            "--batch", "2", "--prompt-len", "16", "--tokens", "6"]
    api = build(t_get_config("paper_tiny"), "cpu")
    p0 = api.init_params(torch.Generator().manual_seed(0))
    got = serve.restore_params(str(ckpts[which]), p0)
    saved = CheckpointManager(str(ckpts[which]))
    stored = saved.restore_tree(saved.latest_step())[0]["params"]
    for path, a in flat(stored).items():
        np.testing.assert_array_equal(flat(got.tree())[path], a)
    res = serve.main(["--device", "cpu"] + argv)
    jres = jserve.main(argv)
    np.testing.assert_array_equal(res.tokens, np.asarray(jres.tokens))
    with pytest.raises(SystemExit, match="another"):
        serve.main(["--device", "cpu", "--arch", "qwen1.5-0.5b", "--smoke",
                    "--ckpt-dir", str(ckpts[which])])


def test_smoke_artifacts_load_both_ways(tmp_path):
    """``--smoke`` (the reduced f32 config, ``<arch>-smoke``): the port's
    smoke artifact serves in the reference's ``serve.py --smoke`` and the
    reference's in the port's."""
    small = ["--arch", "paper_tiny", "--smoke", "--max-prefix-len", "1",
             "--candidates", "8", "--sample-len", "8", "--steps", "1",
             "--log-every", "1", "--seq-len", "8", "--eval-batches", "1"]
    tune.main(["--device", "cpu", "--out-dir", str(tmp_path / "port")]
              + small)
    jtune.main(["--out-dir", str(tmp_path / "jax")] + small)
    for d in ("port", "jax"):
        extra = CheckpointManager(str(tmp_path / d)).manifest(1)["extra"]
        assert extra["arch"] == "paper_tiny-smoke" and extra["smoke"]
    serve_args = ["--arch", "paper_tiny", "--smoke", "--batch", "1",
                  "--prompt-len", "8", "--tokens", "3"]
    res = serve.main(["--device", "cpu", "--cushion", str(tmp_path / "jax")]
                     + serve_args)
    assert res.tokens.shape == (1, 3)
    jres = jserve.main(["--cushion", str(tmp_path / "port")] + serve_args)
    assert np.asarray(jres.tokens).shape == (1, 3)
    with pytest.raises(SystemExit, match="tuned for arch"):
        serve.main(["--device", "cpu", "--cushion", str(tmp_path / "jax"),
                    "--arch", "paper_tiny", "--batch", "1"])


@pytest.mark.parametrize("n", [1, 3])
def test_calib_batches_sets_the_calibration(monkeypatch, n):
    """``--calib-batches N`` calibrates pt_static over N pipeline batches
    (the reference's flag; the port had fixed 2)."""
    seen = []

    class Spy(serve.Engine):
        def __init__(self, *a, calib_batches=None, **kw):
            seen.append(len(calib_batches))
            super().__init__(*a, calib_batches=calib_batches, **kw)
    monkeypatch.setattr(serve, "Engine", Spy)
    serve.main(["--device", "cpu", "--quant", "pt_static", "--prequant",
                "--calib-batches", str(n), "--batch", "1", "--prompt-len",
                "8", "--tokens", "2"])
    assert seen == [n]
