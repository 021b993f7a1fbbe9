"""Port parity, the cushion artifact: ``repro_torch.checkpoint.store`` and
``launch/serve.py``'s ``load_cushion_artifact`` against the JAX package's
on the same directory format. Each side reads what the other writes (f32
and bf16 leaves, pt_static scales), with equal cushion fingerprints; a
corrupted shard and an artifact of another arch are refused; the port's
``launch/tune.py`` writes an artifact that its ``serve`` loads and serves;
and a JAX-tuned artifact served by the port's ``Engine`` gives the JAX
``Engine``'s tokens (greedy, W8A8 with the artifact's stored scales and an
int8 KV cache, on paper_tiny; tokens identical).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.store import CheckpointManager as JStore  # noqa: E402
from repro.configs import CushionConfig, QuantConfig, get_config  # noqa: E402
from repro.core import calibration as JCal  # noqa: E402
from repro.core import cushioncache as JCC  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch.checkpoint.store import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import calibration as TCal  # noqa: E402
from repro_torch.core.cushioncache import cushion_fingerprint  # noqa: E402
from repro_torch.launch import serve, tune  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

QN = QuantConfig()
QW8 = QuantConfig(mode="pt_static", true_int8=True)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _port_tree(rs):
    """A cushion with an f32 and a bf16 leaf, and a plain scales tree."""
    return {"cushion": {"kv": {
                "k": torch.from_numpy(rs.randn(2, 3, 4, 8).astype(np.float32)),
                "v": torch.from_numpy(rs.randn(2, 3, 4, 8).astype(np.float32))
                .to(torch.bfloat16)}},
            "scales": {"qkv": {"scale": torch.rand(2), "zero": torch.zeros(2)},
                       "head": {"scale": torch.tensor(0.5),
                                "zero": torch.tensor(3.0)}}}


def test_port_writes_jax_reads(tmp_path):
    tree = _port_tree(np.random.RandomState(0))
    fp = cushion_fingerprint(tree["cushion"])
    path = CheckpointManager(str(tmp_path)).save(
        4, tree, extra={"kind": "cushion", "arch": "paper_tiny",
                        "fingerprint": fp})
    jtree, manifest = JStore(str(tmp_path)).restore_tree(4)
    assert manifest["dtypes"] == ["float32", "bfloat16", "float32",
                                  "float32", "float32", "float32"]
    assert JCC.cushion_fingerprint(
        jax.tree.map(jnp.asarray, jtree["cushion"])) == fp
    for (p, t), (jp_, a) in zip(_leaves(tree), _leaves(jtree)):
        assert p == jp_
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a, np.float32))
        assert tuple(t.shape) == np.asarray(a).shape
    assert os.path.basename(path) == "step_00000004"


def test_jax_writes_port_reads(tmp_path):
    rs = np.random.RandomState(1)
    jtree = {"cushion": {"kv": {
        "k": jnp.asarray(rs.randn(2, 3, 4, 8), jnp.bfloat16),
        "v": jnp.asarray(rs.randn(2, 3, 4, 8), jnp.float32)}},
        "scales": {"o": {"scale": jnp.ones((2,)), "zero": jnp.zeros((2,))}}}
    fp = JCC.cushion_fingerprint(jtree["cushion"])
    JStore(str(tmp_path)).save(1, jtree, extra={"fingerprint": fp})
    store = CheckpointManager(str(tmp_path))
    assert store.steps() == [1] and store.latest_step() == 1
    tree, manifest = store.restore_tree(1)
    assert manifest["extra"]["fingerprint"] == fp
    assert tree["cushion"]["kv"]["k"].dtype == torch.bfloat16
    assert tree["cushion"]["kv"]["v"].dtype == torch.float32
    assert cushion_fingerprint(tree["cushion"]) == fp
    for (p, a), (_, t) in zip(_leaves(jtree), _leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      t.float().numpy())
    assert store.manifest(1) == manifest


def test_corrupt_shard_raises_and_keep_collects(tmp_path):
    store = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        store.save(step, _port_tree(np.random.RandomState(step)))
    assert store.steps() == [2, 3]          # keep-2 garbage collection
    shard = tmp_path / "step_00000003" / "arrays.npz"
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0xFF
    shard.write_bytes(bytes(data))
    with pytest.raises(IOError, match="corruption"):
        store.restore_tree(3)
    with pytest.raises(IOError, match="corruption"):
        JStore(str(tmp_path)).restore_tree(3)   # the reference agrees


def test_arch_mismatch_and_bad_fingerprint_exit(tmp_path):
    api = build(t_get_config("paper_tiny"), "cpu")
    tree = _port_tree(np.random.RandomState(2))
    fp = cushion_fingerprint(tree["cushion"])
    CheckpointManager(str(tmp_path / "a")).save(
        1, tree, extra={"kind": "cushion", "arch": "smollm-360m",
                        "fingerprint": fp})
    with pytest.raises(SystemExit, match="arch"):
        serve.load_cushion_artifact(str(tmp_path / "a"), api)
    CheckpointManager(str(tmp_path / "b")).save(
        1, tree, extra={"kind": "cushion", "arch": "paper_tiny",
                        "fingerprint": "0" * 64})
    with pytest.raises(SystemExit, match="fingerprint"):
        serve.load_cushion_artifact(str(tmp_path / "b"), api)
    CheckpointManager(str(tmp_path / "c")).save(1, tree, extra={})
    with pytest.raises(SystemExit, match="not a cushion"):
        serve.load_cushion_artifact(str(tmp_path / "c"), api)


def test_port_tune_launcher_artifact_serves(tmp_path):
    out = tmp_path / "art"
    report = tmp_path / "report.json"
    tune.main(["--device", "cpu", "--arch", "paper_tiny", "--out-dir",
               str(out), "--max-prefix-len", "3", "--candidates", "16",
               "--sample-len", "16", "--steps", "3", "--log-every", "2",
               "--seq-len", "16", "--eval-batches", "1", "--with-scales",
               "--report-json", str(report)])
    rep = json.loads(report.read_text())
    assert rep["kind"] == "cushion" and len(rep["tune_log"]) == 3
    api = build(t_get_config("paper_tiny"), "cpu")
    cushion, scales, extra = serve.load_cushion_artifact(str(out), api)
    assert cushion_fingerprint(cushion) == extra["fingerprint"]
    assert scales.cushion_fp == extra["fingerprint"]
    m = len(extra["prefix_ids"])
    assert tuple(cushion["kv"]["k"].shape) == (4, m, 4, 32)
    res = serve.main(["--device", "cpu", "--arch", "paper_tiny", "--quant",
                      "pt_static", "--prequant", "--kv-dtype", "int8",
                      "--cushion", str(out), "--batch", "2",
                      "--prompt-len", "16", "--tokens", "4"])
    assert res.tokens.shape == (2, 4)
    # the reference's loader reads the port's artifact, fingerprint and all
    japi = j_build(get_config("paper_tiny"))
    jc, jsc, _ = jserve.load_cushion_artifact(str(out), japi)
    assert JCC.cushion_fingerprint(jc) == extra["fingerprint"]
    assert jsc.cushion_fp == extra["fingerprint"]
    # --dp N tunes data-parallel (tests/test_torch_data_parallel.py); a
    # batch that does not split over the ranks stops before they start
    with pytest.raises(SystemExit):
        tune.main(["--device", "cpu", "--out-dir", str(out), "--dp", "2",
                   "--batch", "3"])


def test_jax_tuned_artifact_serves_jax_tokens(tmp_path):
    """The ROADMAP gate: an artifact tuned and calibrated by the JAX
    package, saved in its format, loads in the port with the same
    fingerprint, and the port's Engine serves it with the JAX Engine's
    tokens."""
    japi = j_build(get_config("paper_tiny"))
    jp = japi.init_params(jax.random.PRNGKey(0))
    greedy = japi.extract_cushion(jp, jnp.asarray([1, 2, 3], jnp.int32),
                                  None, QN)
    batches = [japi.make_batch(jax.random.PRNGKey(3000 + i), 2, 24)
               for i in range(4)]
    tr = JCC.prefix_tune(japi, jp, greedy, iter(batches[:3]),
                         QuantConfig(mode="pt_dynamic"),
                         CushionConfig(tune_steps=3, tune_lr=1e-3, lam=0.1,
                                       log_every=3), verbose=False)
    tagged, _ = JCal.calibrate_tagged(japi, jp, batches[3:], QW8,
                                      cushion=tr.cushion)
    fp = JCC.cushion_fingerprint(tr.cushion)
    JStore(str(tmp_path)).save(
        1, {"cushion": tr.cushion,
            "scales": JCal.scales_to_plain(tagged.scales)},
        extra={"kind": "cushion", "arch": "paper_tiny", "fingerprint": fp,
               "prefix_ids": [1, 2, 3], "scales_cushion_fp": fp})

    api = build(t_get_config("paper_tiny"), "cpu")
    cushion, scales, _ = serve.load_cushion_artifact(str(tmp_path), api)
    assert cushion_fingerprint(cushion) == fp
    assert isinstance(scales, TCal.CalibratedScales)
    jc, jsc, _ = jserve.load_cushion_artifact(str(tmp_path), japi)
    prompt = np.random.RandomState(5).randint(0, 512, (2, 12)).astype(
        np.int32)
    kw = dict(max_seq=48, kv_dtype="int8", prequant=True)
    jres = JEngine(japi, jp, QW8, cushion=jc, scales=jsc, **kw).generate(
        {"tokens": jnp.asarray(prompt)}, 12)
    params = convert.params_from_numpy(np_tree(jp))
    res = Engine(api, params, QW8, cushion=cushion, scales=scales,
                 **kw).generate({"tokens": torch.from_numpy(prompt)}, 12)
    np.testing.assert_array_equal(res.tokens, jres.tokens)
    # stale scales are refused: the same scales under another cushion
    other = {"kv": {k: v + 1 for k, v in cushion["kv"].items()}}
    with pytest.raises(ValueError, match="stale"):
        Engine(api, params, QW8, cushion=other, scales=scales, **kw)
