"""The port stands alone: every ``repro_torch`` module imports without jax
and without the JAX package, and an entry point asked for the card on a
machine without one raises instead of running on the CPU."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve, train, tune  # noqa: E402
from repro_torch.models.registry import build, resolve_device  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_PROBE = r"""
import pkgutil, importlib, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
assert {"repro_torch.models.moe", "repro_torch.core.smoothquant",
        "repro_torch.models.vlm", "repro_torch.models.ssm",
        "repro_torch.models.hybrid", "repro_torch.models.encdec",
        "repro_torch.models.xlstm", "repro_torch.train.trainer",
        "repro_torch.launch.train", "repro_torch.launch.mesh",
        "repro_torch.distributed.sharding",
        "repro_torch.distributed.collectives"} <= set(names)
for n in names:
    importlib.import_module(n)
# the rank programs that the tensor- and data-parallel tests and
# chip_smoke.py spawn
importlib.import_module("_tp_probe")
importlib.import_module("_dp_probe")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.abspath(SRC), os.path.abspath(os.path.dirname(__file__))]))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n = int(out.stdout.split()[0])
    assert n >= 60, out.stdout      # every module of the port was imported


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        build(get_config("paper_tiny"))            # the default is the card
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "paper_tiny"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "paper_tiny", "--mode", "continuous",
                    "--replicas", "3"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tune.main(["--arch", "paper_tiny", "--out-dir", "unused"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tune.main(["--arch", "paper_tiny", "--out-dir", "unused", "--dp",
                   "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "paper_tiny", "--smoke", "--ckpt-dir",
                    "unused"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "paper_tiny"])
    assert resolve_device("cpu").type == "cpu"


def test_serve_cli_runs_on_cpu_when_asked(tmp_path):
    out = tmp_path / "bench.json"
    res = serve.main(["--arch", "paper_tiny", "--device", "cpu",
                      "--quant", "pt_static", "--prequant",
                      "--kv-dtype", "int8", "--cushion-len", "2",
                      "--batch", "2", "--prompt-len", "16", "--tokens", "4",
                      "--bench-json", str(out)])
    assert res.tokens.shape == (2, 4)
    assert out.exists()


def test_serve_cli_tp2_runs_on_cpu_when_asked():
    """``--tp 2`` spawns two gloo ranks; rank 0's result comes back, and
    the tokens are the unsharded launcher's (W8A8 int8-resident weights:
    the row-parallel sites sum int32 accumulators)."""
    argv = ["--arch", "paper_tiny", "--device", "cpu", "--quant",
            "pt_static", "--prequant", "--kv-dtype", "int8",
            "--cushion-len", "2", "--batch", "2", "--prompt-len", "16",
            "--tokens", "4"]
    res = serve.main(argv + ["--tp", "2"])
    assert res.tokens.shape == (2, 4)
    assert (res.tokens == serve.main(argv).tokens).all()


ROOT = os.path.join(os.path.dirname(__file__), "..")
# the port's scripts beside the package: they import neither jax nor the
# JAX package (the card's machine has no jax)
STANDALONE = ["chip_smoke.py", "examples/torch_quickstart.py",
              "examples/torch_quantized_serving.py",
              "examples/torch_multiarch_smoke.py", "tests/_tp_probe.py",
              "tests/_dp_probe.py", "tools/kernel_variants.py",
              "tools/step_profile.py"]


@pytest.mark.parametrize("path", STANDALONE)
def test_standalone_scripts_import_no_jax(path):
    """Every import statement of the script, at any depth (the scripts
    import inside their functions), names neither jax nor ``repro``."""
    import ast
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert names and not bad, bad


def test_torch_multiarch_smoke_example_on_cpu():
    """``examples/torch_multiarch_smoke.py --arch xlstm-350m --device
    cpu``: a reduced model's loss and one decode step's logits (B = 2,
    its vocabulary of 256)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_multiarch_smoke.py"),
         "--arch", "xlstm-350m", "--device", "cpu"], env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "xlstm-350m" in out.stdout
    assert "decode_logits=(2, 256)" in out.stdout
