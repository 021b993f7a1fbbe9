"""Port parity, the dry-run accounting (``repro_torch/launch/dryrun.py``,
``launch/cost.py``) against the JAX package's (``repro/launch/dryrun.py``,
``launch/hlo_cost.py``), on the CPU, with no spawn of its own:

* every architecture's parameter tree on ``meta`` (fp and prequantized) has
  JAX's ``eval_shape`` paths, shapes and dtypes, at full size, and the
  parameter counts are JAX's;
* for every serving cell of both production meshes (``--param-shard
  tp``), the rank's parameter and cache bytes by the reference's specs are
  those of JAX's ``params_shardings`` / ``cache_shardings`` over an
  ``AbstractMesh`` (``NamedSharding.shard_shape``), and every leaf the
  rank holds has JAX's shard bytes but for the port's documented cuts
  (``serving/engine.shard_tree``, ``models/xlstm.cache_roles``);
* the FLOPs of a prefill and a decode step (B = 2, S = 256) equal
  ``analyze_hlo`` of JAX's CPU-compiled programs exactly, for paper_tiny
  under ``none`` and under ``pt_static`` with int8-resident weights and
  for a reduced config of each other family; the one-device train step
  too; the launches of the W8A8 calls are the card's (``chip_smoke.py``
  phase 4n holds them against ``_lib.LAUNCHES``);
* ``cost.scan`` counts a step n times; the meta route is a device of its
  own and the card's refusals hold on it;
* the ``train_4k`` cells of the families without experts (dense, VLM,
  encoder-decoder, xLSTM) run one rank's ``shard_train_step`` on meta
  (both meshes, the reference's microbatches), those with experts refuse
  naming ROADMAP items 6.10b and 6.11;
* the CLI writes the reference's record keys, skips what is done, and
  writes the cells the port does not run as ``ok: false``.
"""
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.core.quantization import (  # noqa: E402
    prequantize_tree as j_prequantize)
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch.hlo_cost import analyze_hlo  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro.optim.adamw import cosine_lr as j_cosine  # noqa: E402
from repro.train.trainer import make_train_step as j_train_step  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES, QuantConfig,  # noqa: E402
                                 cell_is_applicable, get_config, reduced)
from repro_torch.core import quantization as TQ  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import cost  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import dryrun_mesh, production_shape  # noqa: E402
from repro_torch.models.registry import build, resolve_device  # noqa: E402

B, S = 2, 256
QW8 = QuantConfig(mode="pt_static", true_int8=True)
# the serving cells of the production meshes
CELLS = [(arch, shape, mp) for arch in ARCH_IDS for shape in SHAPES
         if SHAPES[shape]["kind"] != "train"
         and cell_is_applicable(arch, shape) for mp in (False, True)]
# where a rank holds other bytes of a leaf than the reference's spec, and
# why (serving/engine.shard_tree, models/xlstm.cache_roles): a rank takes
# its query heads and every KV head of the fused qkv where the KV heads do
# not divide (the spec cuts the fused columns in blocks), keeps attention
# whole where its heads do not divide (the spec may still cut wo's rows),
# keeps the Mamba x-projection whole and cuts the conv bias with its
# channels; the xLSTM keeps n and the sLSTM state whole (their last axis
# is contracted)
PARAM_CUTS = re.compile(r"(attn/(wqkv|bqkv|wo)|mamba/(w_x|conv_b))"
                        r"(/w_int|/colsum|/w_scale)?$")
CACHE_CUTS = re.compile(r"^(m/n|s/[cnhm])$")


def _flat(tree, prefix=""):
    if hasattr(tree, "tree") and callable(tree.tree):
        tree = tree.tree()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: tree}


def _jax_flat(tree):
    paths = jax.tree_util.tree_leaves(JSH.tree_paths(tree))
    return dict(zip(paths, jax.tree_util.tree_leaves(tree)))


def _shapes(flat, dtype_name):
    return {p: (tuple(x.shape), dtype_name(x.dtype)) for p, x in flat.items()}


def _torch_dt(dt):
    return str(dt).replace("torch.", "")


def _jax_dt(dt):
    return jnp.dtype(dt).name


def _jax_params(cfg, prequant=False):
    api = j_build(cfg)
    p = jax.eval_shape(lambda: api.init_params(jax.random.PRNGKey(0)))
    if prequant:
        qcfg = JQuantConfig(mode="pt_static", true_int8=True)
        p = jax.eval_shape(lambda t: j_prequantize(t, qcfg), p)
    return api, p


# ---------------------------------------------------------------------------
# 1. Parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS + ["paper_tiny"])
def test_meta_tree_equals_jax(arch):
    """Paths, shapes and dtypes of the whole tree on meta, fp and
    prequantized, are JAX's; so are the parameter counts."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    tree = build(cfg, "meta").init_params()
    for t in _flat(tree).values():
        assert t.device.type == "meta"
    _, jp = _jax_params(jcfg)
    assert _shapes(_flat(tree), _torch_dt) == _shapes(_jax_flat(jp), _jax_dt)
    pq = TQ.prequantize_tree(tree.tree(), QW8)
    _, jpq = _jax_params(jcfg, prequant=True)
    assert _shapes(_flat(pq), _torch_dt) == _shapes(_jax_flat(jpq), _jax_dt)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", ["paper_tiny", "olmoe-1b-7b", "internvl2-26b",
                                  "jamba-v0.1-52b", "whisper-base",
                                  "xlstm-350m"])
def test_meta_tree_is_the_seeded_tree(arch):
    """The meta tree is the tree a generator makes, leaf for leaf (a
    reduced config of each family)."""
    cfg = get_config(arch) if arch == "paper_tiny" else \
        reduced(get_config(arch))
    meta = build(cfg, "meta").init_params()
    real = build(cfg, "cpu").init_params(torch.Generator().manual_seed(0))
    assert _shapes(_flat(meta), _torch_dt) == _shapes(_flat(real), _torch_dt)


# ---------------------------------------------------------------------------
# 2. Per-rank bytes
# ---------------------------------------------------------------------------

def _nbytes(shape, dtype):
    return int(np.prod(shape)) * jnp.dtype(dtype).itemsize


def _jax_mesh(multi_pod):
    return AbstractMesh(*production_shape(multi_pod))


_JAX_PARAM_SHARDS = {}


def _jax_param_shards(arch, multi_pod):
    """{path: a rank's bytes} of JAX's serve-rules layout."""
    key = (arch, multi_pod)
    if key not in _JAX_PARAM_SHARDS:
        _, p = _jax_params(j_get_config(arch))
        mesh = _jax_mesh(multi_pod)
        specs = JSH.params_shardings(p, mesh, rules=JSH.serve_rules())
        sh = _jax_flat(specs)
        _JAX_PARAM_SHARDS[key] = {
            path: _nbytes(sh[path].shard_shape(x.shape), x.dtype)
            for path, x in _jax_flat(p).items()}
    return _JAX_PARAM_SHARDS[key]


def _jax_cache_shards(arch, shape, multi_pod):
    api = j_build(j_get_config(arch))
    shp = SHAPES[shape]
    c = jax.eval_shape(lambda: api.init_cache(shp["global_batch"],
                                              shp["seq_len"]))
    sh = _flat(JSH.cache_shardings(api.cache_roles(), c, _jax_mesh(multi_pod)))
    return {path: _nbytes(sh[path].shard_shape(x.shape), x.dtype)
            for path, x in _flat(c).items()}


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_rank_bytes_equal_jax(arch, shape, multi_pod):
    """The rank's parameter and cache bytes by the reference's specs are
    JAX's; every leaf the rank holds has JAX's shard bytes but the port's
    documented cuts."""
    shp = SHAPES[shape]
    mesh = dryrun_mesh(*production_shape(multi_pod))
    prog = D.serving_program(get_config(arch), shp["kind"],
                             shp["global_batch"], shp["seq_len"], mesh=mesh)
    jparams = _jax_param_shards(arch, multi_pod)
    jcache = _jax_cache_shards(arch, shape, multi_pod)
    assert prog.spec_bytes == {"params": sum(jparams.values()),
                               "cache": sum(jcache.values())}
    if (arch, multi_pod) == ("deepseek-67b", False):
        assert prog.spec_bytes["params"] == 8_431_058_944
    for mine, theirs, cuts in ((_flat(prog.params), jparams, PARAM_CUTS),
                               (_flat(prog.cache), jcache, CACHE_CUTS)):
        assert set(mine) == set(theirs)
        off = {p for p in mine if cost.nbytes(mine[p]) != theirs[p]}
        assert all(cuts.search(p) for p in off), sorted(off)


# ---------------------------------------------------------------------------
# 3. FLOPs against the reference's HLO count
# ---------------------------------------------------------------------------

# (id, arch, reduced, quant, prequant): paper_tiny at full size, one
# reduced config of each other family
FLOP_CASES = [("paper_tiny-none", "paper_tiny", False, "none", False),
              ("paper_tiny-w8a8", "paper_tiny", False, "pt_static", True),
              ("moe", "olmoe-1b-7b", True, "none", False),
              ("vlm", "internvl2-26b", True, "none", False),
              ("hybrid", "jamba-v0.1-52b", True, "none", False),
              ("encdec", "whisper-base", True, "none", False),
              ("xlstm", "xlstm-350m", True, "none", False)]


def _jax_flops(arch, red, quant, prequant):
    """analyze_hlo's FLOPs of the reference's prefill and decode step, as
    its dry-run lowers them (one device)."""
    cfg = j_get_config(arch)
    cfg = j_reduced(cfg) if red else cfg
    api, p = _jax_params(cfg, prequant)
    qcfg = JQuantConfig(mode=quant, true_int8=(quant == "pt_static"))
    scales = (api.mod.placeholder_all_scales(cfg) if quant != "none"
              else None)
    c = jax.eval_shape(lambda: api.init_cache(B, S))
    b = api.input_specs(B, S)
    b.pop("labels")
    pre = jax.jit(lambda pp, bb, cc: api.prefill(pp, bb, cc, qcfg,
                                                 scales=scales))
    dec = jax.jit(lambda pp, t, q, cc: api.decode_step(pp, t, q, cc, qcfg,
                                                       scales=scales))
    tok = jax.ShapeDtypeStruct((B,), jnp.int32)
    pos = jax.ShapeDtypeStruct((), jnp.int32)
    return {"prefill": analyze_hlo(pre.lower(p, b, c).compile().as_text()),
            "decode": analyze_hlo(dec.lower(p, tok, pos, c).compile()
                                  .as_text())}


@pytest.mark.parametrize("case", FLOP_CASES, ids=[c[0] for c in FLOP_CASES])
def test_flops_equal_hlo(case):
    _, arch, red, quant, prequant = case
    want = _jax_flops(arch, red, quant, prequant)
    cfg = reduced(get_config(arch)) if red else get_config(arch)
    for kind in ("prefill", "decode"):
        got = D.measure_program(D.serving_program(
            cfg, kind, B, S, quant=quant, prequant=prequant))
        print(f"{case[0]} {kind}: port {got['cost'].flops:.0f} FLOPs, JAX "
              f"{want[kind]['flops']:.0f}")
        assert got["cost"].flops == want[kind]["flops"]
        assert got["cost"].collective_counts == want[kind][
            "collective_counts"]
    if case[0] == "paper_tiny-none":
        assert want["prefill"]["flops"] == 3_758_620_672
        assert want["decode"]["flops"] == 15_204_352


def test_w8a8_launches_are_the_cards():
    """paper_tiny under W8A8 with int8-resident weights: 5 qlinear calls a
    layer and the head; the static quantizer runs standalone above 16 rows
    and inside the int matmul at or below (the head's last position at
    prefill, every site at decode), as ``_lib.LAUNCHES`` counts on the
    card."""
    cfg = get_config("paper_tiny")
    L = cfg.n_layers
    want = {"prefill": {"act_quant_static": 5 * L, "w8a8_matmul": 5 * L + 1,
                        "act_quant_static_fused": 1, "flash_attention": L},
            "decode": {"w8a8_matmul": 5 * L + 1,
                       "act_quant_static_fused": 5 * L + 1,
                       "flash_decode": L}}
    before = dict(_lib.LAUNCHES)
    for kind, launches in want.items():
        got = D.measure_program(D.serving_program(
            cfg, kind, B, S, quant="pt_static", prequant=True))
        assert got["launches"] == launches
        assert set(launches) <= set(_lib.KERNELS + _lib.FUSED)
        # every product but the attention's is an integer one
        rows = S if kind == "prefill" else 1
        attn = 4 * B * cfg.n_heads * rows * S * cfg.head_dim * L
        assert got["int8_flops"] == got["cost"].flops - attn > 0
    assert _lib.LAUNCHES == before           # the card's counts untouched


def test_train_step_flops_equal_hlo():
    """One train step of paper_tiny (B = 2, S = 256, microbatches 1, remat
    on) on one device: the port's forward, its recomputation under remat
    and the backward (the attention kernel's 8·B·H·S·T·hd) count what
    ``analyze_hlo`` counts for the reference's ``jax.grad`` step."""
    cfg = j_get_config("paper_tiny")
    api, p = _jax_params(cfg)
    from repro.configs import RunConfig
    run = RunConfig(model=cfg, quant=JQuantConfig(), seq_len=S,
                    global_batch=B)
    opt = JAdamW(lr=j_cosine(3e-4, 100, 1000))
    o = jax.eval_shape(opt.init, p)
    step = jax.jit(j_train_step(api, run, opt, microbatches=1))
    want = analyze_hlo(step.lower(p, o, api.input_specs(B, S)).compile()
                       .as_text())["flops"]
    got = D.train_step_cost(get_config("paper_tiny"), B, S)
    print(f"train step: port {got['cost'].flops:.0f} FLOPs, JAX {want:.0f}")
    assert want == 14_629_732_352
    assert got["cost"].flops == want
    L = cfg.n_layers
    assert got["launches"] == {"flash_attention": 2 * L,
                               "flash_attention_bwd": L}


# ---------------------------------------------------------------------------
# 4. The mechanism
# ---------------------------------------------------------------------------

def test_scan_counts_one_step_n_times():
    w = torch.empty(8, 8, device="meta")

    def step(t, h):
        h = torch.tanh(h @ w)
        return h, h
    h0 = torch.empty(4, 8, device="meta")
    with cost.counting() as once:
        ys, _ = cost.scan(5, step, h0)
    with cost.counting() as loop:
        for t in range(5):
            _, h0 = step(t, h0)
    assert len(ys) == 5 and ys[0].shape == (4, 8)
    assert once.cost.flops == loop.cost.flops == 5 * 2 * 4 * 8 * 8
    assert once.cost.bytes == loop.cost.bytes
    # elsewhere a plain loop over real values
    x = torch.ones(2, 8)
    ys, last = cost.scan(3, lambda t, h: (h + t, h + t), x)
    assert [float(y[0, 0]) for y in ys] == [1.0, 2.0, 4.0]
    assert torch.equal(last, ys[-1])


def test_meta_is_a_device_of_its_own():
    """``meta`` is what only the dry-run asks for; every other device but
    the card and the CPU still raises, the card's refusals hold on meta,
    and a meta tree takes no generator."""
    assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")
    with pytest.raises(ValueError, match="no generator"):
        build(get_config("paper_tiny"), "meta").init_params(
            torch.Generator().manual_seed(0))
    q = torch.empty(1, 2, 4, 96, device="meta")
    with pytest.raises(ValueError, match="head_dim 96 not built"):
        flash_attention(q, q, q)
    # a meta call outside a tally counts nothing and touches no card count
    before = dict(_lib.LAUNCHES)
    out = flash_attention(*(torch.empty(1, 2, 4, 32, device="meta"),) * 3)
    assert out.shape == (1, 2, 4, 32) and out.device.type == "meta"
    assert _lib.LAUNCHES == before and cost.active() is None


def test_train_cells_of_the_dense_family_run_and_the_others_refuse():
    """The 14 ``train_4k`` cells (both production meshes) of the families
    without experts (dense, VLM, encoder-decoder, xLSTM) run one rank's
    ``shard_train_step`` on meta: the reference's microbatches (one row a
    rank each), both attention kernels an attention layer a microbatch
    (the forward twice with remat: internvl2's self-attention, whisper's
    encoder, decoder and cross-attention; none in the xLSTM), the FSDP
    gather and the tensor-parallel collectives; the 6 of the families with
    experts (olmoe, arctic, the jamba hybrid) refuse, naming items 6.10b
    and 6.11."""
    n_ok = n_refused = 0
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for mp in (False, True):
            if cfg.moe is not None:
                with pytest.raises(ValueError, match="item 6.10b") as e:
                    D.lower_cell(arch, "train_4k", mp)
                assert "item 6.11" in str(e.value)
                n_refused += 1
                continue
            r = D.lower_cell(arch, "train_4k", mp)
            n_b = 32 if mp else 16
            assert r["kind"] == "train" and r["rank_batch"] == 256 // n_b
            mb = 256 // n_b
            n_attn = {"ssm": 0, "encdec": cfg.n_layers * 2 + (
                cfg.encdec.encoder_layers if cfg.encdec else 0)}.get(
                    cfg.family.value, cfg.n_layers)
            want = {"flash_attention": 2 * mb * n_attn,
                    "flash_attention_bwd": mb * n_attn} if n_attn else {}
            assert r["launches"] == want, arch
            assert r["collective_counts"]["all-reduce"] > 0
            assert r["flops_per_chip"] > r["model_flops_per_chip"] > 0
            assert r["param_bytes_per_chip"] \
                >= r["param_bytes_spec_per_chip"] > 0
            n_ok += 1
    assert (n_ok, n_refused) == (14, 6)


def test_dryrun_mesh_is_the_reference_mesh():
    mesh = dryrun_mesh(*production_shape(True))
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.axis_names == ("pod", "data", "model")
    assert (mesh.size, mesh.data_size, mesh.group) == (16, 32, None)
    assert mesh.device.type == "meta"
    assert D.rank_rows(32, mesh) == 1 and D.rank_rows(1, mesh) == 1
    assert D.rank_rows(128, dryrun_mesh(*production_shape(False))) == 8


# ---------------------------------------------------------------------------
# 5. The launcher
# ---------------------------------------------------------------------------

# the reference's record keys (repro/launch/dryrun.py analyze, lower_cell,
# main)
REF_KEYS = {"arch", "shape", "kind", "mesh", "quant", "cushion_m", "chips",
            "global_batch", "seq_len", "flops_per_chip", "bytes_per_chip",
            "xla_flops_per_chip", "xla_bytes_per_chip",
            "collective_bytes_per_chip", "collective_counts", "memory",
            "terms", "dominant", "model_flops_per_chip", "useful_flops_frac",
            "hlo_chars", "params", "active_params", "compile_s",
            "param_shard", "prequant", "ok", "wall_s"}


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_cli_records_resume_and_refusals(tmp_path, capsys):
    out = str(tmp_path / "dry.jsonl")
    base = ["--arch", "qwen1.5-0.5b", "--out", out]
    D.main(base + ["--shape", "decode_32k", "--both-meshes",
                   "--param-shard", "tp"])
    recs = _records(out)
    assert [(r["mesh"], r["ok"]) for r in recs] == [("16x16", True),
                                                   ("2x16x16", True)]
    for r in recs:
        assert REF_KEYS <= set(r)
        assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                    "temp_bytes", "alias_bytes"}
        assert set(r["terms"]) == {"compute_s", "memory_s", "collective_s"}
        assert r["flops_per_chip"] > 0 and r["memory"]["alias_bytes"] > 0
        assert r["collective_counts"]["all-reduce"] > 0
        assert r["rank_batch"] == 128 // (16 if r["mesh"] == "16x16" else 32)
    one = recs[0]
    assert one["model_flops_per_chip"] == \
        2 * one["active_params"] * 128 / 256
    # resume: what is done is skipped
    D.main(base + ["--shape", "decode_32k", "--both-meshes",
                   "--param-shard", "tp"])
    assert len(_records(out)) == 2
    assert capsys.readouterr().out.count("[skip]") == 2
    # the dense family's train step (tensor parallel and FSDP); what the
    # port does not run: ok false, naming its item
    D.main(base + ["--shape", "train_4k", "--param-shard", "tp"])
    D.main(base + ["--shape", "prefill_32k"])            # fsdp, the default
    D.main(["--arch", "olmoe-1b-7b", "--out", out, "--shape", "train_4k"])
    train, fsdp, other = _records(out)[2:]
    assert train["ok"] and REF_KEYS <= set(train)
    assert train["kind"] == "train" and train["rank_batch"] == 256 // 16
    assert train["launches"] == {"flash_attention": 2 * 16 * 24,
                                 "flash_attention_bwd": 16 * 24}
    assert train["collective_counts"]["all-reduce"] > 0
    assert 0 < train["param_bytes_per_chip"] \
        == train["param_bytes_spec_per_chip"]
    # bf16 shards, their f32 moments and the int32 step
    assert train["opt_bytes_per_chip"] \
        == 4 * train["param_bytes_per_chip"] + 4
    assert not fsdp["ok"] and "item 6.12" in fsdp["error"]
    assert fsdp["param_shard"] == "fsdp"
    assert not other["ok"] and "item 6.10b" in other["error"]
    assert {"arch", "shape", "mesh", "quant", "cushion_m", "ok", "error",
            "traceback", "wall_s"} <= set(other)
