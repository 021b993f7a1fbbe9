"""The dry-run accounting of every (architecture x input shape x mesh)
cell, ported from ``repro/launch/dryrun.py``: the parameters, FLOPs,
bytes, collectives and per-rank memory of one rank's program.

The reference lowers and compiles each cell for 256 or 512 fake XLA host
devices and reads the compiled program's memory analysis and its HLO
(``hlo_cost.analyze_hlo``). The port has neither: it runs one rank's
program of the cell eagerly on ``meta`` tensors, which carry shapes and
dtypes and no data, on ``launch/mesh.dryrun_mesh`` (rank 0 of the
production mesh, no process group), and counts what runs
(``launch/cost.py``): the matrix products PyTorch runs itself, each
hand-written kernel's FLOPs and bytes as its wrapper records them on meta
(the reference's HLO counts for the jnp oracles it lowers in their
place), the collectives the rank issues, the kernels' launches, and the
peak of the bytes the run allocates. The rank's program is the engines':
``check_tp_serving``, ``plan_quantization`` (``prequantize_tree`` with
``--prequant``), ``shard_params_for_serving`` at the mesh's tp,
``tp_config``, the rank's cache (``tp_cache``), then ``prefill`` or one
``decode_step`` under the mesh's tp axis. Serving is replicated over the
batch axes and issues no collective there: the rank takes B / n_batch
rows, or the whole batch where that does not divide (the reference's
``batch_shardings``).

    python -m repro_torch.launch.dryrun --all --param-shard tp
    python -m repro_torch.launch.dryrun --arch deepseek-67b \
        --shape decode_32k --both-meshes --quant pt_static --prequant \
        --param-shard tp

The record has the reference's keys. ``memory`` is the meta run's:
``argument_bytes`` (the rank's parameters, cache, inputs, cushion and
scales), ``output_bytes`` (what the call returns), ``alias_bytes`` (the
outputs that are arguments: the cache written in place) and
``temp_bytes`` (the peak of the bytes allocated during the call, rounded
as the card's caching allocator rounds them, the kernels' workspaces
included). The roofline terms take the card's published peaks (``DEVICE``):
the int matmuls' FLOPs at the int8 rate, the others at bf16's, the bytes
at HBM's rate and the collective bytes at NVLink's. There is no XLA
estimate and no HLO text: ``xla_flops_per_chip`` and
``xla_bytes_per_chip`` are None, ``hlo_chars`` 0, and ``compile_s`` is the
meta run's seconds. Beside the reference's keys: ``launches`` by kernel,
``int8_flops_per_chip``, ``param_bytes_per_chip`` and
``cache_bytes_per_chip`` (what the rank holds), ``rank_batch`` and
``device``.

A ``train_4k`` cell runs one rank's ``train/trainer.shard_train_step``
(``train_program``): the whole tree's specs by the training rules
(``DEFAULT_RULES``), the rank's shards of it (``data_shards``: the
tensor-parallel cut at the mesh's model axis, then the "data" shard of
every "D" leaf) and their AdamW moments, its rows of the global batch in
the reference's microbatches (``auto``: B // n_batch, one row a rank a
microbatch), and one step: the FSDP gather over ``data``, the forward and
backward with every tensor-parallel collective of
``distributed/collectives.py`` and its gradient, the gradients summed over
tp and data, the norm and the update. ``param_bytes_per_chip`` is then
the rank's parameter shards, ``opt_bytes_per_chip`` its moments. The
dense, VLM, encoder-decoder and xLSTM families run it; the production
meshes cut them in their own ways (internvl2-26b its 48 query heads and
not its 8 KV heads, whisper-base its ``d_ff`` and not its 8 heads,
xlstm-350m its vocabulary and its mLSTM values).

Cells the port cannot run are written the way the reference writes a cell
that fails, ``ok: false`` with the reason: ``train_4k`` of a family with
experts, the MoE family and the Jamba hybrid (tensor-parallel training of
them, ROADMAP queue 1, item 6.10b, and of the experts over a data axis,
6.11), serving
under ``--param-shard fsdp`` (FSDP-sharded serving weights, item 6.12),
and whatever the engines refuse at the mesh's tp.
``--all`` runs every applicable cell of both production meshes (the
reference's ``--all --both-meshes``). ``--out`` defaults to
``results/dryrun_torch.jsonl``; a cell already there is skipped.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, QuantConfig,
                                 cell_is_applicable, get_config)
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as DC
from repro_torch.distributed import sharding as SH
from repro_torch.launch import cost
from repro_torch.launch.mesh import dryrun_mesh, production_shape
from repro_torch.models.common import as_tree
from repro_torch.models.registry import build
from repro_torch.serving import engine as E
from repro_torch.train import trainer as TR

# one H100 SXM's published peaks (dense), per card
DEVICE = "NVIDIA H100 80GB HBM3 (SXM)"
PEAK_FLOPS_BF16 = 989e12
PEAK_OPS_INT8 = 1979e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9           # each way

# a train cell of a family that tensor-parallel training does not run
# (train/trainer.py check_data_parallel: the families with experts)
TRAIN_REFUSAL = TR.TP_TRAINING_LATER
FSDP_REFUSAL = ("FSDP-sharded serving weights (--param-shard fsdp): the "
                "port's engines hold tensor-parallel shards only, weights "
                "whole over the data axis (ROADMAP queue 1, item 6.12)")


def tensors(tree: Any) -> list:
    """Every tensor leaf of a tree (dicts, lists, tuples, dataclasses such
    as ``SiteScale``, ``ParamTree``s)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "tree") and callable(tree.tree):
        tree = tree.tree()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    return []


def tree_bytes(tree: Any) -> int:
    """The bytes of every tensor leaf of a tree."""
    return sum(cost.nbytes(t) for t in tensors(tree))


def spec_bytes(tree: Any, specs: Any, mesh) -> int:
    """The bytes one rank holds of ``tree`` laid out by ``specs`` (the
    reference's partition specs, ``distributed/sharding.py``): each dim
    divided by the mesh extent of its axes."""
    if isinstance(tree, torch.Tensor):
        n = tree.element_size()
        for dim, ax in zip(tree.shape, tuple(specs) + (None,) * tree.dim()):
            axes = () if ax is None else (ax if isinstance(ax, tuple)
                                          else (ax,))
            size = 1
            for a in axes:
                size *= mesh.shape[a]
            n *= dim // size
        return n
    if isinstance(tree, dict):
        return sum(spec_bytes(v, specs[k], mesh) for k, v in tree.items())
    return sum(spec_bytes(v, s, mesh) for v, s in zip(tree, specs))


def rank_rows(B: int, mesh) -> int:
    """The rows of a global batch of B one rank takes: B / n_batch, or B
    where the batch axes do not divide it (replicated, as the reference's
    ``batch_shardings``)."""
    n = 1 if mesh is None else int(mesh.data_size)
    return B // n if B % n == 0 else B


@dataclasses.dataclass
class Program:
    """One rank's serving call: the rank's API and tree, the cache, the
    inputs, and what the call takes beside them."""
    api: Any
    kind: str                       # "prefill" or "decode"
    params: Any
    cache: Any
    inputs: Dict[str, torch.Tensor]
    qcfg: QuantConfig
    cushion: Any = None
    scales: Any = None
    mesh: Any = None
    # the rank's parameter and cache bytes by the reference's specs
    spec_bytes: Optional[Dict[str, int]] = None

    def arguments(self) -> Dict[str, Any]:
        """The call's arguments by name (a decode step takes no
        cushion: the cache holds it)."""
        args = {"params": self.params, "cache": self.cache,
                "inputs": self.inputs, "scales": self.scales}
        if self.kind == "prefill":
            args["cushion"] = self.cushion
        return args

    def __call__(self):
        """The call itself, under the mesh's tp axis, without grad."""
        with torch.no_grad(), DC.use_tp(self.mesh):
            if self.kind == "prefill":
                return self.api.prefill(self.params, self.inputs, self.cache,
                                        self.qcfg, cushion=self.cushion,
                                        scales=self.scales)
            return self.api.decode_step(self.params, self.inputs["token"],
                                        self.inputs["pos"], self.cache,
                                        self.qcfg, scales=self.scales)


def serving_program(cfg: ModelConfig, kind: str, B: int, S: int, *,
                    mesh=None, quant: str = "none", qcfg=None,
                    cushion_m: int = 0, prequant: bool = False,
                    weight_bits: int = 8, kv_dtype=None,
                    max_seq: Optional[int] = None, device="meta",
                    params=None, cushion=None, scales=None) -> Program:
    """One rank's program of a serving call of ``kind`` at global batch B
    and S positions, the way the engines build it (see the module
    docstring): on meta by default, with shapes-only weights, zero
    cushion and placeholder scales; on another device from the given
    ``params`` (the whole tree), ``cushion`` and ``scales``. The cache
    holds ``max_seq`` positions (default S + cushion_m, the reference's);
    a decode step reads it at position S."""
    qcfg = qcfg or QuantConfig(mode=quant, true_int8=(quant == "pt_static"))
    tp = 1 if mesh is None else int(mesh.size)
    E.check_tp_serving(cfg, qcfg, tp, weight_bits)
    full = build(cfg, device)
    if params is None:
        params = full.init_params()
    if cushion_m and cushion is None:
        cushion = full.cushion_zeros(cushion_m)
    if qcfg.mode != "none" and scales is None:
        scales = full.mod.placeholder_all_scales(cfg, full.device)
    tree, scales = E.plan_quantization(full, params, qcfg, cushion=cushion,
                                       scales=scales, prequant=prequant,
                                       weight_bits=weight_bits)
    api = full
    m = E.cushion_prefix_len(cushion)
    spec = None
    if mesh is not None and full.device.type == "meta":
        whole = full.init_cache(B, max_seq or S + m, kv_dtype=kv_dtype,
                                prefix_len=m)
        spec = {"params": spec_bytes(tree, SH.params_shardings(
                    tree, mesh, SH.serve_rules()), mesh),
                "cache": spec_bytes(whole, SH.cache_shardings(
                    full.cache_roles(kv_dtype), whole, mesh), mesh)}
    if tp > 1:
        tree = E.shard_params_for_serving(tree, cfg, mesh)
        api = dataclasses.replace(full, cfg=E.tp_config(cfg, tp))
    rows = rank_rows(B, mesh)
    cache = E.tp_cache(api.init_cache(rows, max_seq or S + m,
                                      kv_dtype=kv_dtype, prefix_len=m),
                       cfg, api.cfg)
    if kind == "prefill":
        inputs = full.input_specs(rows, S)
        inputs.pop("labels")
        if full.device.type != "meta":
            inputs = {k: torch.zeros(v.shape, dtype=v.dtype,
                                     device=full.device)
                      for k, v in inputs.items()}
    else:
        inputs = {"token": torch.zeros((rows,), dtype=torch.int32,
                                       device=full.device),
                  "pos": torch.full((), S, dtype=torch.int32,
                                    device=full.device)}
    return Program(api=api, kind=kind, params=tree, cache=cache,
                   inputs=inputs, qcfg=qcfg, cushion=cushion, scales=scales,
                   mesh=mesh if tp > 1 else None, spec_bytes=spec)


def _keys(tree: Any) -> set:
    return {cost.storage_key(t) for t in tensors(tree)}


def measure(call, arguments: Dict[str, Any]) -> Dict[str, Any]:
    """Run ``call()`` (on meta tensors) under a tally; ``arguments``: its
    argument trees by name. Returns the cost, launches and memory (see the
    module docstring) and each argument's bytes."""
    args = {k: tree_bytes(v) for k, v in arguments.items()}
    arg_keys = _keys(list(arguments.values()))
    t0 = time.perf_counter()
    with cost.counting() as tally:
        out = call()
    seconds = time.perf_counter() - t0
    outs = tensors(out)
    alias = sum(cost.nbytes(t) for t in outs
                if cost.storage_key(t) in arg_keys)
    return {"cost": tally.cost, "launches": dict(tally.launches),
            "int8_flops": tally.int8_flops,
            "memory": {"argument_bytes": sum(args.values()),
                       "output_bytes": sum(cost.nbytes(t) for t in outs),
                       "temp_bytes": tally.peak,
                       "alias_bytes": alias},
            "arguments": args, "seconds": seconds}


def measure_program(program) -> Dict[str, Any]:
    """``measure`` of a serving or a train program."""
    return measure(program, program.arguments())


@dataclasses.dataclass
class TrainProgram:
    """One rank's train step: ``shard_train_step``'s function, the rank's
    shards and moments, the global batch."""
    fn: Any
    params: Any
    opt: Any
    inputs: Dict[str, torch.Tensor]
    # the rank's parameter bytes by the reference's specs
    spec_bytes: Optional[Dict[str, int]] = None

    def arguments(self) -> Dict[str, Any]:
        return {"params": self.params, "opt": self.opt,
                "inputs": self.inputs}

    def __call__(self):
        return self.fn(self.params, self.opt, self.inputs)


def train_program(cfg: ModelConfig, B: int, S: int, *, mesh,
                  quant: str = "none", cushion_m: int = 0,
                  microbatches="auto", device="meta",
                  params=None) -> TrainProgram:
    """One rank's ``shard_train_step`` of a train cell at global batch B
    and S positions on ``mesh`` (see the module docstring): on meta by
    default, with a shapes-only tree; on another device from the given
    whole tree ``params`` and a batch of zeros. AdamW at the reference's
    dry-run schedule; ``microbatches`` "auto" is the reference's B //
    n_batch."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.optim.adamw import AdamW, cosine_lr
    qcfg = QuantConfig(mode=quant, true_int8=(quant == "pt_static"))
    TR.check_data_parallel(cfg, int(mesh.data_size), int(mesh.size))
    api = build(cfg, device)
    whole = api.init_params().tree() if params is None \
        else as_tree(params)
    cushion = api.cushion_zeros(cushion_m) if cushion_m else None
    run = RunConfig(model=cfg, quant=qcfg, seq_len=S, global_batch=B)
    opt = AdamW(lr=cosine_lr(3e-4, 100, 1000))
    n_b = int(mesh.data_size)
    mb = max(1, B // n_b) if microbatches == "auto" else int(microbatches)
    fn, p_specs, _ = TR.shard_train_step(api, run, opt, mesh, whole,
                                         microbatches=mb, cushion=cushion)
    spec = None
    if api.device.type == "meta":
        spec = {"params": spec_bytes(whole, p_specs, mesh)}
    shards = TR.data_shards(whole, p_specs, mesh, cfg=cfg)
    del whole
    inputs = api.input_specs(B, S)
    if api.device.type != "meta":
        inputs = {k: torch.zeros(v.shape, dtype=v.dtype, device=api.device)
                  for k, v in inputs.items()}
    return TrainProgram(fn=fn, params=shards, opt=opt.init(shards),
                        inputs=inputs, spec_bytes=spec)


def train_step_cost(cfg: ModelConfig, B: int, S: int) -> Dict[str, Any]:
    """One step of ``train/trainer.make_train_step`` (one microbatch, remat
    on, ``none``, AdamW at the reference's dry-run schedule) on one device,
    on meta: ``measure``'s result. The reference lowers the same step with
    ``jax.grad``."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.optim.adamw import AdamW, cosine_lr
    from repro_torch.train.trainer import make_train_step
    api = build(cfg, "meta")
    run = RunConfig(model=cfg, seq_len=S, global_batch=B)
    opt = AdamW(lr=cosine_lr(3e-4, 100, 1000))
    params = api.init_params().tree()
    state = opt.init(params)
    step = make_train_step(api, run, opt)
    batch = api.input_specs(B, S)
    return measure(lambda: step(params, state, batch),
                   {"params": params, "opt": state, "inputs": batch})


def roofline(flops: float, int8_flops: float, nbytes: float,
             coll_bytes: float) -> Dict[str, float]:
    """The card's roofline terms of one rank's work, in seconds."""
    return {"compute_s": ((flops - int8_flops) / PEAK_FLOPS_BF16
                          + int8_flops / PEAK_OPS_INT8),
            "memory_s": nbytes / HBM_BW,
            "collective_s": coll_bytes / NVLINK_BW}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               quant: str = "none", cushion_m: int = 0,
               microbatch_policy: str = "auto", param_shard: str = "fsdp",
               prequant: bool = False) -> Dict[str, Any]:
    """The record of one cell (the reference's ``lower_cell`` +
    ``analyze``); raises what the port refuses."""
    cfg = get_config(arch)
    shape, axes = production_shape(multi_pod)
    mesh = dryrun_mesh(shape, axes)
    shp = SHAPES[shape_name]
    kind = shp["kind"]
    B, S = shp["global_batch"], shp["seq_len"]
    if kind == "train":
        # the training rules (FSDP and tensor parallel) at either flag, as
        # the reference's
        prog = train_program(cfg, B, S, mesh=mesh, quant=quant,
                             cushion_m=cushion_m,
                             microbatches=microbatch_policy)
    elif param_shard != "tp":
        raise NotImplementedError(FSDP_REFUSAL)
    else:
        prog = serving_program(cfg, kind, B, S, mesh=mesh, quant=quant,
                               cushion_m=cushion_m, prequant=prequant)
    got = measure_program(prog)
    record = analyze(got, arch, shape_name, multi_pod, kind, quant,
                     cushion_m, cfg, B, S, mesh, param_shard, prequant)
    record["param_bytes_spec_per_chip"] = prog.spec_bytes["params"]
    if kind == "train":
        record["opt_bytes_per_chip"] = got["arguments"]["opt"]
    else:
        record["cache_bytes_spec_per_chip"] = prog.spec_bytes["cache"]
    record["compile_s"] = round(got["seconds"], 1)
    record["param_shard"] = param_shard
    record["prequant"] = prequant
    return record


def analyze(got, arch, shape_name, multi_pod, kind, quant, cushion_m, cfg,
            B, S, mesh, param_shard="tp", prequant=False) -> Dict[str, Any]:
    """The reference's record from a ``measure`` result."""
    chips = 1
    for s in mesh.sizes:
        chips *= s
    c = got["cost"]
    flops, nbytes = c.flops, c.bytes
    terms = roofline(flops, got["int8_flops"], nbytes, c.collective_bytes)
    dom = max(terms, key=lambda k: terms[k])
    n_active = cfg.active_param_count()
    tokens = B * S if kind in ("train", "prefill") else B
    mult = 6 if kind == "train" else 2
    model_flops_per_chip = mult * n_active * tokens / chips
    return {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "quant": quant, "cushion_m": cushion_m,
        "chips": chips, "global_batch": B, "seq_len": S,
        "flops_per_chip": flops, "bytes_per_chip": nbytes,
        "xla_flops_per_chip": None, "xla_bytes_per_chip": None,
        "collective_bytes_per_chip": c.collective_bytes,
        "collective_counts": dict(c.collective_counts),
        "memory": got["memory"],
        "terms": terms, "dominant": dom,
        "model_flops_per_chip": model_flops_per_chip,
        "useful_flops_frac": (model_flops_per_chip / flops if flops
                              else None),
        "hlo_chars": 0,
        "params": cfg.param_count(), "active_params": n_active,
        "launches": got["launches"], "int8_flops_per_chip": got["int8_flops"],
        "param_bytes_per_chip": got["arguments"]["params"],
        "cache_bytes_per_chip": got["arguments"].get("cache", 0),
        "rank_batch": rank_rows(B, mesh), "device": DEVICE,
    }


def cells(args) -> list:
    """The (arch, shape, multi_pod) cells the flags ask for."""
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multipod]
    if args.all:
        return [(arch, shape, mp) for arch in ARCH_IDS for shape in SHAPES
                if cell_is_applicable(arch, shape) for mp in meshes]
    if not (args.arch and args.shape):
        raise SystemExit("give --arch and --shape, or --all")
    return [(args.arch, args.shape, mp) for mp in meshes]


def _key(r) -> tuple:
    return (r["arch"], r["shape"], r["mesh"], r["quant"],
            r.get("cushion_m", 0), r.get("param_shard", "fsdp"),
            r.get("prequant", False))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--quant", default="none")
    ap.add_argument("--cushion", type=int, default=0)
    ap.add_argument("--microbatches", default="auto")
    ap.add_argument("--param-shard", default="fsdp", choices=["fsdp", "tp"])
    ap.add_argument("--prequant", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    done.add(_key(json.loads(line)))
                except (ValueError, KeyError):
                    pass

    for arch, shape, mp in cells(args):
        mesh_name = "2x16x16" if mp else "16x16"
        key = (arch, shape, mesh_name, args.quant, args.cushion,
               args.param_shard, args.prequant)
        if key in done:
            print(f"[skip] {key}")
            continue
        print(f"[dryrun] {key} ...", flush=True)
        t0 = time.time()
        try:
            rec = lower_cell(arch, shape, mp, args.quant, args.cushion,
                             args.microbatches, args.param_shard,
                             args.prequant)
            rec["ok"] = True
        except Exception as e:  # noqa: BLE001 (the record says why)
            rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                   "quant": args.quant, "cushion_m": args.cushion,
                   "param_shard": args.param_shard,
                   "prequant": args.prequant, "ok": False,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        rec["wall_s"] = round(time.time() - t0, 1)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        status = "OK" if rec.get("ok") else "FAIL"
        print(f"[dryrun] {key} {status} ({rec['wall_s']}s)", flush=True)


if __name__ == "__main__":
    main()
