"""Static-batch serving engine, ported from ``repro/serving/engine.py``:
one prefill, then a decode loop, under a CushionCache prefix and a
configurable quantized execution (per-tensor static W8A8 with int8-resident
weights or W4A8 with int4-packed ones, the per-token dynamic baseline, an
int8 KV cache with the cushion kept in fp).

Each batch size B keeps one KV cache and one pair of step buffers (``tok``,
``pos``), which every request of that B resets and refills in place. The
greedy decode step (``decode_step``, the argmax, ``tok`` and ``pos``
updated in place) reads and writes only those. On the card it is captured
as a CUDA graph at the first request of its B (``serving/graphs.py``) and
replayed once per generated token: the counterpart of the reference's
jitted ``lax.scan``, the same kernels launched by one ``cudaGraphLaunch``
per step. The prefill runs eagerly, and so does the step on the CPU.

Tensor parallelism (``mesh``, a ``launch/mesh.TPMesh``; every family):
every rank runs an ``Engine`` on its shard of the model. The quantization
plan (calibration, ``prequantize_tree``) runs on the whole model on every
rank, then ``shard_params_for_serving`` keeps
the rank's shard; the rank serves through its own config (``tp_config``,
whose ``tp`` layout says which axes it holds a part of: ``tp_layout``)
and the collectives of ``distributed/collectives.py``. An axis that does
not divide by tp is whole on every rank, as the reference replicates it.
So every rank holds the whole model while it is built and planned: under
tp > 1 a model must still fit on one card (building and quantizing by
shard is ROADMAP queue 1, item 6.9; ranks may build in turn,
``defer_tree_check``). Under tp > 1 the decode step runs eagerly, by design: over gloo a
collective synchronizes with the host, which a CUDA graph cannot hold
(capturing NCCL collectives is later work, ROADMAP queue 1, item 6.6).
One rank (tp = 1) keeps the graph.

Tokens stay on the device through the decode loop; ``generate`` syncs with
the host twice per request (after prefill: TTFT; after the loop: TPOT).
Sampled generation runs the step eagerly (a graph would need the sampling
generator registered with it). ``generate_py`` keeps the per-token eager
host loop of the reference, which the graph's tokens are held to.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import (Family, ModelConfig, QuantConfig,
                                      TPLayout)
from repro_torch.core import quantization as Q
from repro_torch.core.calibration import CalibratedScales
from repro_torch.core.cushioncache import cushion_fingerprint
from repro_torch.distributed import collectives as DC
from repro_torch.distributed import sharding as SH
from repro_torch.models import common as C
from repro_torch.models import encdec as ED
from repro_torch.models import xlstm as XL
from repro_torch.monitoring import resident_weight_bytes
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serving.graphs import CapturedStep


def plan_quantization(api, params, qcfg: QuantConfig, cushion=None,
                      scales=None, calib_batches=None,
                      prequant: bool = False, weight_bits: int = 8):
    """Load-time quantization plan. Returns (params tree, scales):

    * a family that cannot serve the mode refuses it here (the
      encoder-decoder's head takes no scales: no ``pt_static``);
    * precomputed ``CalibratedScales`` are checked against the cushion being
      served and refused on a fingerprint mismatch (stale static ranges);
    * ``pt_static`` without scales calibrates over ``calib_batches`` under
      the cushion, and refuses to run with neither;
    * ``prequant`` makes every qdot-consumed weight integer-resident
      (pt_static only): int8 ``w_int`` with ``weight_bits=8``, int4-packed
      ``w_packed`` with ``weight_bits=4``, which exists only prequantized.
    """
    check = getattr(api.mod, "check_serving_quant", None)
    if check is not None:
        check(qcfg)
    if isinstance(scales, CalibratedScales):
        want, got = scales.cushion_fp, cushion_fingerprint(cushion)
        if want != got:
            raise ValueError(
                f"stale pt_static scales: calibrated under cushion "
                f"{want[:12]} but asked to serve cushion {got[:12]}; "
                f"recalibrate under the serving cushion (pass "
                f"calib_batches=) — refusing to serve mismatched static "
                f"ranges")
        scales = scales.scales
    if qcfg.mode == "pt_static" and scales is None:
        if calib_batches is None:
            raise ValueError(
                "pt_static serving needs calibrated site scales: pass "
                "scales= or calib_batches= to calibrate at engine load; "
                "refusing to serve on placeholder scales (silent garbage "
                "logits)")
        from repro_torch.core.calibration import calibrate
        scales, _ = calibrate(api, params, calib_batches, qcfg,
                              cushion=cushion)
    if weight_bits not in (8, 4):
        raise ValueError(f"weight_bits must be 8 or 4, got {weight_bits}")
    if weight_bits == 4 and not prequant:
        raise ValueError(
            "weight_bits=4 is the int4-packed resident format and only "
            "exists prequantized; pass prequant=True (fp and W8A8 remain "
            "the A/B baselines)")
    params = C.as_tree(params)
    if prequant:
        if qcfg.mode != "pt_static":
            raise ValueError(
                f"prequant (int8-resident weights) serves the pt_static "
                f"deployment mode only, got mode={qcfg.mode!r}")
        params = Q.prequantize_tree(params, qcfg, weight_bits=weight_bits)
    return params, scales


def tp_layout(cfg: ModelConfig, tp: int) -> TPLayout:
    """Which axes of ``cfg`` ``tp`` ranks cut, by the reference's serve
    rules: an axis is cut where the specs of its leaves
    (``SH.params_shardings(..., SH.serve_rules())``) name ``tp``, and whole
    where ``_drop_indivisible`` dropped it (the axis does not divide by
    tp). The query heads are cut where the fused ``wqkv`` columns and
    ``wo``'s rows divide and whole heads do too; the KV heads where they
    divide as well (the cache's spec, ``cache_roles``), else every rank
    holds all of them, as the reference's replicated cache. The experts
    where E divides (``moe/w_*``), the Mamba channels where ``inner``
    does (``mamba/w_out``'s rows and the state's roles).

    The xLSTM: the reference's rules for its blocks (``xlstm/w_...``)
    match no path of the family (``layers/mlstm/w_qkv``, ...), so every
    block weight is whole and only the vocabulary is cut. Its state is
    cut where the roles name tp and no collective a position follows:
    the mLSTM memory ``C`` on its value axis ("values", where the head
    width divides; ``models/xlstm.cache_roles``)."""
    hd, H, K = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    cut = []
    if cfg.family == Family.SSM:
        if cfg.vocab_size % tp == 0:
            cut.append("vocab")
        if XL.dims(cfg)[2] % tp == 0:
            cut.append("values")
        return TPLayout(size=tp, cut=tuple(cut), n_heads=H)
    if (H + 2 * K) * hd % tp == 0 and H % tp == 0:
        cut.append("heads")
        if K % tp == 0:
            cut.append("kv_heads")
    if cfg.d_ff and cfg.d_ff % tp == 0:
        cut.append("d_ff")
    if cfg.vocab_size % tp == 0:
        cut.append("vocab")
    if cfg.moe is not None and cfg.moe.num_experts % tp == 0:
        cut.append("experts")
    if cfg.family == Family.HYBRID and cfg.ssm is not None \
            and cfg.ssm.expand * cfg.d_model % tp == 0:
        cut.append("inner")
    return TPLayout(size=tp, cut=tuple(cut), n_heads=H)


# the families whose serving cache is per-request state (no sequence
# axis to page), as in the reference
_UNPAGED = (Family.SSM, Family.ENCDEC)


def check_tp_serving(cfg: ModelConfig, qcfg: QuantConfig, tp: int,
                     weight_bits: int = 8, data: int = 1,
                     paged: bool = False) -> None:
    """Refuse what tensor-parallel serving does not serve: what one rank
    refuses as well and a launcher must refuse before it spawns (the
    encoder-decoder's ``pt_static``, ``encdec.check_serving_quant``; a
    paged pool of the xLSTM or the encoder-decoder, whose cache is
    per-request state with nothing to page); a rank whose query heads
    straddle KV groups of a whole cache (ROADMAP queue 1, item 6.5b); and
    a mesh with a data axis of more than one rank, on which the reference
    never serves (its data-parallel serving is the router's replicas, one
    ``(data=1, tp)`` mesh each: ``launch/mesh.make_replica_meshes``).
    W4A8 and the dynamic modes serve at any tp; axes that do not divide by
    tp are served whole on every rank (``tp_layout``). One rank takes
    anything else."""
    if data > 1:
        raise ValueError(
            f"serving on a mesh with a data axis of {data} ranks: the "
            f"reference serves data-parallel only as the router's replicas, "
            f"each on a (data=1, tp) mesh of its own (make_replica_meshes, "
            f"ReplicaRouter(meshes=))")
    if tp == 1:
        return
    if cfg.family == Family.ENCDEC:
        ED.check_serving_quant(qcfg)
    if paged and cfg.family in _UNPAGED:
        raise ValueError(
            f"tensor parallelism (tp={tp}): a paged pool of the "
            f"{cfg.family.value} family, whose cache is per-request state "
            f"with nothing to page (the reference refuses it at every tp)")
    H, K = cfg.n_heads, cfg.n_kv_heads
    lay = tp_layout(cfg, tp)
    if "heads" in lay.cut and "kv_heads" not in lay.cut and tp % K:
        # the KV heads are whole on every rank; a rank's H/tp query heads
        # must lie in one KV group (tp a multiple of K) for the attention
        # kernels' slice of the cache
        raise ValueError(
            f"tensor parallelism (tp={tp}): n_heads={H}, n_kv_heads={K}: a "
            f"rank's {H // tp} query heads straddle the groups of the whole "
            f"KV heads, which the attention kernels' KV-head slice does not "
            f"map yet (ROADMAP queue 1, item 6.5b)")


def tp_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """One rank's config over ``tp`` ranks (``tp_layout``): H/tp query
    heads and K/tp KV heads (or all K where the KV heads are whole), d_ff/tp
    and vocab/tp where they are cut, the head width kept. The experts and
    the Mamba channels keep the whole model's counts here (every rank
    routes over all experts; ``ssm.dims`` divides ``inner``); ``tp`` says
    what is cut."""
    if tp == 1:
        return cfg
    lay = tp_layout(cfg, tp)
    kw = dict(tp=lay, d_head=cfg.head_dim)
    if "heads" in lay.cut:
        kw["n_heads"] = cfg.n_heads // tp
        if "kv_heads" in lay.cut:
            kw["n_kv_heads"] = cfg.n_kv_heads // tp
    if "d_ff" in lay.cut:
        kw["d_ff"] = cfg.d_ff // tp
    if "vocab" in lay.cut:
        kw["vocab_size"] = cfg.vocab_size // tp
    return dataclasses.replace(cfg, **kw)


def _qkv_columns(cfg: ModelConfig, rank: int, tp: int, device
                 ) -> torch.Tensor:
    """A rank's columns of the fused qkv projection [q heads | k heads |
    v heads]: its query heads, then its KV heads for k and for v, or every
    KV head where they are whole (``tp_layout``)."""
    hd, H, K = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    Hl = H // tp
    Kl, k0 = (K // tp, rank * (K // tp)) \
        if "kv_heads" in tp_layout(cfg, tp).cut else (K, 0)
    ar = torch.arange
    return torch.cat([ar(rank * Hl * hd, (rank + 1) * Hl * hd),
                      H * hd + ar(k0 * hd, (k0 + Kl) * hd),
                      (H + K) * hd + ar(k0 * hd, (k0 + Kl) * hd)]
                     ).to(device)


def _xz_columns(inner: int, rank: int, tp: int, device) -> torch.Tensor:
    """A rank's columns of the Mamba in-projection [x | z]: its channels
    of each half."""
    n = inner // tp
    ar = torch.arange(rank * n, (rank + 1) * n)
    return torch.cat([ar, inner + ar]).to(device)


# Each leaf's logical axis (``tp_layout``), the dim it lies on, counted
# from the end (the hybrid's and the stacked layers' leading axes come
# first), and how a rank takes its part: a block of the dim, or its heads
# of the fused qkv columns, or its channels of each half of the Mamba
# in-projection. The first match wins (by ``search``, as the reference's
# rules: ``attn/wo$`` cuts the encoder-decoder's ``xattn/wo`` by rows too),
# and a leaf that matches none is whole on every rank (the norms,
# ``moe/router``, ``moe/residual``, the cross-attention's ``xattn/wq`` and
# ``xattn/wkv``, which ``attn/wqkv$`` misses, and every xLSTM block
# weight: the reference's rules replicate them). ``w_int`` cuts like its
# parent; ``colsum`` with its parent's columns, so it is whole at the
# row-parallel sites; ``w_scale`` (the whole weight's) is whole.
_LEAF_AXES = (
    (re.compile(r"attn/(wqkv|bqkv)$"), "heads", -1, "qkv"),
    (re.compile(r"attn/wo$"), "heads", -2, "block"),
    (re.compile(r"mlp/w_(gate|up)$"), "d_ff", -1, "block"),
    (re.compile(r"mlp/w_down$"), "d_ff", -2, "block"),
    (re.compile(r"(^|/)embed(/w)?$"), "vocab", -2, "block"),
    (re.compile(r"(^|/)(lm_)?head(/w)?$"), "vocab", -1, "block"),
    (re.compile(r"moe/w_(gate|up|down)$"), "experts", -3, "block"),
    (re.compile(r"mamba/w_in$"), "inner", -1, "xz"),
    (re.compile(r"mamba/(w_out|A_log)$"), "inner", -2, "block"),
    (re.compile(r"mamba/(conv_w|conv_b|dt_w|dt_b|Dskip)$"), "inner", -1,
     "block"),
)


def leaf_cut(path: str, cfg: ModelConfig, tp: int):
    """(the logical axis, the dim, how) a rank cuts of the leaf at
    ``path`` (``_LEAF_AXES``), or None where the leaf is whole on every
    rank."""
    base = re.sub(r"/(w_int|w_packed|colsum|w_scale)$", "", path)
    kind = path[len(base) + 1:]
    if kind == "w_scale":
        return None
    for rx, axis, dim, how in _LEAF_AXES:
        if rx.search(base):
            if axis not in tp_layout(cfg, tp).cut \
                    or (kind == "colsum" and dim != -1):
                return None
            return axis, dim, how
    return None


class TPPart(NamedTuple):
    """How a rank holds one leaf of its tree in tensor-parallel training:
    the leading ``own`` entries of its last axis are the rank's part of a
    leaf cut over tp (-1: all of it; 0: none, the leaf whole on every
    rank); ``summed``: the rest, whole on every rank, is read in part (each
    rank's program reads some of it, so its gradient is the rank's share,
    summed over tp where the gradients meet the optimizer)."""
    own: int
    summed: bool


# the encoder-decoder's cross-attention leaves that stay whole on every
# rank and are read through the rank's windows of their columns where the
# heads are cut (``encdec.cross_attention`` / ``enc_kv``)
_XATTN_WINDOWED = re.compile(r"xattn/(wq|wkv)$")


def tp_leaf_parts(params: Any, cfg: ModelConfig, tp: int) -> Any:
    """``TPPart`` of every leaf of a parameter tree at ``tp`` (the
    training layout, ``shard_tree``'s cut): a leaf ``leaf_cut`` cuts is the
    rank's; the fused ``wqkv`` / ``bqkv`` where the query heads are cut
    and the KV heads whole holds the rank's query columns, then every KV
    head's, whose gradient is summed (a KV head's query heads lie on
    several ranks: deepseek-67b at tp = 16); the encoder-decoder's whole
    ``xattn/wq`` and ``xattn/wkv`` where the heads are cut, read through
    the rank's windows, are summed whole (their gradients zero outside the
    windows); every other leaf is whole and read whole (the norms,
    smollm-360m's attention at tp = 2, whose 15 heads every rank computes
    whole, whisper-base's cross-attention at tp = 16, every xLSTM block
    weight: no sum, which would double it)."""
    lay = tp_layout(cfg, tp)
    kv_whole = "heads" in lay.cut and "kv_heads" not in lay.cut
    own_q = cfg.n_heads // tp * cfg.head_dim

    def part(path):
        c = leaf_cut(path, cfg, tp) if tp > 1 else None
        if c is None:
            windowed = tp > 1 and "heads" in lay.cut \
                and _XATTN_WINDOWED.search(path) is not None
            return TPPart(0, windowed)
        if c[2] == "qkv" and kv_whole:
            return TPPart(own_q, True)
        return TPPart(-1, False)

    def visit(node):
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v) for v in node]
        return part(node)
    return visit(SH.tree_paths(params))


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_checksum(tree: Any) -> torch.Tensor:
    """(2,) int64 on the leaves' device: the sum of every leaf's 32-bit
    words (bytes where a leaf's size is not a multiple of 4), and the sum
    of the odd-indexed ones, in 64 MiB pieces."""
    total = None
    piece = 1 << 26
    for leaf in _leaves(tree):
        b = leaf.detach().contiguous().reshape(-1).view(torch.uint8)
        for i in range(0, b.numel(), piece):
            c = b[i:i + piece]
            w = c.view(torch.int32) if c.numel() % 4 == 0 else c
            w = w.to(torch.int64)
            part = torch.stack([w.sum(), w[1::2].sum()])
            total = part if total is None else total + part
    return total


def check_tree_sums(mine: torch.Tensor, mesh) -> None:
    """Every rank built the same tree: rank 0's checksum (``tree_checksum``
    of its whole tree), broadcast, equals each rank's; all ranks raise
    together if not. A collective: every rank of ``mesh`` calls it."""
    import torch.distributed as dist
    mine = mine.to(mesh.device)
    theirs = mine.clone()
    dist.broadcast(theirs, src=int(getattr(mesh, "base", 0)),
                   group=mesh.group)
    ok = torch.tensor([int(torch.equal(mine, theirs))], dtype=torch.int64,
                      device=mesh.device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=mesh.group)
    if not int(ok.item()):
        raise RuntimeError("tensor-parallel ranks built different parameter "
                           "trees (checksums differ): every rank must make "
                           "the same tree from the same seed")


def check_same_tree(tree: Any, mesh) -> None:
    """Every rank holds the same tree (one check at load; none on the
    dry-run's mesh, whose one rank has no peers)."""
    if mesh.size > 1 and mesh.device.type != "meta":
        check_tree_sums(tree_checksum(tree), mesh)


def shard_params_for_serving(params: Any, cfg: ModelConfig, mesh,
                             defer_check: bool = False):
    """The rank's shard of a parameter tree (quantized whole first, when
    int-resident), laid out by the reference's serve rules
    (``distributed/sharding.py``, ``tp_layout``, ``shard_tree``). The
    ranks' trees are checked equal first; with ``defer_check`` no
    collective runs and ``(shard, checksum)`` is returned, for
    ``check_tree_sums`` once every rank has built (ranks that build in
    turn, so that one card holds one whole tree at a time). The shards are
    copies, so the whole tree can be freed."""
    params = C.as_tree(params)
    if mesh.size == 1:
        return (params, None) if defer_check else params
    if defer_check:
        return shard_tree(params, cfg, mesh), tree_checksum(params)
    check_same_tree(params, mesh)
    return shard_tree(params, cfg, mesh)


def shard_tree(params: Any, cfg: ModelConfig, mesh) -> Any:
    """Rank ``mesh.rank``'s shard of ``params`` of ``mesh.size`` ranks
    (``shard_params_for_serving`` without its check; ``mesh`` needs only
    ``rank`` and ``size``). Each leaf is cut on its logical axis where
    ``tp_layout`` cuts that axis (``leaf_cut``), which is where the
    reference's spec (``SH.params_shardings``) cuts it, with these
    differences, each forced by computing whole heads and channels on a
    rank:

    * ``wqkv`` / ``bqkv``: the spec cuts the fused columns in contiguous
      blocks; a rank takes its query heads, then its KV heads (or every
      KV head, where they do not divide) for k and for v
      (``_qkv_columns``). With whole KV heads the spec replicates the
      cache, and so does the port: each rank computes all of them.
    * ``wo`` where the fused columns or whole heads do not divide: the
      spec may still cut its rows; the port keeps attention whole.
    * ``mamba/w_in``: the spec cuts its (D, 2 inner) columns contiguously
      (rank 0 all of x, rank 1 all of z); a rank takes its channels of
      each half (``_xz_columns``).
    * ``mamba/A_log`` (inner, N): the spec cuts its last axis; a rank
      takes its channels' rows.
    * ``mamba/w_x`` (inner, R + 2N): the spec cuts its last axis; it is
      whole on every rank, which forms the whole projection from the
      ranks' gathered channels (``models/ssm.py``).
    * ``mamba/conv_b``: the spec replicates it; a rank takes its
      channels, as of ``conv_w``.
    * W4A8's group scales ``w_scale`` (G, N): the spec replicates them; a
      rank takes its columns where the weight's columns are cut, and keeps
      them whole where its rows are (the row-parallel sites read their
      groups' rows, ``core/quantization.py``).

    Shards are copies, so the whole tree can be freed."""
    tp, r = mesh.size, mesh.rank
    paths = SH.tree_paths(params)
    index = {}

    def columns(how, device):
        idx = index.get((how, device))
        if idx is None:
            idx = index[how, device] = (
                _qkv_columns(cfg, r, tp, device) if how == "qkv" else
                _xz_columns(cfg.ssm.expand * cfg.d_model, r, tp, device))
        return idx

    def cut(leaf, path):
        c = leaf_cut(path, cfg, tp)
        if path.endswith("/w_scale") and leaf.dim() >= 2:
            # W4A8's (G, N) group scales follow the weight's columns
            c = leaf_cut(path[:-len("w_scale")] + "w_packed", cfg, tp)
            if c is not None and c[1] != -1:
                c = None
        if c is None:
            return leaf
        _, dim, how = c
        dim %= leaf.dim()
        if how != "block":
            return leaf.index_select(dim, columns(how, leaf.device))
        n = leaf.shape[dim] // tp
        return leaf.narrow(dim, r * n, n).clone()

    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(node[k], path[k]) for k in node}
        if isinstance(node, list):
            return [visit(a, b) for a, b in zip(node, path)]
        return cut(node, path)
    return visit(params, paths)


def tp_cache(cache: Dict[str, Any], full_cfg: ModelConfig,
             cfg: ModelConfig) -> Dict[str, Any]:
    """A rank's cache from its config's (``cfg``) ``init_cache``: where the
    KV heads are cut, an int8 cache's cushion block kc / vc becomes whole
    (the full config's KV heads, replicated on every rank, as the
    reference's roles) beside kc_tp / vc_tp, the rank's slice that decode
    reads. Where they are whole, the cache is whole on every rank."""
    if cfg.tp is None or "kv_heads" not in cfg.tp.cut or "kc" not in cache:
        return cache
    for key in ("kc", "vc"):
        local = cache[key]
        cache[key + "_tp"] = local
        cache[key] = local.new_zeros((*local.shape[:2],
                                      full_cfg.n_kv_heads, local.shape[3]))
    return cache


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, n_gen)
    ttft_ms: float
    tpot_ms: float


def cache_seq_len(max_seq: int) -> int:
    """Round a KV-cache length up to a multiple of 128 (the decode kernels'
    chunking in the reference; kept so caches have the same shape)."""
    return -(-max_seq // 128) * 128


def cushion_prefix_len(cushion) -> int:
    """Length m of the cushion prefix block (0 when absent)."""
    if cushion is not None and "kv" in cushion:
        return int(cushion["kv"]["k"].shape[1])
    return 0


def bucket_steps(n_steps: int) -> int:
    """Round a step budget up to the next power of two (min 8). The
    reference compiles one decode ``lax.scan`` per bucket, because XLA
    compiles per scan length; the port replays one captured step per token
    and needs no bucket for decode. The continuous engine buckets its
    chunked-prefill budgets with it."""
    if n_steps <= 0:
        return 0
    b = 8
    while b < n_steps:
        b *= 2
    return b


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class DecodeState:
    """The fixed decode state of one batch size: the KV cache, the last
    tokens ``tok`` ((B,) int32) and their position ``pos`` (() int32).
    ``step`` is one greedy step over them, in place: the replay of
    ``graph`` on the card, the eager step on the CPU."""
    cache: Dict[str, torch.Tensor]
    tok: torch.Tensor
    pos: torch.Tensor
    step: Optional[Callable[[], None]] = None
    graph: Optional[CapturedStep] = None


class Engine:
    """Serves one (model, quant, cushion, kv_dtype) configuration on the
    API's device. The parameters live in ``self.params``, a ``ParamTree``
    module (stacked ``(L, ...)`` buffers); ``states`` holds the decode state
    of every batch size served so far. ``mesh``: this rank's
    ``launch/mesh.TPMesh`` (see the module docstring); ``self.api`` is then
    the rank's (``tp_config``), ``self.full_cfg`` the model's.
    ``defer_tree_check``: the engine is made without a collective (ranks
    that build in turn) and keeps its whole tree's checksum in
    ``tree_sum`` for ``check_tree_sums``."""

    def __init__(self, api, params, qcfg: QuantConfig, cushion=None,
                 scales=None, max_seq: int = 2048, kv_dtype=None,
                 calib_batches=None, prequant: bool = False,
                 weight_bits: int = 8, mesh=None,
                 defer_tree_check: bool = False):
        self.mesh = mesh
        self.tp = 1 if mesh is None else mesh.size
        check_tp_serving(api.cfg, qcfg, self.tp, weight_bits,
                         1 if mesh is None else mesh.data_size)
        self.full_cfg = api.cfg
        self.device = api.device
        tree, scales = plan_quantization(
            api, params, qcfg, cushion=cushion, scales=scales,
            calib_batches=calib_batches, prequant=prequant,
            weight_bits=weight_bits)
        self.tree_sum = None
        if mesh is not None:
            if defer_tree_check:
                tree, self.tree_sum = shard_params_for_serving(
                    tree, api.cfg, mesh, defer_check=True)
            else:
                tree = shard_params_for_serving(tree, api.cfg, mesh)
            api = dataclasses.replace(api, cfg=tp_config(api.cfg, self.tp))
        self.api = api
        self.params = C.ParamTree(tree)
        (self.weight_bytes_fp, self.weight_bytes_int8,
         self.weight_bytes_int4) = resident_weight_bytes(tree)
        self.qcfg = qcfg
        self.cushion = cushion
        self.scales = scales
        self.max_seq = cache_seq_len(max_seq)
        self.kv_dtype = kv_dtype
        self.prefix_len = cushion_prefix_len(cushion)
        self.cushion_fp = cushion_fingerprint(cushion)
        self.states: Dict[int, DecodeState] = {}

    def _decode(self, tok, pos, cache):
        return self.api.decode_step(self.params.tree(), tok, pos, cache,
                                    self.qcfg, scales=self.scales)

    def _init_cache(self, B: int):
        return tp_cache(self.api.init_cache(B, self.max_seq,
                                            kv_dtype=self.kv_dtype,
                                            prefix_len=self.prefix_len),
                        self.full_cfg, self.api.cfg)

    def _state(self, B: int) -> DecodeState:
        """B's decode state, made at the first request of that B. On the
        card its step is captured then, on the fresh cache, which every
        request resets before its prefill."""
        st = self.states.get(B)
        if st is not None:
            return st
        st = DecodeState(
            cache=self._init_cache(B),
            tok=torch.zeros((B,), dtype=torch.int32, device=self.device),
            pos=torch.zeros((), dtype=torch.int32, device=self.device))

        def step():
            logits, _ = self._decode(st.tok, st.pos, st.cache)
            st.tok.copy_(torch.argmax(logits, dim=-1))
            st.pos.add_(1)

        if self.device.type == "cuda" and self.tp == 1:
            st.graph = CapturedStep(step, self.device)
            st.step = st.graph.replay
        else:
            # the CPU, and tp > 1 (eager by design: module docstring)
            st.step = step
        self.states[B] = st
        return st

    def _run_prefill(self, batch: Dict[str, Any]):
        """Prefill + first token into the batch size's decode state, its
        cache first reset to what ``init_cache`` makes. Returns (state,
        ttft_ms)."""
        B = batch["tokens"].shape[0]
        st = self._state(B)
        # every leaf, those of a nested state tree too (the xLSTM's)
        for old, new in zip(tree_leaves(st.cache),
                            tree_leaves(self._init_cache(B))):
            old.copy_(new)
        _sync(self.device)
        t0 = time.perf_counter()
        logits, _, pos = self.api.prefill(
            self.params.tree(), batch, st.cache, self.qcfg,
            cushion=self.cushion, scales=self.scales)
        logits = logits[:, -1] if logits.dim() == 3 else logits
        st.tok.copy_(torch.argmax(logits, dim=-1))
        st.pos.copy_(pos)
        _sync(self.device)          # host sync 1: TTFT
        return st, (time.perf_counter() - t0) * 1e3

    @staticmethod
    def _next(logits, greedy: bool, gen: Optional[torch.Generator]):
        if greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)

    @torch.inference_mode()
    def generate(self, batch: Dict[str, Any], n_tokens: int,
                 greedy: bool = True,
                 generator: Optional[torch.Generator] = None
                 ) -> GenerationResult:
        with DC.use_tp(self.mesh):
            return self._generate(batch, n_tokens, greedy, generator)

    def _generate(self, batch, n_tokens, greedy, generator
                  ) -> GenerationResult:
        """Greedy: the decode state's step (the captured graph on the card)
        run ``n_tokens - 1`` times, each token copied into a trajectory on
        the device. Categorical sampling from ``generator`` (a
        ``torch.Generator`` on the engine's device) when ``greedy`` is
        False: the eager step."""
        st, ttft = self._run_prefill(batch)
        t1 = time.perf_counter()
        if greedy or generator is None:
            out = torch.empty((st.tok.shape[0], max(1, n_tokens)),
                              dtype=torch.int32, device=self.device)
            out[:, 0] = st.tok
            for i in range(1, n_tokens):
                st.step()
                out[:, i] = st.tok
        else:
            tok, pos, toks = st.tok, st.pos, [st.tok]
            for _ in range(n_tokens - 1):
                logits, _ = self._decode(tok, pos, st.cache)
                tok = self._next(logits, False, generator)
                pos = pos + 1
                toks.append(tok)
            out = torch.stack(toks, dim=1)
        out = out.cpu()                         # host sync 2: the loop
        tpot = (0.0 if n_tokens <= 1
                else (time.perf_counter() - t1) * 1e3 / (n_tokens - 1))
        return GenerationResult(tokens=out.numpy(), ttft_ms=ttft,
                                tpot_ms=tpot)

    @torch.inference_mode()
    def generate_py(self, batch: Dict[str, Any], n_tokens: int,
                    greedy: bool = True,
                    generator: Optional[torch.Generator] = None
                    ) -> GenerationResult:
        """Per-token eager host loop (one device-to-host copy per token),
        the reference's baseline for the decode benchmarks."""
        with DC.use_tp(self.mesh):
            return self._generate_py(batch, n_tokens, greedy, generator)

    def _generate_py(self, batch, n_tokens, greedy, generator
                     ) -> GenerationResult:
        st, ttft = self._run_prefill(batch)
        tok, pos = st.tok, st.pos
        out = [tok.cpu().numpy()]
        t1 = time.perf_counter()
        g = bool(greedy or generator is None)
        for _ in range(n_tokens - 1):
            logits, _ = self._decode(tok, pos, st.cache)
            tok = self._next(logits, g, generator)
            pos = pos + 1
            out.append(tok.cpu().numpy())
        tpot = (0.0 if n_tokens <= 1
                else (time.perf_counter() - t1) * 1e3 / (n_tokens - 1))
        return GenerationResult(tokens=np.stack(out, 1), ttft_ms=ttft,
                                tpot_ms=tpot)
