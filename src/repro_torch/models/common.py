"""Shared model components, ported from ``repro/models/common.py``: norms,
RoPE, the quantized linear with activation taps, GQA attention over a
CushionCache prefix (full sequence and single-token decode), the MLP, the
embedding and the head.

Conventions
-----------
* Parameters are nested dicts of tensors (and lists, where the hybrid
  family keeps its sublayers), layer leaves stacked over layers as
  ``(L, ...)``; ``ParamTree`` is the ``nn.Module`` that owns them.
* Every linear runs through ``qlinear`` (quantizer + optional taps).
* ``scales`` maps site names to ``SiteScale`` leaves (``(L,)`` stacked).
* The cushion prefix enters attention as per-layer KV ``prefix_kv``
  (dict(k=(m, K, hd), v=(m, K, hd))), fully visible to every query.
* On the card, prefill attention runs the ``flash_attention`` kernel (and,
  under autograd, its backward ``flash_attention_bwd``) and decode
  attention the ``flash_decode`` / ``flash_decode_paged`` kernels
  (``kernels/ops.py``); on the CPU their plain versions.
* ``groups`` (the linears, attention, the MLP, the head, the forward): the
  batch is ``groups`` independent forwards stacked along B, each
  ``B / groups`` rows (the reference's ``vmap`` over search candidates);
  dynamic per-tensor ranges and L_q reduce per group. 1 (the default) is
  one forward.
* Tensor parallelism (a mesh of several ranks active,
  ``distributed/collectives.py``): the config is the rank's
  (``serving/engine.tp_config``) and the parameters its shards; its
  ``tp`` layout says which axes are cut (``tp_cut``), and a collective
  runs only where a contracting axis was cut. Attention runs on the
  rank's query heads as it is, over its KV heads, or over the whole
  cache's where the KV heads do not divide (``kv_window``). A
  row-parallel linear (``wo``, ``w_down``) sums its partial products over
  the ranks where its rows are cut; a cut embedding looks up the rank's
  vocabulary rows and sums, a cut head's logits are gathered
  (``gather_last``); whole ones take no collective. Decode attention runs
  ``ops.decode_attention_tp`` / ``decode_attention_tp_paged``. A leaf the
  reference keeps whole but whose output the rank needs only a part of
  is read through a window of its columns (``rank_window``). Under
  autograd (tensor-parallel training, ``train/trainer.py``) a replicated
  activation enters a site whose output columns are cut through
  ``collectives.copy_to_tp`` (``qlinear``'s ``x_tp``, ``copy_to_cut``),
  whose backward sums the ranks' partial gradients; the row-parallel sums
  pass the gradient through whole; a row-parallel site's taps are the
  ranks' (``Q.site_taps(..., cut=)``).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core import quantization as Q
from repro_torch.distributed import collectives as DC
from repro_torch.kernels import ops

Tensor = torch.Tensor
Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Parameter container
# ---------------------------------------------------------------------------

def _children(tree: Any) -> Iterator[Tuple[Any, Any]]:
    """(key, child) pairs of a dict, or (index, child) of a list."""
    return iter(tree.items() if isinstance(tree, dict) else enumerate(tree))


def _flatten(tree: Any, path: Tuple[Any, ...] = ()
             ) -> Iterator[Tuple[Tuple[Any, ...], Tensor]]:
    for k, v in _children(tree):
        if isinstance(v, (dict, list)):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), v


def _skeleton(tree: Any, path: Tuple[Any, ...] = ()) -> Any:
    """The tree's shape with every leaf replaced by its buffer name."""
    if isinstance(tree, dict):
        return {k: _skeleton(v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v, path + (i,)) for i, v in enumerate(tree)]
    return "__".join(str(k) for k in path)


class ParamTree(nn.Module):
    """The model's parameters as one ``nn.Module``: every leaf of the nested
    dict is a buffer with no gradient (serving and prefix tuning hold the
    model frozen: ``core/cushioncache.py`` ``prefix_tune`` trains only the
    cushion), layer leaves stacked ``(L, ...)``. Full-parameter training
    (``train/trainer.py``) takes the weights as the plain nested dict of
    ``tree()`` and differentiates fresh leaves of its own; no buffer here
    ever requires a gradient. A list node (the hybrid's sublayers,
    ``params["layers"]["sub"]``) takes its index as a path component and
    comes back a list. ``.to(device)`` moves them; ``tree()`` is the
    nested view the model functions take."""

    def __init__(self, tree: Params):
        super().__init__()
        for path, leaf in _flatten(tree):
            self.register_buffer("__".join(str(k) for k in path), leaf)
        self._skel = _skeleton(tree)

    def tree(self) -> Params:
        def fill(node):
            if isinstance(node, dict):
                return {k: fill(v) for k, v in node.items()}
            if isinstance(node, list):
                return [fill(v) for v in node]
            return getattr(self, node)
        return fill(self._skel)


def as_tree(params) -> Params:
    return params.tree() if isinstance(params, ParamTree) else params


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, rematerialized in the backward when ``remat`` is true
    and autograd is recording: ``torch.utils.checkpoint.checkpoint`` (not
    reentrant) keeps the inputs and runs ``fn`` again when the gradient
    needs its intermediates, as the reference's ``jax.checkpoint(body)``
    does for each layer body of its scan. Every other case (serving,
    prefill, ``no_grad``) is a plain call."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def unstack(tree: Any, n: int) -> List[Any]:
    """Split a tree of ``(n, ...)``-stacked leaves into n per-layer trees of
    views (SiteScale leaves included)."""
    if isinstance(tree, Q.SiteScale):
        return [Q.SiteScale(s, z) for s, z in
                zip(tree.scale.unbind(0), tree.zero.unbind(0))]
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, list):
        parts = [unstack(v, n) for v in tree]
        return [[p[i] for p in parts] for i in range(n)]
    return list(tree.unbind(0))


def stack_trees(trees: List[Any]) -> Any:
    """Inverse of ``unstack`` for trees of dicts, lists and tensors."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], list):
        return [stack_trees([t[j] for t in trees])
                for j in range(len(trees[0]))]
    if len(trees) == 1:
        # a view, no copy: one period of a model at full width holds its
        # weights once while they are made
        return trees[0].unsqueeze(0)
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

class ShapesOnly:
    """The generator of a shapes-only init (the dry-run's ``meta`` tree):
    ``device`` is meta, and every draw is an empty meta tensor. A
    ``torch.Generator`` has no meta device."""
    device = torch.device("meta")


def draw(gen, shape, rand=torch.randn) -> Tensor:
    """An f32 draw of ``rand`` (``torch.randn`` or ``torch.rand``) of
    ``shape`` from ``gen`` on its device; empty on meta for
    ``ShapesOnly``."""
    if isinstance(gen, ShapesOnly):
        return torch.empty(shape, dtype=torch.float32, device=gen.device)
    return rand(shape, generator=gen, device=gen.device, dtype=torch.float32)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float = 1.0) -> Tensor:
    std = scale / np.sqrt(d_in)
    w = draw(gen, (d_in, d_out))
    return (w * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_init(cfg: ModelConfig, device, d: Optional[int] = None) -> Params:
    d = d or cfg.d_model
    p = {"g": torch.ones((d,), dtype=dtype_of(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros((d,), dtype=dtype_of(cfg), device=device)
    return p


def apply_norm(p: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        y = y * p["g"].float() + p["b"].float()
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p["g"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (half-rotation / llama convention)
# ---------------------------------------------------------------------------

# inverse RoPE frequencies per (d_head, theta, device), formed at first use:
# a decode step then copies nothing from the host, so it can be captured in
# a CUDA graph (serving/graphs.py)
_INV_FREQ: Dict[Tuple[int, float, torch.device], Tensor] = {}


def rope_inv_freq(d_head: int, theta: float, device: torch.device) -> Tensor:
    """(d_head//2,) f32 on ``device``: formed in float64 with numpy and
    rounded to f32, as in the reference."""
    key = (d_head, float(theta), device)
    inv = _INV_FREQ.get(key)
    if inv is None:
        f64 = 1.0 / (theta ** (np.arange(0, d_head, 2) / d_head))
        inv = torch.from_numpy(f64).to(torch.float32).to(device)
        _INV_FREQ[key] = inv
    return inv


def rope_cos_sin(positions: Tensor, d_head: int, theta: float
                 ) -> Tuple[Tensor, Tensor]:
    """positions: (...,) -> cos/sin (..., d_head//2), f32."""
    ang = positions.float()[..., None] * rope_inv_freq(d_head, theta,
                                                       positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x: (..., n_heads, d_head); cos/sin broadcast over the head axis."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Plain products whose rows do not depend on the batch
# ---------------------------------------------------------------------------

# cuBLAS picks a GEMM's kernel by the row count (a matrix-vector kernel for
# one row), and the kernels sum in other orders: on the card a row of a
# B-row product need not equal the row computed alone (the Mamba decode's
# bf16 x @ w_x and f32 dt product, and the router's, measured so). Products
# of up to ROW_PAD rows are zero-padded to ROW_PAD, so a decode step's row
# is the same in a pool of slots as in a batch of one.
ROW_PAD = 16


def matmul_rows(x: Tensor, w: Tensor) -> Tensor:
    """x @ w (x: (..., K), w: (K, N)), each row's result independent of
    the other rows for up to ROW_PAD rows on the card."""
    M = x.numel() // x.shape[-1]
    if x.device.type != "cuda" or M >= ROW_PAD:
        return x @ w
    x2 = x.reshape(M, x.shape[-1])
    xp = torch.cat([x2, x2.new_zeros((ROW_PAD - M, x2.shape[1]))])
    return (xp @ w)[:M].reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# Quantized linear with taps
# ---------------------------------------------------------------------------

def tp_cut(cfg: ModelConfig, axis: str) -> bool:
    """Whether the rank's config holds a part of ``axis`` (one of
    ``TPLayout``'s: "heads", "kv_heads", "d_ff", "vocab", "experts",
    "inner"); false for the whole model."""
    return cfg.tp is not None and axis in cfg.tp.cut


def copy_to_cut(x: Tensor, cfg: ModelConfig, axis: str) -> Tensor:
    """x through ``collectives.copy_to_tp`` where the rank holds a part of
    ``axis`` (the output columns of the site x enters), else x: a whole
    site reads x as every rank does, its gradient whole already."""
    return DC.copy_to_tp(x) if tp_cut(cfg, axis) else x


def kv_window(cfg: ModelConfig) -> Optional[Tuple[int, int]]:
    """Where a rank's query heads are cut and the KV heads whole on every
    rank: (the first KV head, the count) of the whole cache that its H/tp
    query heads read, the group of query head rank * H/tp (G = H / K of
    the whole model; ``check_tp_serving`` refuses a rank whose heads
    straddle groups). None where the rank's KV heads are its query heads'
    own."""
    lay = cfg.tp
    if lay is None or "heads" not in lay.cut or "kv_heads" in lay.cut:
        return None
    if DC.tp_size() != lay.size:
        raise RuntimeError(f"a rank's config of tp={lay.size} called with "
                           f"{DC.tp_size()} ranks active")
    G = lay.n_heads // cfg.n_kv_heads
    return DC.tp_rank() * cfg.n_heads // G, 1


def get_site(scales: Optional[Params], name: str) -> Optional[Q.SiteScale]:
    if scales is None:
        return None
    return scales.get(name)


def qlinear(x: Tensor, w, b: Optional[Tensor], qcfg: QuantConfig,
            scales: Optional[Params], site: str, taps: Optional[Dict],
            n_skip: int = 0, groups: int = 1,
            row_parallel: bool = False,
            x_tp: Optional[Tensor] = None) -> Tensor:
    """y = q(x) @ q(w) + b, recording taps for ``site`` when collecting.
    ``row_parallel``: the site's contracting axis is the one tensor
    parallelism shards (``wo``, ``w_down``; ``Q.qdot``), and its taps are
    the ranks'. ``x_tp``: where the site's output columns are the rank's
    part, x through ``collectives.copy_to_tp``, which the product reads
    (its gradient summed over the ranks; the taps read x itself, whose
    gradient is whole on every rank)."""
    rng = None
    if taps is not None:
        taps[site], rng = Q.site_taps(x, qcfg, get_site(scales, site),
                                      n_skip, groups, row_parallel)
    y = Q.qdot(x if x_tp is None else x_tp, w, qcfg, get_site(scales, site),
               groups, row_parallel, rng)
    if b is not None:
        y = y + b
    return y


def placeholder_scales(sites: Tuple[str, ...], n_layers: int,
                       device) -> Params:
    """Stacked (L,) SiteScale tree (values are ignored unless pt_static)."""
    return {s: Q.SiteScale(
        scale=torch.ones((n_layers,), dtype=torch.float32, device=device),
        zero=torch.zeros((n_layers,), dtype=torch.float32, device=device))
        for s in sites}


def resolve_scales(scales: Optional[Params], sites: Tuple[str, ...],
                   n_layers: int, qcfg: QuantConfig, device) -> Params:
    """The calibrated scales when given, else placeholders; refuses
    ``pt_static`` without calibrated scales (placeholders would clip every
    activation to [0, 255] and give wrong logits silently)."""
    if scales is not None:
        return {s: scales[s] for s in sites}
    if qcfg.mode == "pt_static":
        raise ValueError(
            "pt_static forward without calibrated scales: per-tensor static "
            "quantization needs site scales from core.calibration.calibrate; "
            "refusing to run on placeholder scales, which would produce "
            "wrong logits silently")
    return placeholder_scales(sites, n_layers, device)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

ATTN_SITES = ("qkv", "o")


def attn_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    hd, H, K = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dt = dtype_of(cfg)
    p = {"wqkv": dense_init(gen, cfg.d_model, (H + 2 * K) * hd, dt),
         "wo": dense_init(gen, H * hd, cfg.d_model, dt,
                          scale=1.0 / np.sqrt(2 * cfg.n_layers))}
    if cfg.qkv_bias:
        p["bqkv"] = torch.zeros(((H + 2 * K) * hd,), dtype=dt,
                                device=gen.device)
    return p


def _split_qkv(qkv: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor, Tensor]:
    hd, H, K = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q, k, v = torch.split(qkv, [H * hd, K * hd, K * hd], dim=-1)
    return (q.reshape(*q.shape[:-1], H, hd), k.reshape(*k.shape[:-1], K, hd),
            v.reshape(*v.shape[:-1], K, hd))


def attention_full(p: Params, x: Tensor, cfg: ModelConfig, qcfg: QuantConfig,
                   scales: Optional[Params], taps: Optional[Dict],
                   positions: Tensor, prefix_kv: Optional[Params] = None,
                   causal: bool = True, n_skip: int = 0,
                   return_kv: bool = False,
                   prefix_valid: Optional[int] = None, groups: int = 1):
    """Full-sequence attention (prefill, calibration, search, tuning).
    positions: (S,) absolute positions (already past the cushion).
    prefix_kv: the layer's cushion KV, visible to every query, broadcast
    over B (autograd sums its gradient over B). prefix_valid (int, the
    search's live length): only cushion rows [0, prefix_valid) are visible,
    the reference's ``(m,) bool`` mask ``arange(m) < prefix_valid`` given by
    its length, so the kernel's launch takes no mask tensor."""
    B, S, _ = x.shape
    qkv = qlinear(x, p["wqkv"], p.get("bqkv"), qcfg, scales, "qkv", taps,
                  n_skip, groups, x_tp=copy_to_cut(x, cfg, "heads"))
    q, k, v = _split_qkv(qkv, cfg)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    new_kv = (k, v)

    m = 0
    if prefix_kv is not None:
        m = prefix_kv["k"].shape[0]
        pk = prefix_kv["k"][None].expand(B, *prefix_kv["k"].shape)
        pv = prefix_kv["v"][None].expand(B, *prefix_kv["v"].shape)
        k = torch.cat([pk.to(k.dtype), k], dim=1)
        v = torch.cat([pv.to(v.dtype), v], dim=1)

    out = ops.attention(q, k, v, causal=causal, prefix_len=m,
                        prefix_live=prefix_valid, kv_heads=kv_window(cfg))
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    y = qlinear(out, p["wo"], None, qcfg, scales, "o", taps, n_skip, groups,
                row_parallel=tp_cut(cfg, "heads"))
    if return_kv:
        return y, new_kv
    return y


def quantize_kv(x: Tensor, scale: Tensor) -> Tensor:
    """Symmetric per-head int8 KV quantization. x: (..., K, hd); scale: (K,)
    f32, or per-row (B, K) against x (B, S, K, hd)."""
    if scale.dim() == 2 and x.dim() == 4:
        scale = scale[:, None, :, None]
    else:
        scale = scale[..., :, None]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return Q.quantize(x.float(), scale, zero, bits=8,
                      symmetric=True).to(torch.int8)


def kv_scales_from(k: Tensor, head_axis: int = -2) -> Tensor:
    """Per-kv-head static dequant scale from observed KV (symmetric amax
    rule with a 1e-6 floor), reducing every axis but ``head_axis``."""
    axes = tuple(a for a in range(k.dim()) if a != head_axis % k.dim())
    amax = k.float().abs().amax(dim=axes)
    scale, _ = Q.params_from_minmax(-amax, amax, bits=8, symmetric=True)
    return torch.clamp(scale, min=1e-6)


def attention_decode_kv(p: Params, x: Tensor, kv: Params, pos: Tensor,
                        cfg: ModelConfig, qcfg: QuantConfig,
                        scales: Optional[Params], taps: Optional[Dict]
                        ) -> Tuple[Tensor, Params]:
    """Single-token decode over one layer's KV cache. x: (B,1,D); pos: ()
    or (B,) int32 tensor (per-row positions: RoPE, the write and the mask
    are all per row). kv is the fp cache {"k","v": (B,Smax,K,hd)} (cushion
    rows in-cache at [0:m)) or the int8 cache {"k","v" int8, "k_scale",
    "v_scale": (K,) or per-slot (B,K) f32, "kc","vc": (m,K,hd) fp}.

    A third layout is the paged pool (``serving/paging.py``): kv carries
    "page_table" (B, P) int32 and k/v are a flat (n_pages, ps, K, hd) page
    store; logical position t of row b lives at page page_table[b, t // ps],
    offset t % ps, and the shared fp cushion rides in batch-free kc/vc for
    fp and int8 pools alike.

    The new token's KV is written in place: at pos, clamped into [0, Smax)
    as JAX's dynamic_update_slice clamps; paged, through the table at pos,
    and to the scratch page 0 when pos < 0 (retired rows keep a frozen pos
    and a zeroed table row, so they write to scratch as well). The dict is
    returned for the reference's signature."""
    B = x.shape[0]
    qkv = qlinear(x, p["wqkv"], p.get("bqkv"), qcfg, scales, "qkv", taps)
    q, k, v = _split_qkv(qkv, cfg)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    posv = pos.reshape(-1).expand(B)
    cos, sin = rope_cos_sin(posv[:, None], cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    quantized = "k_scale" in kv
    if quantized:
        k_wr = quantize_kv(k, kv["k_scale"])
        v_wr = quantize_kv(v, kv["v_scale"])
    else:
        k_wr = k.to(kv["k"].dtype)
        v_wr = v.to(kv["v"].dtype)
    rows = torch.arange(B, device=x.device)
    paged = "page_table" in kv
    if paged:
        ps = kv["k"].shape[1]
        wpos = posv.clamp(min=0).long()
        phys = torch.where(posv >= 0, kv["page_table"][rows, wpos // ps],
                           0).long()
        # dead rows all land on the scratch page: duplicate indices there
        # are don't-care, so a plain (non-accumulating) index_put_
        kv["k"][phys, wpos % ps] = k_wr[:, 0]
        kv["v"][phys, wpos % ps] = v_wr[:, 0]
    else:
        wpos = posv.clamp(0, kv["k"].shape[1] - 1).long()
        kv["k"][rows, wpos] = k_wr[:, 0]
        kv["v"][rows, wpos] = v_wr[:, 0]

    # under tensor parallelism the cushion block kc / vc is whole on every
    # rank, and kc_tp / vc_tp its slice of this rank's heads, made once
    kw = dict(k_scale=kv["k_scale"] if quantized else None,
              v_scale=kv["v_scale"] if quantized else None,
              kc=kv.get("kc_tp", kv.get("kc")),
              vc=kv.get("vc_tp", kv.get("vc")))
    q1 = q[:, 0].contiguous()
    mesh = DC.active() if DC.tp_size() > 1 else None
    if mesh is not None:
        kw["kv_heads"] = kv_window(cfg)
    if paged and mesh is not None:
        out = ops.decode_attention_tp_paged(q1, kv["k"], kv["v"],
                                            kv["page_table"], pos, mesh, **kw)
    elif paged:
        out = ops.decode_attention_paged(q1, kv["k"], kv["v"],
                                         kv["page_table"], pos, **kw)
    elif mesh is not None:
        out = ops.decode_attention_tp(q1, kv["k"], kv["v"], pos, mesh, **kw)
    else:
        out = ops.decode_attention(q1, kv["k"], kv["v"], pos, **kw)
    out = out.reshape(B, 1, cfg.n_heads * cfg.head_dim)
    y = qlinear(out, p["wo"], None, qcfg, scales, "o", taps,
                row_parallel=tp_cut(cfg, "heads"))
    return y, kv


def local_heads(t: Tensor, n: int, axis: int = -2) -> Tensor:
    """This rank's ``n`` heads of ``t``'s heads axis (``t`` itself when it
    holds ``n``: already the rank's, or one rank)."""
    return ops.rank_heads(t, n, DC.tp_rank(), DC.tp_size(), axis)


def rank_window(t: Tensor, n: int, axis: int = -1, start: int = 0
                ) -> Tensor:
    """This rank's window of ``n`` entries of ``t``'s ``axis``, from
    ``start + rank * n``: a view, no copy. A rank reads its heads' columns
    of a leaf the reference keeps whole this way (the encoder-decoder's
    ``xattn/wq`` and each half of ``xattn/wkv``; the xLSTM's mLSTM values),
    as ``kv_window`` reads whole KV heads in place."""
    return t.narrow(axis, start + DC.tp_rank() * n, n)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

MLP_SITES = ("mlp_in", "down")


def mlp_init(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> Params:
    d_ff = d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    p = {"w_up": dense_init(gen, cfg.d_model, d_ff, dt),
         "w_down": dense_init(gen, d_ff, cfg.d_model, dt,
                              scale=1.0 / np.sqrt(2 * cfg.n_layers))}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init(gen, cfg.d_model, d_ff, dt)
    return p


def apply_mlp(p: Params, x: Tensor, cfg: ModelConfig, qcfg: QuantConfig,
              scales: Optional[Params], taps: Optional[Dict],
              n_skip: int = 0, groups: int = 1,
              cut: Optional[bool] = None) -> Tensor:
    """``cut``: whether the rank holds a part of this MLP's hidden axis
    (default: the config's d_ff, ``tp_cut``); ``w_down`` then sums over
    the ranks."""
    if cut is None:
        cut = tp_cut(cfg, "d_ff")
    # one copy-to-tp for both products: one sum of the gradient
    x_tp = DC.copy_to_tp(x) if cut else x
    up = qlinear(x, p["w_up"], None, qcfg, scales, "mlp_in", taps, n_skip,
                 groups, x_tp=x_tp)
    if cfg.gated_mlp:
        # gate shares the "mlp_in" site (same input tensor -> same scale)
        gate = qlinear(x, p["w_gate"], None, qcfg, scales, "mlp_in", None,
                       n_skip, groups, x_tp=x_tp)
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")      # jax.nn.gelu's default
    return qlinear(h, p["w_down"], None, qcfg, scales, "down", taps, n_skip,
                   groups, row_parallel=cut)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = dtype_of(cfg)
    w = draw(gen, (cfg.vocab_size, cfg.d_model)) * 0.02
    p = {"embed": {"w": w.to(dt)}}
    if not cfg.tie_embeddings:
        p["head"] = {"w": dense_init(gen, cfg.d_model, cfg.vocab_size, dt)}
    return p


def embed_tokens(p: Params, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    """The tokens' embeddings. Where a tensor-parallel rank's vocabulary
    is cut, the table is its vocabulary rows: each rank looks up the tokens
    it holds, zeros elsewhere, and the ranks' rows are summed (adding zeros
    is exact); a whole table takes no collective."""
    w = p["embed"]["w"]
    if not tp_cut(cfg, "vocab"):
        return F.embedding(tokens, w)
    n = w.shape[0]
    local = tokens.long() - DC.tp_rank() * n
    mine = (local >= 0) & (local < n)
    e = F.embedding(local.clamp(0, n - 1), w)
    e = torch.where(mine[..., None], e, torch.zeros((), dtype=e.dtype,
                                                    device=e.device))
    # one rank holds each row: the sum adds zeros, exact in the table's
    # dtype
    return DC.psum(e)


def lm_head(p: Params, x: Tensor, cfg: ModelConfig, qcfg: QuantConfig,
            scales: Optional[Params], taps: Optional[Dict],
            n_skip: int = 0, groups: int = 1, last: bool = False) -> Tensor:
    """Logits. A tied head quantizes ``embed.T`` on every call under true
    int8, as the reference does: an int8 copy kept at load would add
    vocab x d_model bytes that the reference does not hold, and the port's
    resident bytes are held equal to JAX's. ``last``: the head reads
    every position of x (a dynamic range spans them) and returns the last
    position's logits (B, 1, V), taken before a cut vocabulary's gather
    (whose gradient is the rank's columns)."""
    w = p["embed"]["w"].T if cfg.tie_embeddings else p["head"]["w"]
    site = scales.get("head") if scales is not None else None
    rng = None
    if taps is not None:
        taps["head"], rng = Q.site_taps(x, qcfg, site, n_skip, groups)
    logits = Q.qdot(copy_to_cut(x, cfg, "vocab"), w, qcfg, site, groups,
                    rng=rng)
    if last:
        logits = logits[:, -1:]
    # a rank's cut vocabulary columns, gathered
    return DC.gather_last(logits) if tp_cut(cfg, "vocab") else logits


def cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean next-token CE; logits (B,S,V), labels (B,S) int. Under a data
    axis (``collectives.use_data``, each rank's rows of an evenly split
    batch) the global mean: the ranks' sums over the global token count,
    its gradient each rank's share."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    if DC.data_size() == 1:
        return (lse - gold).mean()
    return DC.global_sum((lse - gold).sum()) / (gold.numel()
                                                * DC.data_size())
