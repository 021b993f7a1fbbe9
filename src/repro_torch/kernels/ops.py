"""Model-level entries to the kernels, in the JAX package's layouts
(``repro/kernels/ops.py``: ``qdot_pallas``, ``attention_pallas``,
``decode_attention_pallas``, ``decode_attention_paged``). Each dispatches
on the device of its tensors through the kernel wrappers: the kernel on the
card, the plain version on the CPU. The tensor-parallel entries
``decode_attention_tp`` / ``decode_attention_tp_paged`` run the decode
kernels on one rank's heads (the reference ``shard_map``s them).
``w4a8_matmul`` and ``act_quant_ptoken`` have no entry here (as in the
reference): ``core/quantization.py`` reaches them directly."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core import quantization as Q
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged


def qdot(x: torch.Tensor, w: torch.Tensor, cfg: QuantConfig,
         site: Optional[Q.SiteScale] = None) -> torch.Tensor:
    """x: (..., K) fp; w: (K, N) fp. The W8A8 per-tensor-static path:
    ``act_quant_static`` on the activations, the weight quantized per call,
    ``w8a8_matmul`` with the scalar epilogue. Returns x's dtype."""
    if cfg.mode != "pt_static" or site is None:
        raise ValueError("qdot takes pt_static with a calibrated site scale")
    return Q.true_int_dot(x, w, cfg, site)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, prefix_len: int = 0,
              prefix_live: Optional[int] = None,
              kv_heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, T, Kh, hd). GQA kv-heads are read in
    place by the kernel (no head repeat in memory). ``prefix_live`` (default
    ``prefix_len``) masks rows [prefix_live, prefix_len) of a padded prefix
    out of every query's view. ``kv_heads`` = (kv0, n): the query heads
    read KV heads [kv0, kv0 + n) of the Kh, a strided view the kernel takes
    as it is (a tensor-parallel rank's heads over whole KV heads).
    Differentiable on both devices (the kernel's backward on the card).
    Returns (B, S, H, hd)."""
    if kv_heads is not None:
        k = k.narrow(2, kv_heads[0], kv_heads[1])
        v = v.narrow(2, kv_heads[0], kv_heads[1])
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal,
                        prefix_len=prefix_len, prefix_live=prefix_live)
    return o.transpose(1, 2)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     kc: Optional[torch.Tensor] = None,
                     vc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, hd); k/v: the (B, Smax, K, hd) cache (int8 when scales are
    given, cushion in kc/vc); pos: () or (B,). Returns (B, H, hd)."""
    return flash_decode(q, k, v, pos, k_scale=k_scale, v_scale=v_scale,
                        kc=kc, vc=vc)


def decode_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           pos, k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           kc: Optional[torch.Tensor] = None,
                           vc: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q: (B, H, hd); k/v: the (n_pages, ps, K, hd) page store; page_table:
    (B, P) int32; the cushion in kc/vc for fp and int8 pools alike.
    Returns (B, H, hd)."""
    return flash_decode_paged(q, k_pages, v_pages, page_table, pos,
                              k_scale=k_scale, v_scale=v_scale, kc=kc, vc=vc)


def rank_heads(t: torch.Tensor, n: int, rank: int, size: int,
               axis: int = -2) -> torch.Tensor:
    """Rank ``rank``'s ``n`` heads of ``t``'s heads axis (of ``n * size``),
    contiguous; ``t`` itself when it already holds ``n``."""
    have = t.shape[axis]
    if have == n:
        return t
    if have != n * size:
        raise ValueError(f"a heads axis of {have}: neither the rank's {n} "
                         f"nor the {n * size} of {size} ranks")
    return t.narrow(axis, rank * n, n).contiguous()


def _tp_operands(q, k, kc, vc, mesh, kv_heads):
    Kl = k.shape[-2] if kv_heads is None else kv_heads[1]
    if q.shape[1] % Kl:
        raise ValueError(f"{q.shape[1]} local query heads over {Kl} local "
                         f"KV heads")
    if kc is not None and kv_heads is None:
        kc = rank_heads(kc, Kl, mesh.rank, mesh.size)
        vc = rank_heads(vc, Kl, mesh.rank, mesh.size)
    return kc, vc


def decode_attention_tp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pos, mesh, k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None,
                        kc: Optional[torch.Tensor] = None,
                        vc: Optional[torch.Tensor] = None,
                        kv_heads: Optional[Tuple[int, int]] = None
                        ) -> torch.Tensor:
    """Tensor-parallel split-KV decode on one rank (``mesh``: its rank and
    size): ``flash_decode`` on the rank's heads, the body of the
    reference's ``shard_map``. The operands are the rank's shards: q
    (B, H/tp, hd), whose query heads are those of its KV heads; k/v
    (B, Smax, K/tp, hd); k/v_scale (K/tp,) or (B, K/tp). kc/vc (m, K, hd)
    are the cushion block, whole on every rank (sliced to the rank's heads
    here) or already the rank's slice (m, K/tp, hd). Where the KV heads are
    whole on every rank (they do not divide by tp), k/v, the scales and
    kc/vc hold all K, and ``kv_heads`` = (kv0, n) names the heads the
    rank's query heads read, in place. pos () or (B,) is the same on every
    rank. No collective runs: per-head attention needs none, and ``wo``
    sums the ranks' heads. Returns the rank's (B, H/tp, hd)."""
    kc, vc = _tp_operands(q, k, kc, vc, mesh, kv_heads)
    return flash_decode(q, k, v, pos, k_scale=k_scale, v_scale=v_scale,
                        kc=kc, vc=vc, kv_heads=kv_heads)


def decode_attention_tp_paged(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              page_table: torch.Tensor, pos, mesh,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None,
                              kc: Optional[torch.Tensor] = None,
                              vc: Optional[torch.Tensor] = None,
                              kv_heads: Optional[Tuple[int, int]] = None
                              ) -> torch.Tensor:
    """``decode_attention_tp`` through a page table: the page store is the
    rank's KV heads (n_pages, ps, K/tp, hd), or all K with ``kv_heads``,
    the page table (B, P) is the same on every rank (page ids are layout,
    not data), and the shared cushion block is whole or the rank's slice,
    as there. Returns the rank's (B, H/tp, hd)."""
    kc, vc = _tp_operands(q, k_pages, kc, vc, mesh, kv_heads)
    return flash_decode_paged(q, k_pages, v_pages, page_table, pos,
                              k_scale=k_scale, v_scale=v_scale, kc=kc, vc=vc,
                              kv_heads=kv_heads)
