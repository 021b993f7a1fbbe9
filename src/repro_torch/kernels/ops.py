"""Model-level entries to the kernels, in the JAX package's layouts
(``repro/kernels/ops.py``: ``qdot_pallas``, ``attention_pallas``,
``decode_attention_pallas``, ``decode_attention_paged``). Each dispatches
on the device of its tensors through the kernel wrappers: the kernel on the
card, the plain version on the CPU. The tensor-parallel entries are not
ported yet. ``w4a8_matmul`` and ``act_quant_ptoken`` have no entry here (as
in the reference): ``core/quantization.py`` reaches them directly."""
from __future__ import annotations

from typing import Optional

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
              prefix_live: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, T, Kh, hd). GQA kv-heads are read in
    place by the kernel (no head repeat in memory). ``prefix_live`` (default
    ``prefix_len``) masks rows [prefix_live, prefix_len) of a padded prefix
    out of every query's view. Differentiable on both devices (the kernel's
    backward on the card). Returns (B, S, H, hd)."""
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
