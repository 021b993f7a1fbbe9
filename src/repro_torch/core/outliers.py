"""Activation-outlier analysis (paper §6.1, Table 5 / Figure 2), ported
from ``repro/core/outliers.py``: order statistics of activation magnitudes
(top-1/2/3, top-10%, median) per layer and for the input of the last
block, and the differentiable activation-range penalty of prefix tuning."""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core.calibration import NON_SITES

Tensor = torch.Tensor


def _quantile(sorted_x: Tensor, q: float) -> Tensor:
    """Linear-interpolation quantile of an ascending 1-D tensor
    (``jnp.quantile``'s default method), for any length."""
    idx = q * (sorted_x.numel() - 1)
    lo = int(np.floor(idx))
    hi = min(lo + 1, sorted_x.numel() - 1)
    return sorted_x[lo] + (sorted_x[hi] - sorted_x[lo]) * (idx - lo)


def magnitude_stats(x: Tensor, n_skip: int = 0) -> Dict[str, Tensor]:
    """x: (B, S, D) activations -> {top1, top2, top3, top10pct, median}."""
    if n_skip:
        x = x[:, n_skip:]
    mags = x.float().abs().reshape(-1)
    top3 = torch.topk(mags, 3).values
    s = torch.sort(mags).values
    return {"top1": top3[0], "top2": top3[1], "top3": top3[2],
            "top10pct": _quantile(s, 0.9), "median": _quantile(s, 0.5)}


def activation_range_penalty(taps: Any) -> Tensor:
    """Differentiable activation-range regularizer (the L_q term of prefix
    tuning's L = L_pred + λ·L_q, eq. 11): the sum over every collected
    quantization site of the squared tensor absmax ``max(amax, -amin)²``,
    in f32. ``core/quantization.py`` ``site_stats`` keeps amin / amax
    differentiable, so the gradient flows back through attention into the
    cushion KV. Only sites count: the residual-stream taps
    (``calibration.NON_SITES``: block_in, final_in) are never quantized and
    are excluded."""
    total: Optional[Tensor] = None

    def visit(d):
        nonlocal total
        if not isinstance(d, dict):
            return
        if "amin" in d and "amax" in d:
            half = torch.maximum(d["amax"].float(), -d["amin"].float())
            v = half.square().sum()
            total = v if total is None else total + v
            return                      # a site dict: no nested sites below
        for k, v in d.items():
            if k in NON_SITES:
                continue
            visit(v)

    visit(taps)
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return total


@torch.no_grad()
def last_block_input_stats(api, params, batch, qcfg: QuantConfig,
                           cushion=None, n_skip: int = 0
                           ) -> Dict[str, float]:
    """Table-5 numbers: magnitude stats of the input to the last block,
    from the channel absmax of its ``block_in`` tap."""
    _, taps = api.forward(params, batch, qcfg, cushion=cushion, collect=True,
                          n_skip=n_skip)
    ch = taps["layers"]["block_in"]["absmax_ch"][-1].float().cpu().numpy()
    ch_sorted = np.sort(ch)[::-1]
    return {
        "top1": float(ch_sorted[0]),
        "top2": float(ch_sorted[1]) if ch.size > 1 else float("nan"),
        "top3": float(ch_sorted[2]) if ch.size > 2 else float("nan"),
        "top10pct": float(np.quantile(ch, 0.9)),
        "median": float(np.quantile(ch, 0.5)),
    }


@torch.no_grad()
def per_layer_top_stats(api, params, batch, qcfg: QuantConfig,
                        cushion=None, n_skip: int = 0):
    """Figure-2 numbers: per-layer top-1 (channel absmax) and the median
    across channels of block inputs."""
    _, taps = api.forward(params, batch, qcfg, cushion=cushion, collect=True,
                          n_skip=n_skip)
    ch = taps["layers"]["block_in"]["absmax_ch"].float().cpu().numpy()
    out = []
    for l in range(ch.shape[0]):
        row = np.sort(ch[l])[::-1]
        out.append({"layer": l, "top1": float(row[0]),
                    "top2": float(row[1]), "top3": float(row[2]),
                    "median": float(np.quantile(ch[l], 0.5))})
    return out
