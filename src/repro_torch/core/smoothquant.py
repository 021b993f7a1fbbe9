"""SmoothQuant (Xiao et al. 2023), ported from
``repro/core/smoothquant.py``: migrate activation magnitude into the
weights with per-channel factors

    s_j = max|X_j|^alpha / max|W_j|^(1-alpha)

so activations become flatter (easier to quantize per tensor) while the
weights absorb the outliers. The paper combines CushionCache with
SmoothQuant-O1/2/3, whose level is the activation quantizer's granularity
(``QuantConfig.mode``).

Folding map (dense llama-style blocks, the paper's models):
  site "qkv"    -> ln1.g    /= s,  wqkv rows      *= s
  site "mlp_in" -> ln2.g    /= s,  w_up/gate rows *= s
  site "down"   -> w_up cols /= s, w_down rows    *= s  (gated: h = silu(g)*up)
  site "o"      -> wqkv v-cols /= s (GQA-reduced), wo rows *= s

Only the dense family (and VLM, whose decoder is dense) folds, as in the
reference's code: every other family raises, MoE included (no expert fold
exists in either package). ``stats`` is the merged statistics tree of
``core.calibration.calibrate`` (leaves stacked ``(L, ...)``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import Family, ModelConfig
from repro_torch.models import common as C

Tensor = torch.Tensor
Params = Dict[str, Any]


def _factors(act_absmax_ch: Tensor, w_absmax_ch: Tensor,
             alpha: float) -> Tensor:
    a = torch.clamp(act_absmax_ch.float(), min=1e-5)
    w = torch.clamp(w_absmax_ch.float(), min=1e-5)
    s = a ** alpha / w ** (1.0 - alpha)
    return torch.clamp(s, 1e-2, 1e4)


def _w_absmax_in(w: Tensor) -> Tensor:
    """Per-input-channel |W| max; w: (..., d_in, d_out) -> (d_in,)."""
    red = tuple(range(w.dim() - 2)) + (w.dim() - 1,)
    return w.float().abs().amax(dim=red)


def smooth_dense_layer(lp: Params, lstats: Dict[str, Any], cfg: ModelConfig,
                       alpha: float) -> Params:
    """Smooth one dense layer. lp / lstats are one layer's (unstacked)
    trees; returns new layer params (lp is not modified)."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn, mlp = dict(lp["attn"]), dict(lp["mlp"])
    ln1, ln2 = dict(lp["ln1"]), dict(lp["ln2"])
    dt = attn["wqkv"].dtype

    # qkv <- ln1
    s = _factors(lstats["qkv"]["absmax_ch"], _w_absmax_in(attn["wqkv"]),
                 alpha).to(dt)
    ln1["g"] = ln1["g"] / s
    if "b" in ln1:
        ln1["b"] = ln1["b"] / s
    attn["wqkv"] = attn["wqkv"] * s[:, None]

    # o <- v columns of wqkv (GQA: the o input (H*hd) reduces to the v
    # channels (K*hd))
    so_v = lstats["o"]["absmax_ch"].reshape(K, H // K, hd).amax(dim=1)
    wo_in = _w_absmax_in(attn["wo"]).reshape(K, H // K, hd).amax(dim=1)
    s = _factors(so_v.reshape(K * hd), wo_in.reshape(K * hd), alpha)
    v0 = (H + K) * hd
    wqkv = attn["wqkv"].clone()
    wqkv[:, v0:] = attn["wqkv"][:, v0:] / s.to(dt)
    attn["wqkv"] = wqkv
    if "bqkv" in attn:
        b = attn["bqkv"].clone()
        b[v0:] = attn["bqkv"][v0:] / s.to(dt)
        attn["bqkv"] = b
    s_o = s.reshape(K, 1, hd).repeat(1, H // K, 1).reshape(H * hd)
    attn["wo"] = attn["wo"] * s_o[:, None].to(dt)

    # mlp_in <- ln2
    s = _factors(lstats["mlp_in"]["absmax_ch"], _w_absmax_in(mlp["w_up"]),
                 alpha).to(dt)
    ln2["g"] = ln2["g"] / s
    if "b" in ln2:
        ln2["b"] = ln2["b"] / s
    mlp["w_up"] = mlp["w_up"] * s[:, None]
    if "w_gate" in mlp:
        mlp["w_gate"] = mlp["w_gate"] * s[:, None]

    # down <- w_up output columns
    s = _factors(lstats["down"]["absmax_ch"], _w_absmax_in(mlp["w_down"]),
                 alpha).to(dt)
    mlp["w_up"] = mlp["w_up"] / s[None, :]
    mlp["w_down"] = mlp["w_down"] * s[:, None]
    return {**lp, "ln1": ln1, "attn": attn, "ln2": ln2, "mlp": mlp}


def apply_smoothquant(params, stats: Dict[str, Any], cfg: ModelConfig,
                      alpha: float = 0.8) -> C.ParamTree:
    """Smooth every layer; returns a new ``ParamTree`` (params, a
    ``ParamTree`` or its nested dict, is left as it is)."""
    if cfg.family not in (Family.DENSE, Family.VLM):
        raise NotImplementedError(
            f"SmoothQuant folding is implemented for dense-family archs; "
            f"{cfg.family} mixers have no exact fold")
    params = C.as_tree(params)
    L = cfg.n_layers
    smoothed = [smooth_dense_layer(lp, ls, cfg, alpha)
                for lp, ls in zip(C.unstack(params["layers"], L),
                                  C.unstack(stats["layers"], L))]
    return C.ParamTree({**params, "layers": C.stack_trees(smoothed)})
