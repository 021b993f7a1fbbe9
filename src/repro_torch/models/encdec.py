"""Whisper-style encoder-decoder, ported from ``repro/models/encdec.py``.
The audio frontend is a stub, as in the reference: the inputs are frame
embeddings ``frames`` (B, T_enc, D).

    init_params(cfg, gen)                      -> ParamTree
    encode(params, frames, cfg, qcfg, ...)     -> (enc_out, enc taps)
    forward(params, tokens, cfg, qcfg, ...)    -> (logits, taps)
    loss_fn(params, tokens, labels, ...)       -> (loss, aux)
    init_cache(cfg, B, Smax, device, ...)      -> cache
    prefill(params, tokens, cache, ...)        -> (logits, cache, pos)
    decode_step(params, token, pos, cache, ..) -> (logits, cache)

The encoder is a stack of non-causal self-attention blocks; the decoder's
blocks run causal self-attention (over the CushionCache prefix KV: the
paper's method applied to the decoder), cross-attention over the encoder
states, and the MLP. Parameters ``encoder`` (E, ...) and ``decoder`` (L,
...) are stacked, the reference's ``vmap``-ed layout.

Attention: the encoder's self-attention and the cross-attention run
``ops.attention(..., causal=False)`` (on the card the non-causal mode of
the ``flash_attention`` kernel, its backward under autograd; on the CPU
the plain version). The reference computes the cross-attention with
``_sdpa``, jnp outside any Pallas kernel: the same function.

Scales are ``{"enc": {site: (E,)}, "dec": {site: (L,)}, "head"}``. The
reference's ``prefill`` and ``decode_step`` call the head without scales,
so it cannot serve ``pt_static``; the port refuses it there with that
reason (``forward``, the loss, calibration, the search and the tuning take
scales under every mode).

Cache: the decoder's self-attention KV ``k`` / ``v`` (L, B, Smax, K, hd)
(fp only: the reference has no int8 cache for this family) and the
cross-attention KV ``xk`` / ``xv`` (L, B, T_enc, K, hd), each request's own
encoder states. Prefill writes all four in place (a captured decode step
reads the tensors it was captured on).

Tensor parallelism (a rank's config, ``serving/engine.tp_config``), the
reference's serve specs: both stacks' self-attention on the rank's heads
(``wqkv`` by heads, ``wo`` by rows) and their MLPs on its ``d_ff``
(``w_up`` by columns, ``w_down`` by rows); the cross-attention's ``wo``
by rows (the rule ``attn/wo$`` finds ``xattn/wo``), while ``wq`` and
``wkv`` stay whole leaves (``attn/wqkv$`` misses them): a rank reads its
heads' columns of each (``common.rank_window``), so its cross KV holds
its heads, as the cache roles say. The five row-parallel sites sum over
the ranks (``Q.qdot``); the embedding and the head are cut where the
vocabulary divides. Under autograd (tensor-parallel training and tuning)
the cross-attention's query product reads the decoder state through
``collectives.copy_to_tp``, and the decoder reads ``enc_out`` through one
copy for all its layers, so both gradients are whole on every rank; the
whole ``xattn/wq`` and ``xattn/wkv``, read in windows, get each rank's
share, summed over tp where the gradients meet the optimizer
(``engine.tp_leaf_parts``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core import quantization as Q
from repro_torch.kernels import ops
from repro_torch.models import common as C
from repro_torch.models import transformer as T

Tensor = torch.Tensor
Params = Dict[str, Any]

ENC_SITES = ("qkv", "o", "mlp_in", "down")
DEC_SITES = ("qkv", "o", "xq", "xo", "mlp_in", "down")
# the sites the model API reports (the reference's registry: the decoder's)
SITES = DEC_SITES

# The decoder's L_q depends on cross-attention over each sample's encoder
# states, which a shared prefix KV block cannot hold: the search scores
# with greedy_search_ref.
SUPPORTS_PREFIX_KV_SCORING = False

# Slot layout: self- and cross-attention KV, batch on axis 1 everywhere; an
# admission carries the request's own encoder states into its slot.
CACHE_BATCH_AXES = {"k": 1, "v": 1, "xk": 1, "xv": 1}

total_qerr = T.total_qerr
cushion_zeros = T.cushion_zeros
cushion_summed = T.cushion_summed


def xattn_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    hd, H, K = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dt = C.dtype_of(cfg)
    return {"wq": C.dense_init(gen, cfg.d_model, H * hd, dt),
            "wkv": C.dense_init(gen, cfg.d_model, 2 * K * hd, dt),
            "wo": C.dense_init(gen, H * hd, cfg.d_model, dt,
                               scale=1.0 / np.sqrt(2 * cfg.n_layers))}


def enc_layer_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"ln1": C.norm_init(cfg, gen.device), "attn": C.attn_init(gen, cfg),
            "ln2": C.norm_init(cfg, gen.device), "mlp": C.mlp_init(gen, cfg)}


def dec_layer_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"ln1": C.norm_init(cfg, gen.device), "attn": C.attn_init(gen, cfg),
            "lnx": C.norm_init(cfg, gen.device), "xattn": xattn_init(gen, cfg),
            "ln2": C.norm_init(cfg, gen.device), "mlp": C.mlp_init(gen, cfg)}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> C.ParamTree:
    """Seeded random weights on the generator's device."""
    p = C.embed_init(gen, cfg)
    p["encoder"] = C.stack_trees([enc_layer_init(gen, cfg) for _ in
                                  range(cfg.encdec.encoder_layers)])
    p["decoder"] = C.stack_trees([dec_layer_init(gen, cfg)
                                  for _ in range(cfg.n_layers)])
    p["ln_enc"] = C.norm_init(cfg, gen.device)
    p["ln_f"] = C.norm_init(cfg, gen.device)
    return C.ParamTree(p)


def enc_kv(p: Params, enc_out: Tensor, cfg: ModelConfig
           ) -> Tuple[Tensor, Tensor]:
    """The cross-attention's keys and values (B, T_enc, K, hd) of the
    encoder states (an fp product, as in the reference). A
    tensor-parallel rank whose KV heads are cut forms its K heads of each
    half of the whole ``wkv`` [k | v] (two windows of its columns)."""
    B, Te, _ = enc_out.shape
    K, hd = cfg.n_kv_heads, cfg.head_dim
    w = p["wkv"]
    if C.tp_cut(cfg, "kv_heads"):
        half = w.shape[-1] // 2
        k = enc_out @ C.rank_window(w, K * hd)
        v = enc_out @ C.rank_window(w, K * hd, start=half)
    else:
        k, v = torch.split(enc_out @ w, K * hd, dim=-1)
    return k.reshape(B, Te, K, hd), v.reshape(B, Te, K, hd)


def cross_attention(p: Params, x: Tensor, kv: Tuple[Tensor, Tensor],
                    cfg: ModelConfig, qcfg: QuantConfig,
                    scales: Optional[Params], taps: Optional[Dict],
                    n_skip: int = 0, groups: int = 1) -> Tensor:
    """x: (B, S, D); kv: (k, v) each (B, T_enc, K, hd). Every query sees
    every encoder state. A tensor-parallel rank whose heads are cut
    computes its H heads' queries from its columns of the whole ``wq``,
    attends over its KV heads (or its group's window of whole ones,
    ``kv_window``) and sums ``wo``'s partial products over the ranks."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    cut = C.tp_cut(cfg, "heads")
    wq = C.rank_window(p["wq"], H * hd) if cut else p["wq"]
    q = C.qlinear(x, wq, None, qcfg, scales, "xq", taps, n_skip, groups,
                  x_tp=C.copy_to_cut(x, cfg, "heads"))
    out = ops.attention(q.reshape(B, S, H, hd), kv[0], kv[1], causal=False,
                        kv_heads=C.kv_window(cfg))
    return C.qlinear(out.reshape(B, S, H * hd), p["wo"], None, qcfg, scales,
                     "xo", taps, n_skip, groups, row_parallel=cut)


def _dec_scales(scales: Optional[Params], cfg: ModelConfig,
                qcfg: QuantConfig, device) -> Params:
    return C.resolve_scales(scales["dec"] if scales is not None else None,
                            DEC_SITES, cfg.n_layers, qcfg, device)


def _enc_block(lp: Params, x: Tensor, cfg: ModelConfig, qcfg: QuantConfig,
               lsc: Params, positions: Tensor, collect: bool,
               groups: int) -> Tuple[Tensor, Optional[Dict]]:
    """One encoder layer (non-causal self-attention, the MLP)."""
    taps: Optional[Dict] = {} if collect else None
    hn = C.apply_norm(lp["ln1"], x, cfg)
    x = x + C.attention_full(lp["attn"], hn, cfg, qcfg, lsc, taps,
                             positions, causal=False, groups=groups)
    hn = C.apply_norm(lp["ln2"], x, cfg)
    x = x + C.apply_mlp(lp["mlp"], hn, cfg, qcfg, lsc, taps, 0, groups)
    return x, taps


def encode(params, frames: Tensor, cfg: ModelConfig, qcfg: QuantConfig,
           scales: Optional[Params] = None, collect: bool = False,
           groups: int = 1, remat: bool = True) -> Tuple[Tensor, Dict]:
    """frames (B, T_enc, D) -> (encoder states (B, T_enc, D), the encoder
    sites' taps stacked over its layers, or {} without ``collect``).
    ``remat``: one checkpoint a layer (``common.remat_call``)."""
    params = C.as_tree(params)
    x = frames.to(C.dtype_of(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    ne = cfg.encdec.encoder_layers
    lscales = C.resolve_scales(scales["enc"] if scales is not None else None,
                               ENC_SITES, ne, qcfg, x.device)
    enc_taps: List[Dict] = []
    for lp, lsc in zip(C.unstack(params["encoder"], ne),
                       C.unstack(lscales, ne)):
        x, taps = C.remat_call(remat, _enc_block, lp, x, cfg, qcfg, lsc,
                               positions, collect, groups)
        enc_taps.append(taps)
    out = C.apply_norm(params["ln_enc"], x, cfg)
    return out, (C.stack_trees(enc_taps) if collect else {})


def forward(params, tokens: Tensor, cfg: ModelConfig, qcfg: QuantConfig, *,
            frames: Tensor, scales: Optional[Params] = None,
            cushion: Optional[Params] = None, collect: bool = False,
            n_skip: int = 0, groups: int = 1,
            remat: bool = True) -> Tuple[Tensor, Dict]:
    """Teacher-forced decoder pass over the encoded ``frames``. With
    ``collect`` the taps hold ``enc_layers`` (the encoder's sites),
    ``layers`` (the decoder's, with ``block_in``), the head's and
    ``final_in``. ``groups``: stacked forwards, as ``transformer.forward``
    (the search tiles each sample's frames with its rows). ``remat``: one
    checkpoint a layer of either stack."""
    params = C.as_tree(params)
    enc_out, enc_taps = encode(params, frames, cfg, qcfg, scales, collect,
                               groups, remat)
    # every decoder layer reads its heads' part of the encoder states (the
    # windows of the whole ``wkv``, or a window of the whole KV heads): one
    # copy-to-tp for all of them, one sum of the gradient
    enc_out = C.copy_to_cut(enc_out, cfg, "heads")
    x = C.embed_tokens(params, tokens, cfg)
    S = x.shape[1]
    m = 0 if cushion is None else cushion["kv"]["k"].shape[1]
    positions = m + torch.arange(S, device=x.device)
    L = cfg.n_layers
    lscales = _dec_scales(scales, cfg, qcfg, x.device)
    dec_taps: List[Dict] = []
    pre = T._cushion_layers(T.local_cushion(cushion, cfg), L)
    for lp, lsc, lpre in zip(C.unstack(params["decoder"], L),
                             C.unstack(lscales, L), pre):
        x, taps = C.remat_call(remat, _dec_block, lp, x, enc_out, cfg, qcfg,
                               lsc, lpre, positions, collect, n_skip, groups)
        dec_taps.append(taps)
    x = C.apply_norm(params["ln_f"], x, cfg)
    head_taps: Optional[Dict] = {} if collect else None
    logits = C.lm_head(params, x, cfg, qcfg, scales, head_taps, n_skip,
                       groups)
    if not collect:
        return logits, {}
    return logits, {"enc_layers": enc_taps,
                    "layers": C.stack_trees(dec_taps), **head_taps,
                    "final_in": Q.site_stats(x, n_skip)}


def _dec_block(lp: Params, x: Tensor, enc_out: Tensor, cfg: ModelConfig,
               qcfg: QuantConfig, lsc: Params, lpre: Optional[Params],
               positions: Tensor, collect: bool, n_skip: int,
               groups: int) -> Tuple[Tensor, Optional[Dict]]:
    """One decoder layer: causal self-attention over the cushion and the
    tokens, the non-causal cross-attention over ``enc_out``, the MLP."""
    taps: Optional[Dict] = {} if collect else None
    if collect:
        taps["block_in"] = Q.site_stats(x, n_skip)
    hn = C.apply_norm(lp["ln1"], x, cfg)
    x = x + C.attention_full(lp["attn"], hn, cfg, qcfg, lsc, taps,
                             positions, prefix_kv=lpre, causal=True,
                             n_skip=n_skip, groups=groups)
    hn = C.apply_norm(lp["lnx"], x, cfg)
    x = x + cross_attention(lp["xattn"], hn,
                            enc_kv(lp["xattn"], enc_out, cfg), cfg, qcfg,
                            lsc, taps, n_skip, groups)
    hn = C.apply_norm(lp["ln2"], x, cfg)
    x = x + C.apply_mlp(lp["mlp"], hn, cfg, qcfg, lsc, taps, n_skip, groups)
    return x, taps


def loss_fn(params, tokens: Tensor, labels: Tensor, cfg: ModelConfig,
            qcfg: QuantConfig, *, frames: Tensor, scales=None, cushion=None,
            collect: bool = False, n_skip: int = 0, remat: bool = True,
            lam: float = 0.0):
    """Next-token CE (+ λ·L_q, the encoder's sites included, when ``lam``
    > 0), as ``transformer.loss_fn``."""
    logits, taps = forward(params, tokens, cfg, qcfg, frames=frames,
                           scales=scales, cushion=cushion,
                           collect=collect or lam > 0, n_skip=n_skip,
                           remat=remat)
    if n_skip:
        logits = logits[:, n_skip:]
        labels = labels[:, n_skip:]
    ce = C.cross_entropy(logits, labels)
    loss = ce
    aux = {"ce": ce, "taps": taps}
    if lam > 0 or collect:
        qerr = total_qerr(taps)
        aux["qerr"] = qerr
        if lam > 0:
            loss = loss + lam * qerr
    return loss, aux


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def cache_roles(cfg: ModelConfig, kv_dtype=None,
                per_slot_scales: bool = False) -> Params:
    """Serving cache roles, the reference's: self- and cross-attention KV
    (L, B, S, K, hd) on their heads axis (``kv_dtype`` is unused: this
    family's KV stays fp). A tensor-parallel rank's cache
    (``init_cache`` of its config) holds its KV heads of all four."""
    kv = (None, "B", None, "M", None)
    return {"k": kv, "v": kv, "xk": kv, "xv": kv}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
               dtype=None, kv_dtype=None, prefix_len: int = 0,
               per_slot_scales: bool = False) -> Params:
    """fp self-attention KV (L, B, max_seq, K, hd) and cross-attention KV
    (L, B, T_enc, K, hd). ``kv_dtype``, ``prefix_len`` and
    ``per_slot_scales`` size an int8 cache, which this family does not
    have (``registry`` refuses ``kv_dtype``)."""
    dt = dtype or C.dtype_of(cfg)
    K, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    Te = cfg.encdec.encoder_seq

    def z(n):
        return torch.zeros((L, batch, n, K, hd), dtype=dt, device=device)
    return {"k": z(max_seq), "v": z(max_seq), "xk": z(Te), "xv": z(Te)}


def check_serving_quant(qcfg: QuantConfig) -> None:
    """The reference's prefill and decode step call the head without site
    scales, so it cannot serve pt_static; neither does the port."""
    if qcfg.mode == "pt_static":
        raise ValueError(
            "encdec serving runs pt_static nowhere: the reference's prefill "
            "and decode_step call lm_head without site scales (a static "
            "head quantizer has no range there), so its engines fail on "
            "pt_static; serve none, pt_dynamic (true_int8 or not) or "
            "ptoken_dynamic")


def _head(params: Params, x: Tensor, cfg: ModelConfig,
          qcfg: QuantConfig) -> Tensor:
    """The serving head: no site scales, as in the reference."""
    return C.lm_head(params, x, cfg, qcfg, None, None)


def prefill(params, tokens: Tensor, cache: Params, cfg: ModelConfig,
            qcfg: QuantConfig, *, frames: Tensor,
            scales: Optional[Params] = None,
            cushion: Optional[Params] = None, remat: bool = False
            ) -> Tuple[Tensor, Params, Tensor]:
    """Encode ``frames``, run the prompt, and fill the cache in place: the
    cushion KV at [0:m) of every row, the prompt's at [m:m+S), the
    cross-attention KV of every layer. Returns (last-position logits
    (B,1,V), cache, next_pos)."""
    check_serving_quant(qcfg)
    params = C.as_tree(params)
    enc_out, _ = encode(params, frames, cfg, qcfg, scales, remat=remat)
    x = C.embed_tokens(params, tokens, cfg)
    S = x.shape[1]
    cache, m = T.write_cushion_to_cache(cache, cushion)
    positions = m + torch.arange(S, device=x.device)
    L = cfg.n_layers
    lscales = _dec_scales(scales, cfg, qcfg, x.device)
    ks, vs = [], []
    pre = T._cushion_layers(T.local_cushion(cushion, cfg), L)
    for l, (lp, lsc, lpre) in enumerate(zip(C.unstack(params["decoder"], L),
                                            C.unstack(lscales, L), pre)):
        hn = C.apply_norm(lp["ln1"], x, cfg)
        a, (k, v) = C.attention_full(lp["attn"], hn, cfg, qcfg, lsc, None,
                                     positions, prefix_kv=lpre, causal=True,
                                     return_kv=True)
        x = x + a
        ks.append(k)
        vs.append(v)
        hn = C.apply_norm(lp["lnx"], x, cfg)
        xk, xv = enc_kv(lp["xattn"], enc_out, cfg)
        cache["xk"][l].copy_(xk)
        cache["xv"][l].copy_(xv)
        x = x + cross_attention(lp["xattn"], hn, (xk, xv), cfg, qcfg, lsc,
                                None)
        hn = C.apply_norm(lp["ln2"], x, cfg)
        x = x + C.apply_mlp(lp["mlp"], hn, cfg, qcfg, lsc, None)
    cache = T.write_prompt_kv(cache, torch.stack(ks), torch.stack(vs), m)
    x = C.apply_norm(params["ln_f"], x, cfg)
    logits = _head(params, x[:, -1:], cfg, qcfg)
    return logits, cache, torch.tensor(m + S, dtype=torch.int32,
                                       device=x.device)


def decode_step(params, token: Tensor, pos: Tensor, cache: Params,
                cfg: ModelConfig, qcfg: QuantConfig, *,
                scales: Optional[Params] = None) -> Tuple[Tensor, Params]:
    """One decode step; pos () shared or (B,) per row. The self-attention
    KV is written per row in place (``attention_decode_kv``); the
    cross-attention reads the row's encoder states from ``xk`` / ``xv``."""
    check_serving_quant(qcfg)
    params = C.as_tree(params)
    L = cfg.n_layers
    x = C.embed_tokens(params, token[:, None], cfg)
    lscales = _dec_scales(scales, cfg, qcfg, x.device)
    for l, (lp, lsc) in enumerate(zip(C.unstack(params["decoder"], L),
                                      C.unstack(lscales, L))):
        hn = C.apply_norm(lp["ln1"], x, cfg)
        a, _ = C.attention_decode_kv(lp["attn"], hn,
                                     {"k": cache["k"][l], "v": cache["v"][l]},
                                     pos, cfg, qcfg, lsc, None)
        x = x + a
        hn = C.apply_norm(lp["lnx"], x, cfg)
        x = x + cross_attention(lp["xattn"], hn,
                                (cache["xk"][l], cache["xv"][l]), cfg, qcfg,
                                lsc, None)
        hn = C.apply_norm(lp["ln2"], x, cfg)
        x = x + C.apply_mlp(lp["mlp"], hn, cfg, qcfg, lsc, None)
    x = C.apply_norm(params["ln_f"], x, cfg)
    return _head(params, x, cfg, qcfg)[:, 0], cache


def placeholder_all_scales(cfg: ModelConfig, device) -> Params:
    return {"enc": C.placeholder_scales(ENC_SITES, cfg.encdec.encoder_layers,
                                        device),
            "dec": C.placeholder_scales(DEC_SITES, cfg.n_layers, device),
            "head": Q.SiteScale(
                scale=torch.ones((), dtype=torch.float32, device=device),
                zero=torch.zeros((), dtype=torch.float32, device=device))}
