"""Jamba-style hybrid, ported from ``repro/models/hybrid.py``: periods of
``period`` layers, attention at the ``attn_at`` indices and the Mamba mixer
(``models/ssm.py``) at the others; each layer is followed by an MLP, MoE
(``models/moe.py``) where ``index % moe_every == moe_offset`` and dense
otherwise.

    init_params(cfg, gen)                      -> ParamTree
    forward(params, tokens, cfg, qcfg, ...)    -> (logits, taps[, state])
    loss_fn(params, tokens, labels, ...)       -> (loss, aux)
    init_cache(cfg, B, Smax, device, ...)      -> cache
    prefill(params, tokens, cache, ...)        -> (logits, cache, pos)
    decode_step(params, token, pos, cache, ..) -> (logits, cache)

Parameters: ``params["layers"] = {"sub": [sublayer dict, ...]}``, a list of
``period`` dicts whose leaves are stacked over the periods ``(P, ...)``,
the reference's layout (its ``vmap`` over ``period_init``), so converted
JAX weights and the port's own init have one shape. The period stack is a
Python loop over per-period views, its sublayers unrolled; site scales are
one per period and site (the statistics of a period's sublayers merge by
min / max, ``_merge_taps``).

Cushion: the attention layers take the paper's prefix KV ``kv`` ((P, m, K,
hd), one block a period, shared by the period's attention layers), the
Mamba layers an initial state ``state`` ({"h": (P, nm, inner, N), "conv":
(P, nm, d_conv-1, inner)}). The search scores with ``greedy_search_ref``
(a padded prefix cannot be masked out of a recurrence), and prefix tuning
trains ``kv`` only.

Cache: attention KV ``k`` / ``v`` (P, B, Smax, K, hd) (int8 with per-head
``(P, K)`` or per-slot ``(P, B, K)`` scales and the fp cushion ``kc`` /
``vc``, or fp), and the Mamba state, always fp: ``h`` (P, nm, B, inner, N)
f32 and ``conv`` (P, nm, B, d_conv-1, inner) in the model dtype. Prefill
and decode write every leaf in place: a captured decode step reads the
tensors it was captured on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core import quantization as Q
from repro_torch.models import common as C
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T

Tensor = torch.Tensor
Params = Dict[str, Any]

SITES = ("qkv", "o", "mamba_in", "mamba_out", "mlp_in", "down")

# The prefix artifact holds Mamba state: a padded prefix cannot be masked
# out of a recurrence, so the search scores with greedy_search_ref.
SUPPORTS_PREFIX_KV_SCORING = False

# Slot layout: attention leaves batch on axis 1, Mamba state on axis 2
# (after the period and sublayer axes); an admission copies the whole row.
CACHE_BATCH_AXES = {"k": 1, "v": 1, "h": 2, "conv": 2}

# Attention KV pages; the Mamba state keeps a dense per-slot row.
PAGED_KV_LEAVES = ("k", "v")

total_qerr = T.total_qerr


def layout(cfg: ModelConfig) -> Tuple[int, List[Tuple[str, str]]]:
    """(number of periods, [(mixer, mlp) of each sublayer])."""
    h = cfg.hybrid
    if cfg.n_layers % h.period:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"the period {h.period}")
    kinds = []
    for i in range(h.period):
        mixer = "attn" if i in h.attn_at else "mamba"
        mlp = "moe" if i % h.moe_every == h.moe_offset else "dense"
        kinds.append((mixer, mlp))
    return cfg.n_layers // h.period, kinds


def n_mamba_per_period(cfg: ModelConfig) -> int:
    return sum(1 for m, _ in layout(cfg)[1] if m == "mamba")


def period_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    sub = []
    for mixer, mlp in layout(cfg)[1]:
        d = {"ln1": C.norm_init(cfg, gen.device),
             "ln2": C.norm_init(cfg, gen.device)}
        if mixer == "attn":
            d["attn"] = C.attn_init(gen, cfg)
        else:
            d["mamba"] = SSM.mamba_init(gen, cfg)
        if mlp == "moe":
            d["moe"] = MOE.moe_init(gen, cfg)
        else:
            d["mlp"] = C.mlp_init(gen, cfg)
        sub.append(d)
    return {"sub": sub}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> C.ParamTree:
    """Seeded random weights on the generator's device."""
    n_periods, _ = layout(cfg)
    p = C.embed_init(gen, cfg)
    p["layers"] = C.stack_trees([period_init(gen, cfg)
                                 for _ in range(n_periods)])
    p["ln_f"] = C.norm_init(cfg, gen.device)
    return C.ParamTree(p)


def _merge_taps(acc: Dict, new: Dict) -> Dict:
    """Merge one sublayer's site statistics into the period's: min / max of
    the ranges, the channel maxima where the widths agree, L_q summed."""
    for site, st in new.items():
        a = acc.get(site)
        if a is None:
            acc[site] = st
            continue
        merged = {
            "amin": torch.minimum(a["amin"], st["amin"]),
            "amax": torch.maximum(a["amax"], st["amax"]),
            "absmax_ch": (torch.maximum(a["absmax_ch"], st["absmax_ch"])
                          if a["absmax_ch"].shape == st["absmax_ch"].shape
                          else a["absmax_ch"])}
        if "qerr" in a and "qerr" in st:
            merged["qerr"] = a["qerr"] + st["qerr"]
        acc[site] = merged
    return acc


def _mixer(sub: Params, mixer: str, hn: Tensor, cfg: ModelConfig,
           qcfg: QuantConfig, lsc, taps, positions, prefix_kv, state,
           n_skip: int, groups: int, want_kv: bool, want_state: bool):
    """One sublayer's mixer: (out, its KV or None, its final state or
    None)."""
    if mixer == "attn":
        o = C.attention_full(sub["attn"], hn, cfg, qcfg, lsc, taps,
                             positions, prefix_kv=prefix_kv, causal=True,
                             n_skip=n_skip, return_kv=want_kv, groups=groups)
        return (o[0], o[1], None) if want_kv else (o, None, None)
    o = SSM.apply_mamba(sub["mamba"], hn, cfg, qcfg, lsc, taps, n_skip,
                        init_state=state, return_state=want_state,
                        groups=groups)
    return (o[0], None, o[1]) if want_state else (o, None, None)


def _period_apply(pp: Params, x: Tensor, cfg: ModelConfig, qcfg: QuantConfig,
                  lsc: Optional[Params], positions: Tensor,
                  prefix_kv: Optional[Params],
                  mamba_states: Optional[List[Params]], collect: bool,
                  n_skip: int, want_kv: bool = False,
                  want_state: bool = False, groups: int = 1):
    """One period. prefix_kv: the period's cushion KV ((m, K, hd) each) or
    None, shared by its attention layers; mamba_states: the initial state
    of each Mamba sublayer, or None. Returns (x, merged taps or None, the
    period's load-balance loss, the attention KV (the last attention
    sublayer's) or None, [the Mamba sublayers' final states])."""
    taps_acc: Optional[Dict] = {} if collect else None
    lb_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_kv, new_states = None, []
    mi = 0
    for sub, (mixer, mlp) in zip(pp["sub"], layout(cfg)[1]):
        taps: Optional[Dict] = {} if collect else None
        hn = C.apply_norm(sub["ln1"], x, cfg)
        if collect:
            taps["block_in"] = Q.site_stats(x, n_skip)
        st = None
        if mixer == "mamba":
            st = mamba_states[mi] if mamba_states is not None else None
            mi += 1
        o, kv, nst = _mixer(sub, mixer, hn, cfg, qcfg, lsc, taps, positions,
                            prefix_kv, st, n_skip, groups, want_kv,
                            want_state)
        if kv is not None:
            new_kv = kv
        if nst is not None:
            new_states.append(nst)
        x = x + o
        hn = C.apply_norm(sub["ln2"], x, cfg)
        if mlp == "moe":
            y, lb = MOE.apply_moe(sub["moe"], hn, cfg, qcfg, lsc, taps,
                                  n_skip, groups)
            lb_total = lb_total + lb
        else:
            y = C.apply_mlp(sub["mlp"], hn, cfg, qcfg, lsc, taps, n_skip,
                            groups)
        x = x + y
        if collect:
            taps_acc = _merge_taps(taps_acc, taps)
    return x, taps_acc, lb_total, new_kv, new_states


def cushion_zeros(cfg: ModelConfig, m: int, device, dtype=None) -> Params:
    """Prefix KV for the attention layers and initial states for the Mamba
    layers (batch-free, broadcast at use), all in the model dtype by
    default (``h`` too, as the reference)."""
    dtype = C.dtype_of(cfg) if dtype is None else dtype
    n_periods, _ = layout(cfg)
    K, hd = cfg.n_kv_heads, cfg.head_dim
    nm = n_mamba_per_period(cfg)
    inner, d_state, d_conv, _ = SSM.dims(cfg)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"kv": {"k": z(n_periods, m, K, hd), "v": z(n_periods, m, K, hd)},
            "state": {"h": z(n_periods, nm, inner, d_state),
                      "conv": z(n_periods, nm, d_conv - 1, inner)}}


def _cushion_states(cushion: Optional[Params], n_periods: int, nm: int
                    ) -> List[Optional[List[Params]]]:
    """Per period, the initial state of each Mamba sublayer (or None)."""
    if cushion is None:
        return [None] * n_periods
    if "state" not in cushion:
        raise ValueError("a hybrid cushion carries the Mamba layers' "
                         "initial state beside its KV ('state')")
    st = cushion["state"]
    return [[{"h": st["h"][p, i], "conv": st["conv"][p, i]}
             for i in range(nm)] for p in range(n_periods)]


def local_cushion(cushion: Optional[Params], cfg: ModelConfig
                  ) -> Optional[Params]:
    """The cushion as a tensor-parallel rank reads it: the KV on its KV
    heads (``transformer.local_cushion``) and the Mamba state on its
    channels where they are cut (itself on one rank)."""
    if cushion is None:
        return None
    out = {"kv": T.local_cushion(cushion, cfg)["kv"]}
    if "state" in cushion:
        inner = SSM.dims(cfg)[0]
        out["state"] = {
            "h": C.local_heads(cushion["state"]["h"], inner),
            "conv": C.local_heads(cushion["state"]["conv"], inner, -1)}
    return out


def cushion_summed(cushion: Params, cfg: ModelConfig) -> Params:
    """Which leaves of the cushion a tensor-parallel rank reads in part
    (``local_cushion``), a tree of bools: the KV as
    ``transformer.cushion_summed``, the Mamba state where its channels are
    cut (the rank's slice)."""
    kv = T.cushion_summed(cushion, cfg)["kv"]
    cut = C.tp_cut(cfg, "inner")
    return {g: kv if g == "kv" else {k: cut for k in leaves}
            for g, leaves in cushion.items()}


def _stack_states(states: List[Params]) -> Params:
    return {"h": torch.stack([s["h"] for s in states]),
            "conv": torch.stack([s["conv"] for s in states])}


def forward(params, tokens: Tensor, cfg: ModelConfig, qcfg: QuantConfig, *,
            scales: Optional[Params] = None, cushion: Optional[Params] = None,
            collect: bool = False, n_skip: int = 0,
            prepend_embeds: Optional[Tensor] = None,
            return_cache: bool = False, groups: int = 1, remat: bool = True):
    """Full-sequence forward. The taps always hold ``lb_loss`` (the MoE
    layers' load-balance loss summed over a period, averaged over the
    periods); with ``collect`` also every site's statistics, merged over a
    period's sublayers and stacked over the periods. ``return_cache`` adds
    the Mamba state after the sequence, {"h": (P, nm, B, inner, N),
    "conv": (P, nm, B, d_conv-1, inner)}. ``groups``: stacked forwards,
    as ``transformer.forward``. ``remat``: one checkpoint a period, the
    reference's scan body (``common.remat_call``)."""
    params = C.as_tree(params)
    n_periods, _ = layout(cfg)
    nm = n_mamba_per_period(cfg)
    x = T.embed_with_prepend(params, tokens, cfg, prepend_embeds)
    S = x.shape[1]
    m = 0 if cushion is None else cushion["kv"]["k"].shape[1]
    positions = m + torch.arange(S, device=x.device)
    lscales = C.resolve_scales(scales, SITES, n_periods, qcfg, x.device)
    layer_taps, lbs, states = [], [], []
    for pp, lsc, pkv, mst in zip(C.unstack(params["layers"], n_periods),
                                 C.unstack(lscales, n_periods),
                                 T._cushion_layers(cushion, n_periods),
                                 _cushion_states(cushion, n_periods, nm)):
        x, taps, lb, _, new_st = C.remat_call(
            remat, _period_apply, pp, x, cfg, qcfg, lsc, positions, pkv,
            mst, collect, n_skip, False, return_cache, groups)
        layer_taps.append(taps)
        lbs.append(lb)
        if return_cache:
            states.append(_stack_states(new_st))
    x = C.apply_norm(params["ln_f"], x, cfg)
    head_taps: Optional[Dict] = {} if collect else None
    logits = C.lm_head(params, x, cfg, qcfg, scales, head_taps, n_skip,
                       groups)
    out: Dict = {"lb_loss": torch.stack(lbs).mean()}
    if collect:
        out.update({"layers": C.stack_trees(layer_taps), **head_taps,
                    "final_in": Q.site_stats(x, n_skip)})
    if return_cache:
        return logits, out, C.stack_trees(states)
    return logits, out


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def cache_roles(cfg: ModelConfig, kv_dtype=None,
                per_slot_scales: bool = False) -> Params:
    """Serving cache roles, the reference's (``transformer.cache_roles``):
    attention KV (P, B, S, K, hd) on its heads axis, the Mamba state on
    its channels (h (P, nm, B, inner, d_state), conv (P, nm, B, d_conv-1,
    inner)); int8 scales with their heads, the cushion block replicated.
    A tensor-parallel rank holds its KV heads (all of them where they do
    not divide) and its channels of the state (``ssm.dims``)."""
    kv = (None, "B", None, "M", None)
    roles = {"k": kv, "v": kv,
             "h": (None, None, "B", "M", None),
             "conv": (None, None, "B", None, "M")}
    if kv_dtype is not None:
        sc = (None, "B", "M") if per_slot_scales else (None, "M")
        roles.update({"k_scale": sc, "v_scale": sc, "kc": (), "vc": ()})
    return roles


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
               dtype=None, kv_dtype=None, prefix_len: int = 0,
               per_slot_scales: bool = False) -> Params:
    """The dense family's KV layout over the periods (int8 with per-head
    scales, per-slot ones with ``per_slot_scales``, and the fp cushion
    block kc/vc), and the Mamba state, always fp."""
    dt = dtype or C.dtype_of(cfg)
    n_periods, _ = layout(cfg)
    nm = n_mamba_per_period(cfg)
    inner, d_state, d_conv, _ = SSM.dims(cfg)
    cache = T.init_cache(dataclasses.replace(cfg, n_layers=n_periods),
                         batch, max_seq, device, dtype=dt,
                         kv_dtype=kv_dtype, prefix_len=prefix_len,
                         per_slot_scales=per_slot_scales)
    cache["h"] = torch.zeros((n_periods, nm, batch, inner, d_state),
                             dtype=torch.float32, device=device)
    cache["conv"] = torch.zeros((n_periods, nm, batch, d_conv - 1, inner),
                                dtype=dt, device=device)
    return cache


def prefill(params, tokens: Tensor, cache: Params, cfg: ModelConfig,
            qcfg: QuantConfig, *, scales: Optional[Params] = None,
            cushion: Optional[Params] = None,
            prepend_embeds: Optional[Tensor] = None, remat: bool = False
            ) -> Tuple[Tensor, Params, Tensor]:
    """Process the prompt and fill the cache: the cushion KV at [0:m) (into
    kc/vc, or every row of the fp cache), the prompt KV at [m:m+S), and the
    Mamba state after the prompt, each Mamba sublayer seeded by the
    cushion's ``state``. Returns (last-position logits (B,1,V), cache,
    next_pos). In place."""
    params = C.as_tree(params)
    n_periods, _ = layout(cfg)
    nm = n_mamba_per_period(cfg)
    x = T.embed_with_prepend(params, tokens, cfg, prepend_embeds)
    S = x.shape[1]
    cache, m = T.write_cushion_to_cache(cache, cushion)
    positions = m + torch.arange(S, device=x.device)
    lscales = C.resolve_scales(scales, SITES, n_periods, qcfg, x.device)
    ks, vs, states = [], [], []
    local = local_cushion(cushion, cfg)
    for pp, lsc, pkv, mst in zip(C.unstack(params["layers"], n_periods),
                                 C.unstack(lscales, n_periods),
                                 T._cushion_layers(local, n_periods),
                                 _cushion_states(local, n_periods, nm)):
        x, _, _, (k, v), new_st = C.remat_call(
            remat, _period_apply, pp, x, cfg, qcfg, lsc, positions, pkv,
            mst, False, 0, True, True)
        ks.append(k)
        vs.append(v)
        states.append(_stack_states(new_st))
    cache = T.write_prompt_kv(cache, torch.stack(ks), torch.stack(vs), m)
    st = C.stack_trees(states)
    cache["h"].copy_(st["h"])
    cache["conv"].copy_(st["conv"])
    x = C.apply_norm(params["ln_f"], x, cfg)
    logits = C.lm_head(params, x[:, -1:], cfg, qcfg, scales, None)
    return logits, cache, torch.tensor(m + S, dtype=torch.int32,
                                       device=x.device)


_KV_KEYS = ("k", "v", "k_scale", "v_scale", "kc", "vc", "kc_tp", "vc_tp",
            "page_table")


def decode_step(params, token: Tensor, pos: Tensor, cache: Params,
                cfg: ModelConfig, qcfg: QuantConfig, *,
                scales: Optional[Params] = None) -> Tuple[Tensor, Params]:
    """One decode step; pos () shared or (B,) per row. The attention
    sublayers write and mask per row (``attention_decode_kv``); the Mamba
    recurrence is position-free and advances every row (a retired slot's
    state takes dummy updates and is rebuilt whole at its next admission).
    Every leaf is written in place, the Mamba ``h`` and ``conv`` included."""
    params = C.as_tree(params)
    n_periods, kinds = layout(cfg)
    x = C.embed_tokens(params, token[:, None], cfg)
    lscales = C.resolve_scales(scales, SITES, n_periods, qcfg, x.device)
    kv_all = C.unstack({k: cache[k] for k in _KV_KEYS if k in cache},
                       n_periods)
    for p, (pp, lsc, kv) in enumerate(zip(
            C.unstack(params["layers"], n_periods),
            C.unstack(lscales, n_periods), kv_all)):
        mi = 0
        for sub, (mixer, mlp) in zip(pp["sub"], kinds):
            hn = C.apply_norm(sub["ln1"], x, cfg)
            if mixer == "attn":
                o, _ = C.attention_decode_kv(sub["attn"], hn, kv, pos, cfg,
                                             qcfg, lsc, None)
            else:
                h, conv = cache["h"][p, mi], cache["conv"][p, mi]
                o, nst = SSM.decode_mamba(sub["mamba"], hn,
                                          {"h": h, "conv": conv}, cfg, qcfg,
                                          lsc)
                h.copy_(nst["h"])
                conv.copy_(nst["conv"])
                mi += 1
            x = x + o
            hn = C.apply_norm(sub["ln2"], x, cfg)
            if mlp == "moe":
                x = x + MOE.apply_moe(sub["moe"], hn, cfg, qcfg, lsc,
                                      None)[0]
            else:
                x = x + C.apply_mlp(sub["mlp"], hn, cfg, qcfg, lsc, None)
    x = C.apply_norm(params["ln_f"], x, cfg)
    logits = C.lm_head(params, x, cfg, qcfg, scales, None)
    return logits[:, 0], cache


def loss_fn(params, tokens: Tensor, labels: Tensor, cfg: ModelConfig,
            qcfg: QuantConfig, *, scales=None, cushion=None,
            collect: bool = False, n_skip: int = 0, remat: bool = True,
            lam: float = 0.0):
    """CE + ``load_balance_coef`` * lb (+ λ·L_q when ``lam`` > 0), as
    ``moe.loss_fn``."""
    logits, taps = forward(params, tokens, cfg, qcfg, scales=scales,
                           cushion=cushion, collect=collect or lam > 0,
                           n_skip=n_skip, remat=remat)
    if n_skip:
        logits = logits[:, n_skip:]
        labels = labels[:, n_skip:]
    ce = C.cross_entropy(logits, labels)
    loss = ce + cfg.moe.load_balance_coef * taps["lb_loss"]
    aux = {"ce": ce, "taps": taps, "lb": taps["lb_loss"]}
    if lam > 0 or collect:
        qerr = total_qerr(taps)
        aux["qerr"] = qerr
        if lam > 0:
            loss = loss + lam * qerr
    return loss, aux


def placeholder_all_scales(cfg: ModelConfig, device) -> Params:
    n_periods, _ = layout(cfg)
    sc = C.placeholder_scales(SITES, n_periods, device)
    sc["head"] = Q.SiteScale(
        scale=torch.ones((), dtype=torch.float32, device=device),
        zero=torch.zeros((), dtype=torch.float32, device=device))
    return sc
