"""Mixture-of-Experts decoder (olmoe: 64 experts, top-8; arctic: 128
experts, top-2 and a dense residual branch), ported from
``repro/models/moe.py``:

    init_params(cfg, gen)                      -> ParamTree
    forward(params, tokens, cfg, qcfg, ...)    -> (logits, taps)
    loss_fn(params, tokens, labels, ...)       -> (loss, aux)
    prefill(params, tokens, cache, ...)        -> (logits, cache, pos)
    decode_step(params, token, pos, cache, ..) -> (logits, cache)

The layers are the dense family's (``models/transformer.py``) with the MLP
replaced by capacity-based dense dispatch (GShard / Switch): each batch row
routes its S tokens to their top-K experts, an expert takes at most
``capacity(S)`` (token, k) entries of a row in s-major, k-minor order, and
the entries past it are dropped (the token passes through the residual).
The cache layout, the cushion and the int8 KV are the dense family's.

Port notes:

* Routing runs in f32: ``x.float() @ router`` (the router stays f32 in a
  bf16 model; ``common.matmul_rows``, so a decode row routes alike in a
  pool and alone), softmax, the top K and their renormalisation. Ties between
  experts go to the lower index, as in ``jax.lax.top_k``: the top K are
  the first K of a stable descending sort (``torch.topk`` promises no
  order among equal values).
* The slot one-hot is a comparison of the f32 slot position with
  ``arange(capacity)``, as ``jax.nn.one_hot`` computes it: a position of
  -1 (the expert was not picked) or >= capacity (the entry is dropped)
  matches no slot. ``F.one_hot`` would need int64 and check its range on
  the host, a sync that a captured decode step refuses.
* The expert tensors keep the batch axis first, ``(B, E, C, .)`` (the
  reference's are ``(E, B, C, .)``), so with ``groups`` > 1 (the search's
  stacked candidates) every dynamic range and L_q of the ``mlp_in`` and
  ``down`` sites reduces per candidate, as under the reference's vmap.
  Empty capacity slots are zero rows and count in the ``down`` site's
  range, statistics and L_q, as in the reference.
* The experts always run ``act_fake_quant`` / ``weight_fake_quant`` and an
  einsum, under every mode (``true_int8`` and int8-resident weights
  included): ``prequantize_tree`` leaves every ``moe`` leaf fp. The
  arctic residual branch is a dense MLP (``common.apply_mlp``), whose
  linears take the int path under ``true_int8``; it shares the ``mlp_in``
  and ``down`` site scales and records no taps.
* Expert parallelism (a tensor-parallel rank's config with its experts
  cut, ``common.tp_cut``): a rank holds E/tp experts, its slice of the
  ``w_*`` leaves. Every rank routes the same way, over all E experts (the
  router is whole): ``route``, the load-balance loss, the capacity and
  the dispatch are the one-rank ones. A rank gathers the tokens for its
  experts only, runs their einsums and combines with their columns of the
  combine weights; one ``psum`` (f32) sums the ranks' partial outputs.
  The experts' weight quantization is per expert and column, so a rank's
  quantize as on one rank. The residual branch is whole on every rank
  (the reference's rules replicate it) and takes no collective.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core import quantization as Q
from repro_torch.distributed import collectives as DC
from repro_torch.models import common as C
from repro_torch.models import transformer as T

Tensor = torch.Tensor
Params = Dict[str, Any]

SITES = C.ATTN_SITES + C.MLP_SITES  # ("qkv", "o", "mlp_in", "down")
# under GSPMD the reference's load-balance means (and its dispatch) span the
# global batch; over a data axis of ranks that needs collectives in the
# routing, which are not written
DATA_AXIS_LATER = ("the experts' routing statistics over a data axis of "
                   "more than one rank are not ported yet (ROADMAP queue 1, "
                   "item 6.11)")

# The prefix artifact is attention KV only, so the search's KV-reuse scorer
# applies. Its contract for MoE: expert capacity comes from the scored
# sequence ([candidate; sample]) and the "down" site's L_q covers that
# sequence's expert traffic only; prefix tokens never re-enter the experts,
# as at deployment (the full-forward scorer routes them through the experts
# as a side effect of recomputing them).
SUPPORTS_PREFIX_KV_SCORING = True

init_cache = T.init_cache
cache_roles = T.cache_roles
cushion_zeros = T.cushion_zeros
cushion_summed = T.cushion_summed
write_cushion_to_cache = T.write_cushion_to_cache
finalize_staged_kv = T.finalize_staged_kv
total_qerr = T.total_qerr
CACHE_BATCH_AXES = T.CACHE_BATCH_AXES
PAGED_KV_LEAVES = T.PAGED_KV_LEAVES
SUPPORTS_CHUNKED_PREFILL = T.SUPPORTS_CHUNKED_PREFILL


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    moe = cfg.moe
    dt = C.dtype_of(cfg)
    E, D, Fd = moe.num_experts, cfg.d_model, cfg.d_ff
    std_in = 1.0 / np.sqrt(D)
    std_out = 1.0 / np.sqrt(Fd) / np.sqrt(2 * cfg.n_layers)

    def randn(*shape):
        return C.draw(gen, shape)

    p = {"router": randn(D, E) * std_in,
         "w_up": (randn(E, D, Fd) * std_in).to(dt),
         "w_gate": (randn(E, D, Fd) * std_in).to(dt),
         "w_down": (randn(E, Fd, D) * std_out).to(dt)}
    if moe.dense_residual_ff:
        p["residual"] = C.mlp_init(gen, cfg, d_ff=moe.dense_residual_ff)
    return p


def capacity(seq: int, cfg: ModelConfig) -> int:
    """Slots per expert and batch row for a sequence of ``seq`` tokens: a
    Python int from the shape, a multiple of 4, at least 4."""
    moe = cfg.moe
    c = int(np.ceil(seq * moe.top_k / moe.num_experts * moe.capacity_factor))
    c = min(c, seq * moe.top_k)
    return max(4, int(np.ceil(c / 4)) * 4)


def route(x: Tensor, router: Tensor, top_k: int
          ) -> Tuple[Tensor, Tensor, Tensor]:
    """f32 gate probabilities (B, S, E), the renormalised top-K weights and
    their expert ids (B, S, K); ties go to the lower expert id."""
    probs = torch.softmax(C.matmul_rows(x.float(), router), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w = vals[..., :top_k]
    return probs, top_w / top_w.sum(dim=-1, keepdim=True), idx[..., :top_k]


def dispatch(onehot: Tensor, cap: int) -> Tensor:
    """onehot: (B, S, K, E) f32, the expert of each (token, k) entry ->
    (B, S, K, E, cap) f32 one-hot of the entry's slot in its expert, all
    zero where the entry is dropped. An expert's slots fill in s-major,
    k-minor order within a batch row."""
    B, S, K, E = onehot.shape
    flat = onehot.reshape(B, S * K, E)
    pos = torch.cumsum(flat, dim=1) - 1.0                    # (B,S*K,E)
    keep = (pos < cap).float() * flat
    slot = (pos[..., None] == torch.arange(cap, device=onehot.device,
                                           dtype=torch.float32)).float()
    return (slot * keep[..., None]).reshape(B, S, K, E, cap)


def apply_moe(p: Params, x: Tensor, cfg: ModelConfig, qcfg: QuantConfig,
              scales: Optional[Params], taps: Optional[Dict],
              n_skip: int = 0, groups: int = 1) -> Tuple[Tensor, Tensor]:
    """Returns (y, load-balance loss). x: (B, S, D). Refuses a data axis
    of more than one rank (``DATA_AXIS_LATER``)."""
    if DC.data_size() > 1:
        raise ValueError(DATA_AXIS_LATER)
    moe = cfg.moe
    B, S, D = x.shape
    E, K = moe.num_experts, moe.top_k
    Cp = capacity(S, cfg)

    probs, top_w, top_idx = route(x, p["router"], K)
    # Switch-style load-balance loss: E * sum_e mean(frac_e) * mean(prob_e)
    onehot = (top_idx[..., None] == torch.arange(E, device=x.device)
              ).float()                                      # (B,S,K,E)
    frac = onehot.sum(dim=2).mean(dim=(0, 1))
    lb = E * (frac * probs.mean(dim=(0, 1))).sum()

    disp = dispatch(onehot, Cp).to(x.dtype)                  # (B,S,K,E,C)
    comb = torch.einsum("bsk,bskec->bsec", top_w.to(x.dtype), disp)
    disp_tok = disp.sum(dim=2)                               # (B,S,E,C)
    cut = C.tp_cut(cfg, "experts")
    if cut:
        # this rank's experts: its columns of the dispatch and combine
        El = p["w_up"].shape[0]
        comb = comb.narrow(2, DC.tp_rank() * El, El)
        disp_tok = disp_tok.narrow(2, DC.tp_rank() * El, El)

    if taps is not None:
        taps["mlp_in"] = {
            "qerr": Q.site_qerr(x, qcfg, C.get_site(scales, "mlp_in"),
                                n_skip, groups),
            **Q.site_stats(x, n_skip)}

    xin = torch.einsum("bsec,bsd->becd", disp_tok, x)        # (B,E,C,D)
    qs = C.get_site(scales, "mlp_in")
    xq = Q.act_fake_quant(xin, qcfg, qs.scale if qs else None,
                          qs.zero if qs else None, groups)
    up = torch.einsum("becd,edf->becf", xq,
                      Q.weight_fake_quant(p["w_up"], qcfg))
    gate = torch.einsum("becd,edf->becf", xq,
                        Q.weight_fake_quant(p["w_gate"], qcfg))
    h = F.silu(gate) * up
    qs2 = C.get_site(scales, "down")
    if taps is not None:
        taps["down"] = {"qerr": Q.site_qerr(h, qcfg, qs2, 0, groups),
                        **Q.site_stats(h, 0)}
    hq = Q.act_fake_quant(h, qcfg, qs2.scale if qs2 else None,
                          qs2.zero if qs2 else None, groups)
    out = torch.einsum("becf,efd->becd", hq,
                       Q.weight_fake_quant(p["w_down"], qcfg))
    if cut:
        # the rank's partial output in f32, summed over the ranks and
        # rounded once, as one rank's einsum rounds its f32 sum once
        y = DC.psum(torch.einsum("bsec,becd->bsd", comb.float(),
                                 out.float())).to(x.dtype)
    else:
        y = torch.einsum("bsec,becd->bsd", comb, out)

    if "residual" in p:
        # arctic: a dense FFN branch beside the experts, whole on every rank
        y = y + C.apply_mlp(p["residual"], x, cfg, qcfg, scales, None,
                            n_skip, groups, cut=False)
    return y, lb


def layer_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"ln1": C.norm_init(cfg, gen.device),
            "attn": C.attn_init(gen, cfg),
            "ln2": C.norm_init(cfg, gen.device),
            "moe": moe_init(gen, cfg)}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> C.ParamTree:
    """Seeded random weights on the generator's device."""
    p = C.embed_init(gen, cfg)
    p["layers"] = C.stack_trees([layer_init(gen, cfg)
                                 for _ in range(cfg.n_layers)])
    p["ln_f"] = C.norm_init(cfg, gen.device)
    return C.ParamTree(p)


def _block(lp: Params, x: Tensor, cfg: ModelConfig, qcfg: QuantConfig,
           lsc: Optional[Params], lpre: Optional[Params], positions: Tensor,
           collect: bool, n_skip: int, prefix_valid: Optional[int] = None,
           groups: int = 1) -> Tuple[Tensor, Dict, Tensor]:
    taps: Optional[Dict] = {} if collect else None
    h = C.apply_norm(lp["ln1"], x, cfg)
    if collect:
        taps["block_in"] = Q.site_stats(x, n_skip)
    x = x + C.attention_full(lp["attn"], h, cfg, qcfg, lsc, taps, positions,
                             prefix_kv=lpre, causal=True, n_skip=n_skip,
                             prefix_valid=prefix_valid, groups=groups)
    h = C.apply_norm(lp["ln2"], x, cfg)
    y, lb = apply_moe(lp["moe"], h, cfg, qcfg, lsc, taps, n_skip, groups)
    return x + y, (taps if collect else {}), lb


def forward(params, tokens: Tensor, cfg: ModelConfig, qcfg: QuantConfig, *,
            scales: Optional[Params] = None, cushion: Optional[Params] = None,
            collect: bool = False, n_skip: int = 0,
            prefix_valid: Optional[int] = None,
            pos_offset: Optional[int] = None,
            groups: int = 1, remat: bool = True) -> Tuple[Tensor, Dict]:
    """Full-sequence causal forward (``transformer.forward``'s arguments).
    The taps always hold ``lb_loss``, the load-balance loss averaged over
    the layers; with ``collect`` also every site's statistics. With
    ``groups`` > 1, ``lb_loss`` is one value over all stacked rows (no
    caller reads it per group)."""
    params = C.as_tree(params)
    L = cfg.n_layers
    x = C.embed_tokens(params, tokens, cfg)
    S = x.shape[1]
    m = 0 if cushion is None else cushion["kv"]["k"].shape[1]
    positions = (m if pos_offset is None else int(pos_offset)) \
        + torch.arange(S, device=x.device)
    lscales = C.resolve_scales(scales, SITES, L, qcfg, x.device)
    layer_taps, lbs = [], []
    for lp, lsc, lpre in zip(C.unstack(params["layers"], L),
                             C.unstack(lscales, L),
                             T._cushion_layers(cushion, L)):
        x, taps, lb = C.remat_call(remat, _block, lp, x, cfg, qcfg, lsc,
                                   lpre, positions, collect, n_skip,
                                   prefix_valid, groups)
        layer_taps.append(taps)
        lbs.append(lb)
    x = C.apply_norm(params["ln_f"], x, cfg)
    head_taps: Optional[Dict] = {} if collect else None
    logits = C.lm_head(params, x, cfg, qcfg, scales, head_taps, n_skip,
                       groups)
    out: Dict = {}
    if collect:
        out = {"layers": C.stack_trees(layer_taps), **head_taps,
               "final_in": Q.site_stats(x, n_skip)}
    out["lb_loss"] = torch.stack(lbs).mean()
    return logits, out


def prefill(params, tokens: Tensor, cache: Params, cfg: ModelConfig,
            qcfg: QuantConfig, *, scales: Optional[Params] = None,
            cushion: Optional[Params] = None,
            pos_offset: Optional[int] = None, remat: bool = False
            ) -> Tuple[Tensor, Params, Tensor]:
    """``transformer.prefill`` with the expert layers. A chunk-resumed
    call (``pos_offset``) sizes the experts' capacity from the chunk's
    length, as the reference does, so where tokens drop a chunked
    admission is not the blocking one."""
    params = C.as_tree(params)
    L = cfg.n_layers
    x = C.embed_tokens(params, tokens, cfg)
    S = x.shape[1]
    if pos_offset is not None:
        if cushion is not None:
            raise ValueError("chunk-resume prefill attaches the cushion on "
                             "chunk 0 only (pos_offset excludes cushion)")
        if "k_scale" in cache:
            raise ValueError("chunk-resume prefill needs an fp staging row")
        if cache["k"].shape[1] != 1:
            raise ValueError("chunk-resume prefill is B=1 only")
        m = int(pos_offset)
        pre = C.unstack({"k": cache["k"][:, 0, :m],
                         "v": cache["v"][:, 0, :m]}, L)
    else:
        cache, m = write_cushion_to_cache(cache, cushion)
        pre = T._cushion_layers(T.local_cushion(cushion, cfg), L)
    positions = m + torch.arange(S, device=x.device)
    lscales = C.resolve_scales(scales, SITES, L, qcfg, x.device)
    ks, vs = [], []
    for lp, lsc, lpre in zip(C.unstack(params["layers"], L),
                             C.unstack(lscales, L), pre):
        x, k, v = C.remat_call(remat, _prefill_block, lp, x, cfg, qcfg, lsc,
                               lpre, positions)
        ks.append(k)
        vs.append(v)
    cache = T.write_prompt_kv(cache, torch.stack(ks), torch.stack(vs), m)
    x = C.apply_norm(params["ln_f"], x, cfg)
    logits = C.lm_head(params, x[:, -1:], cfg, qcfg, scales, None)
    return logits, cache, torch.tensor(m + S, dtype=torch.int32,
                                       device=x.device)


def _prefill_block(lp: Params, x: Tensor, cfg: ModelConfig,
                   qcfg: QuantConfig, lsc: Optional[Params],
                   lpre: Optional[Params], positions: Tensor
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """One layer of the prefill: (x, the layer's K, V)."""
    hn = C.apply_norm(lp["ln1"], x, cfg)
    a, (k, v) = C.attention_full(lp["attn"], hn, cfg, qcfg, lsc, None,
                                 positions, prefix_kv=lpre, causal=True,
                                 return_kv=True)
    x = x + a
    hn = C.apply_norm(lp["ln2"], x, cfg)
    return x + apply_moe(lp["moe"], hn, cfg, qcfg, lsc, None)[0], k, v


def decode_step(params, token: Tensor, pos: Tensor, cache: Params,
                cfg: ModelConfig, qcfg: QuantConfig, *,
                scales: Optional[Params] = None) -> Tuple[Tensor, Params]:
    """One decode step; pos () shared or (B,) per row. At S = 1 an
    expert's capacity and dispatch are per row, so the rows of a
    continuous pool stay independent."""
    params = C.as_tree(params)
    L = cfg.n_layers
    x = C.embed_tokens(params, token[:, None], cfg)
    lscales = C.resolve_scales(scales, SITES, L, qcfg, x.device)
    for lp, lsc, kv in zip(C.unstack(params["layers"], L),
                           C.unstack(lscales, L), C.unstack(cache, L)):
        hn = C.apply_norm(lp["ln1"], x, cfg)
        a, _ = C.attention_decode_kv(lp["attn"], hn, kv, pos, cfg, qcfg, lsc,
                                     None)
        x = x + a
        hn = C.apply_norm(lp["ln2"], x, cfg)
        x = x + apply_moe(lp["moe"], hn, cfg, qcfg, lsc, None)[0]
    x = C.apply_norm(params["ln_f"], x, cfg)
    logits = C.lm_head(params, x, cfg, qcfg, scales, None)
    return logits[:, 0], cache


def loss_fn(params, tokens: Tensor, labels: Tensor, cfg: ModelConfig,
            qcfg: QuantConfig, *, scales=None, cushion=None,
            collect: bool = False, n_skip: int = 0, remat: bool = True,
            lam: float = 0.0):
    """CE + ``load_balance_coef`` * lb (+ λ·L_q when ``lam`` > 0). Returns
    (loss, aux) with aux {"ce", "taps", "lb"} and, when collecting,
    "qerr" (``lb_loss`` carries no L_q)."""
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
