"""Dense decoder-only transformer (llama style; qwen's QKV bias by config),
ported from ``repro/models/transformer.py``:

    init_params(cfg, gen)                      -> ParamTree
    forward(params, tokens, cfg, qcfg, ...)    -> (logits, taps)
    loss_fn(params, tokens, labels, ...)       -> (loss, aux)
    init_cache(cfg, B, Smax, ...)              -> cache
    prefill(params, tokens, cache, ...)        -> (logits, cache, pos)
    decode_step(params, token, pos, cache, ..) -> (logits, cache)

Layer parameters are stacked ``(L, ...)`` in one ``ParamTree`` module; the
layer stack is a Python loop over per-layer views (JAX scans it), and with
``remat`` each layer body is one checkpoint (``common.remat_call``, the
reference's ``jax.checkpoint`` on its scan body). Caches are updated in
place and returned, where JAX returns new arrays.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core import quantization as Q
from repro_torch.models import common as C

Tensor = torch.Tensor
Params = Dict[str, Any]

SITES = C.ATTN_SITES + C.MLP_SITES  # ("qkv", "o", "mlp_in", "down")

# The prefix artifact is pure attention KV, so the greedy search's fast path
# prefills the shared prefix once and scores every candidate against the
# cached block (registry.ModelAPI.score_candidates).
SUPPORTS_PREFIX_KV_SCORING = True

# prefill(pos_offset=...) resumes a partially staged B=1 fp row, so the
# continuous scheduler may admit long prompts chunk by chunk.
SUPPORTS_CHUNKED_PREFILL = True

# Continuous-batching slot layout: batch axis of every per-request cache
# leaf (init_cache puts batch second, after the layer axis).
CACHE_BATCH_AXES = {"k": 1, "v": 1}

# Leaves the paged pool re-lays into a flat page store + per-slot page
# table; every other CACHE_BATCH_AXES entry keeps its dense per-slot row.
PAGED_KV_LEAVES = ("k", "v")


def layer_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"ln1": C.norm_init(cfg, gen.device),
            "attn": C.attn_init(gen, cfg),
            "ln2": C.norm_init(cfg, gen.device),
            "mlp": C.mlp_init(gen, cfg)}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> C.ParamTree:
    """Seeded random weights on the generator's device."""
    p = C.embed_init(gen, cfg)
    p["layers"] = C.stack_trees([layer_init(gen, cfg)
                                 for _ in range(cfg.n_layers)])
    p["ln_f"] = C.norm_init(cfg, gen.device)
    return C.ParamTree(p)


def embed_with_prepend(params: Params, tokens: Tensor, cfg: ModelConfig,
                       prepend_embeds: Optional[Tensor]) -> Tensor:
    """Token embeddings, with ``prepend_embeds`` (B, P, D) before them in
    the model dtype."""
    x = C.embed_tokens(params, tokens, cfg)
    if prepend_embeds is None:
        return x
    return torch.cat([prepend_embeds.to(x.dtype), x], dim=1)


def _cushion_layers(cushion: Optional[Params], L: int) -> List[Optional[Params]]:
    if cushion is None:
        return [None] * L
    return C.unstack(cushion["kv"], L)


def _block(lp: Params, x: Tensor, cfg: ModelConfig, qcfg: QuantConfig,
           lsc: Optional[Params], lpre: Optional[Params], positions: Tensor,
           collect: bool, n_skip: int, prefix_valid: Optional[int] = None,
           groups: int = 1) -> Tuple[Tensor, Dict]:
    taps: Optional[Dict] = {} if collect else None
    h = C.apply_norm(lp["ln1"], x, cfg)
    if collect:
        taps["block_in"] = Q.site_stats(x, n_skip)
    x = x + C.attention_full(lp["attn"], h, cfg, qcfg, lsc, taps, positions,
                             prefix_kv=lpre, causal=True, n_skip=n_skip,
                             prefix_valid=prefix_valid, groups=groups)
    h = C.apply_norm(lp["ln2"], x, cfg)
    x = x + C.apply_mlp(lp["mlp"], h, cfg, qcfg, lsc, taps, n_skip, groups)
    return x, (taps if collect else {})


def forward(params, tokens: Tensor, cfg: ModelConfig, qcfg: QuantConfig, *,
            scales: Optional[Params] = None, cushion: Optional[Params] = None,
            collect: bool = False, n_skip: int = 0,
            prepend_embeds: Optional[Tensor] = None,
            prefix_valid: Optional[int] = None,
            pos_offset: Optional[int] = None,
            groups: int = 1, remat: bool = True) -> Tuple[Tensor, Dict]:
    """Full-sequence causal forward. cushion: {"kv": {"k": (L,m,K,hd), ...}}.
    With ``collect`` the taps hold every site's statistics, layer entries
    stacked over L (the calibration input). prepend_embeds (B, P, D):
    embeddings placed before the token embeddings, in the model dtype (the
    VLM's patches, with the search's prefix or candidate embeddings before
    them).

    prefix_valid / pos_offset serve the search's scoring path: the cushion
    KV is padded to a fixed length, prefix_valid (int) is its live length
    (rows past it are seen by no query: the reference's ``(m,) bool`` mask
    ``arange(m) < prefix_valid``) and pos_offset replaces the cushion length
    as the RoPE origin of the tokens. ``groups`` > 1: the B rows are that
    many independent forwards stacked (the reference vmaps them), each with
    its own dynamic ranges and L_q (``models/common.py``). ``remat``
    recomputes each layer in the backward (``common.remat_call``)."""
    params = C.as_tree(params)
    L = cfg.n_layers
    x = embed_with_prepend(params, tokens, cfg, prepend_embeds)
    S = x.shape[1]
    m = 0 if cushion is None else cushion["kv"]["k"].shape[1]
    positions = (m if pos_offset is None else int(pos_offset)) \
        + torch.arange(S, device=x.device)
    lscales = C.resolve_scales(scales, SITES, L, qcfg, x.device)
    layer_taps = []
    # under tensor parallelism the cushion is whole on every rank and a
    # rank reads its KV heads (the gradient of the others is zero here)
    for lp, lsc, lpre in zip(C.unstack(params["layers"], L),
                             C.unstack(lscales, L),
                             _cushion_layers(local_cushion(cushion, cfg), L)):
        x, taps = C.remat_call(remat, _block, lp, x, cfg, qcfg, lsc, lpre,
                               positions, collect, n_skip, prefix_valid,
                               groups)
        layer_taps.append(taps)
    x = C.apply_norm(params["ln_f"], x, cfg)
    head_taps: Optional[Dict] = {} if collect else None
    logits = C.lm_head(params, x, cfg, qcfg, scales, head_taps, n_skip,
                       groups)
    if not collect:
        return logits, {}
    return logits, {"layers": C.stack_trees(layer_taps), **head_taps,
                    "final_in": Q.site_stats(x, n_skip)}


# ---------------------------------------------------------------------------
# Serving: prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
               dtype=None, kv_dtype=None, prefix_len: int = 0,
               per_slot_scales: bool = False) -> Params:
    """kv_dtype None -> fp cache {"k","v"}; "int8" -> int8 k/v, (L, K) f32
    dequant scales and the fp cushion block kc/vc of ``prefix_len`` rows
    (the int8 tensors hold content positions [prefix_len:max_seq)).
    per_slot_scales gives every batch row its own scales, (L, batch, K), for
    the continuous pool, whose slots calibrate at their own admission."""
    dt = dtype or C.dtype_of(cfg)
    K, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    shape = (L, batch, max_seq, K, hd)
    if kv_dtype is None:
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    if kv_dtype not in ("int8", torch.int8):
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
    sshape = (L, batch, K) if per_slot_scales else (L, K)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.ones(sshape, dtype=torch.float32, device=device),
            "v_scale": torch.ones(sshape, dtype=torch.float32, device=device),
            "kc": torch.zeros((L, prefix_len, K, hd), dtype=dt, device=device),
            "vc": torch.zeros((L, prefix_len, K, hd), dtype=dt, device=device)}


def cache_roles(cfg: ModelConfig, kv_dtype=None,
                per_slot_scales: bool = False) -> Params:
    """The serving cache's sharding roles (``distributed/sharding.py``
    ``cache_shardings``), the reference's: (L, B, S, K, hd) with batch on
    "B" and the KV heads on "M", so decode attention runs on each rank's
    heads with no collective; int8 scales shard with their heads; the fp
    cushion block kc / vc is replicated, whole on every rank (each rank's
    slice is ``kc_tp`` / ``vc_tp``, made when the cushion is written)."""
    kv = (None, "B", None, "M", None)
    roles = {"k": kv, "v": kv}
    if kv_dtype is not None:
        sc = (None, "B", "M") if per_slot_scales else (None, "M")
        roles.update({"k_scale": sc, "v_scale": sc, "kc": (), "vc": ()})
    return roles


def write_cushion_to_cache(cache: Params, cushion: Optional[Params]
                           ) -> Tuple[Params, int]:
    """Put the cushion at positions [0:m): into kc/vc (int8 cache, never
    quantized) or into every row of the fp cache. In place. Under tensor
    parallelism the cushion is the whole artifact: an int8 cache keeps it
    whole in kc/vc and this rank's heads in kc_tp/vc_tp, an fp cache's rows
    [0:m) take this rank's heads."""
    if cushion is None:
        return cache, 0
    kv = cushion["kv"]
    m = kv["k"].shape[1]
    if "kc" in cache:
        if cache["kc"].shape[1] != m:
            raise ValueError(f"cache prefix_len {cache['kc'].shape[1]} != "
                             f"cushion len {m}")
        cache["kc"].copy_(kv["k"])
        cache["vc"].copy_(kv["v"])
        if "kc_tp" in cache:
            n = cache["kc_tp"].shape[-2]
            cache["kc_tp"].copy_(C.local_heads(kv["k"], n))
            cache["vc_tp"].copy_(C.local_heads(kv["v"], n))
        return cache, m
    n = cache["k"].shape[-2]
    cache["k"][:, :, :m] = C.local_heads(kv["k"], n)[:, None].to(
        cache["k"].dtype)
    cache["v"][:, :, :m] = C.local_heads(kv["v"], n)[:, None].to(
        cache["v"].dtype)
    return cache, m


def local_cushion(cushion: Optional[Params], cfg: ModelConfig
                  ) -> Optional[Params]:
    """The cushion's KV on this rank's heads (itself on one rank)."""
    if cushion is None:
        return None
    n = cfg.n_kv_heads
    return {"kv": {k: C.local_heads(t, n) for k, t in cushion["kv"].items()}}


def cushion_summed(cushion: Params, cfg: ModelConfig) -> Params:
    """Which leaves of the cushion a tensor-parallel rank reads in part
    (``local_cushion``), a tree of bools: every KV leaf where the query
    heads are cut (a rank reads its KV heads, or its group's window of
    whole ones: its gradient is the rank's share, summed over tp), none
    where every rank computes the heads whole (a sum would double it)."""
    cut = C.tp_cut(cfg, "heads")
    return {"kv": {k: cut for k in cushion["kv"]}}


def write_prompt_kv(cache: Params, ks: Tensor, vs: Tensor, m: int) -> Params:
    """Write prefill KV (stacked (L,B,S,K,hd) fp) at positions [m:m+S]. An
    int8 cache also derives its per-(layer, head) scales from the prompt KV
    here, decode reuses them; a cache with per-slot (L,B,K) scale leaves
    calibrates each batch row from its own prompt. In place, scales
    included: a captured decode step reads the tensors it was captured
    on."""
    S = ks.shape[2]
    if "k_scale" in cache:
        if cache["k_scale"].dim() == 3:             # per-slot (L, B, K)
            k_scale = torch.stack([torch.stack([C.kv_scales_from(r)
                                                for r in k]) for k in ks])
            v_scale = torch.stack([torch.stack([C.kv_scales_from(r)
                                                for r in v]) for v in vs])
        else:
            k_scale = torch.stack([C.kv_scales_from(k) for k in ks])  # (L,K)
            v_scale = torch.stack([C.kv_scales_from(v) for v in vs])
        for l in range(ks.shape[0]):
            cache["k"][l, :, m:m + S] = C.quantize_kv(ks[l], k_scale[l])
            cache["v"][l, :, m:m + S] = C.quantize_kv(vs[l], v_scale[l])
        cache["k_scale"].copy_(k_scale)
        cache["v_scale"].copy_(v_scale)
        return cache
    cache["k"][:, :, m:m + S] = ks.to(cache["k"].dtype)
    cache["v"][:, :, m:m + S] = vs.to(cache["v"].dtype)
    return cache


def finalize_staged_kv(row: Params, cache: Params, cushion: Optional[Params],
                       S: int) -> Params:
    """The admission row a blocking prefill would have produced, rebuilt
    from a chunk-staged fp row: the prompt KV [m:m+S) of the row goes
    through ``write_prompt_kv``, so an int8 cache calibrates its per-slot
    scales over the whole prompt, and the cushion lands in kc/vc."""
    cache, m = write_cushion_to_cache(cache, cushion)
    return write_prompt_kv(cache, row["k"][:, :, m:m + S],
                           row["v"][:, :, m:m + S], m)


def prefill(params, tokens: Tensor, cache: Params, cfg: ModelConfig,
            qcfg: QuantConfig, *, scales: Optional[Params] = None,
            cushion: Optional[Params] = None,
            prepend_embeds: Optional[Tensor] = None,
            pos_offset: Optional[int] = None, remat: bool = False
            ) -> Tuple[Tensor, Params, Tensor]:
    """Process the prompt and fill the cache (cushion at [0:m], prompt at
    [m:m+S]). Returns (last-position logits (B,1,V), cache, next_pos).
    prepend_embeds (B, P, D) sit before the tokens (the VLM's patches) and
    count among the S prompt positions.

    pos_offset (int) resumes a chunked prefill: positions [0:pos_offset) of
    the B=1 fp cache row already hold the cushion and every earlier chunk,
    and are read back as the fully visible prefix of this chunk's tokens.
    The cushion is attached on chunk 0 only, and the row must be fp (int8
    admission rows are rebuilt by ``finalize_staged_kv``)."""
    params = C.as_tree(params)
    L = cfg.n_layers
    x = embed_with_prepend(params, tokens, cfg, prepend_embeds)
    S = x.shape[1]
    if pos_offset is not None:
        if prepend_embeds is not None:
            raise ValueError("chunk-resume prefill takes tokens only (a "
                             "request with prepended embeddings admits "
                             "blocking)")
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
        pre = _cushion_layers(local_cushion(cushion, cfg), L)
    positions = m + torch.arange(S, device=x.device)
    lscales = C.resolve_scales(scales, SITES, L, qcfg, x.device)
    ks, vs = [], []
    for lp, lsc, lpre in zip(C.unstack(params["layers"], L),
                             C.unstack(lscales, L), pre):
        x, k, v = C.remat_call(remat, _prefill_block, lp, x, cfg, qcfg, lsc,
                               lpre, positions)
        ks.append(k)
        vs.append(v)
    cache = write_prompt_kv(cache, torch.stack(ks), torch.stack(vs), m)
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
    return x + C.apply_mlp(lp["mlp"], hn, cfg, qcfg, lsc, None), k, v


def decode_step(params, token: Tensor, pos: Tensor, cache: Params,
                cfg: ModelConfig, qcfg: QuantConfig, *,
                scales: Optional[Params] = None) -> Tuple[Tensor, Params]:
    """One decode step. token: (B,) int; pos: () or (B,) int32 absolute
    position (the cushion occupies [0:m)). Returns ((B, V) logits, cache)."""
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
        x = x + C.apply_mlp(lp["mlp"], hn, cfg, qcfg, lsc, None)
    x = C.apply_norm(params["ln_f"], x, cfg)
    logits = C.lm_head(params, x, cfg, qcfg, scales, None)
    return logits[:, 0], cache


def cushion_zeros(cfg: ModelConfig, m: int, device, dtype=None) -> Params:
    """Zero cushion artifact in the model dtype (what extract_cushion
    emits)."""
    dtype = C.dtype_of(cfg) if dtype is None else dtype
    K, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    return {"kv": {"k": torch.zeros((L, m, K, hd), dtype=dtype, device=device),
                   "v": torch.zeros((L, m, K, hd), dtype=dtype,
                                    device=device)}}


def loss_fn(params, tokens: Tensor, labels: Tensor, cfg: ModelConfig,
            qcfg: QuantConfig, *, scales=None, cushion=None,
            collect: bool = False, n_skip: int = 0, remat: bool = True,
            lam: float = 0.0):
    """Next-token CE (+ λ·L_q when ``lam`` > 0). Returns (loss, aux) with
    aux {"ce", "taps"} and, when collecting, "qerr"."""
    logits, taps = forward(params, tokens, cfg, qcfg, scales=scales,
                           cushion=cushion, collect=collect or lam > 0,
                           n_skip=n_skip, remat=remat)
    if n_skip:
        # loss on the token part only (prefix positions excluded)
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


def total_qerr(taps: Dict, groups: int = 1) -> Tensor:
    """Sum of L_q over all sites and layers (paper eq. 6, summed over
    blocks): a scalar, or (groups,) for a forward of stacked groups."""
    total: Optional[Tensor] = None

    def visit(d):
        nonlocal total
        if isinstance(d, dict):
            if "qerr" in d:
                q = d["qerr"]
                v = q.sum() if groups == 1 else q.reshape(-1, groups).sum(0)
                total = v if total is None else total + v
            else:
                for v in d.values():
                    visit(v)
    visit(taps)
    if total is None:
        return torch.zeros(() if groups == 1 else (groups,),
                           dtype=torch.float32)
    return total


def placeholder_all_scales(cfg: ModelConfig, device) -> Params:
    """Full placeholder scales tree (head included) for lowering the
    quantized path without calibration."""
    sc = C.placeholder_scales(SITES, cfg.n_layers, device)
    sc["head"] = Q.SiteScale(
        scale=torch.ones((), dtype=torch.float32, device=device),
        zero=torch.zeros((), dtype=torch.float32, device=device))
    return sc
