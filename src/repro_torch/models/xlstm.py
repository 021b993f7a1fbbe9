"""xLSTM language model, ported from ``repro/models/xlstm.py``: pairs of an
mLSTM block (matrix memory: a parallel, stabilized form over the sequence,
chunkwise past ``MLSTM_CHUNK`` positions, and an O(1) recurrent decode) and
an sLSTM block (scalar memory, sequential), every recurrence stabilized in
log space by a running max state ``m``.

    init_params(cfg, gen)                      -> ParamTree
    forward(params, tokens, cfg, qcfg, ...)    -> (logits, taps[, state])
    loss_fn(params, tokens, labels, ...)       -> (loss, aux)
    init_cache(cfg, B, Smax, device, ...)      -> state
    prefill(params, tokens, cache, ...)        -> (logits, state, pos)
    decode_step(params, token, pos, cache, ..) -> (logits, state)

Parameters ``layers`` are stacked over the pairs (P, ...), the reference's
``vmap``-ed layout; the pair stack is a Python loop. The recurrences are
PyTorch ops, as in the reference they are jnp outside any Pallas kernel:
the mLSTM mixing einsums over a chunk, the sLSTM scan a loop over
positions (as the Mamba scan, ``models/ssm.py``).

The cushion is a trainable initial state, the "CushionState" (no attention
KV: the family has no softmax attention): ``{"state": {"m": {C, n, m},
"s": {c, n, h, m}}}``, batch-free leaves (P, ...) broadcast over the batch.
Prefix tuning trains the whole tree; the search scores with
``greedy_search_ref`` (a padded prefix cannot be masked out of a
recurrence).

The cache is the state tree with the batch on axis 1 of every leaf (P, B,
...), always f32. Prefill and decode write every leaf in place: a captured
decode step reads the tensors it was captured on. On the card a decode
row's result does not depend on the batch it runs in: the small plain
products pad their rows (``common.matmul_rows``) or run a row at a time
(``_per_row``), so a pool's rows equal the static B = 1 Engine's.

Tensor parallelism (a rank's config, ``serving/engine.tp_config``): the
reference's serve rules replicate every block weight (its ``xlstm/``
rules match no path of the family), so every rank computes q, k, the
gates and the output gate of all heads, and the sLSTM whole. Only the
vocabulary (the embedding and the head) and the mLSTM memory ``C`` are
cut: a rank holds ``C``'s value slice ("values", ``cache_roles``), forms
its slice of h from q and that slice (the values' columns are contracted
nowhere), and the slices are gathered whole before ``w_proj``, once an
mLSTM block a forward. Under autograd (tensor-parallel training) q, k, v
and the gates enter the mixing through ``collectives.copy_to_tp``, so
every block weight gets its whole gradient on every rank; a cushion's
mLSTM state, read towards the rank's slice of h, gets the rank's share
(``cushion_summed``).
"""
from __future__ import annotations

import math
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core import quantization as Q
from repro_torch.distributed import collectives as DC
from repro_torch.launch import cost
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import tree_leaves

Tensor = torch.Tensor
Params = Dict[str, Any]

SITES = ("m_in", "m_out", "s_in", "s_out")

# The prefix artifact is recurrent state: the search scores with
# greedy_search_ref.
SUPPORTS_PREFIX_KV_SCORING = False

# Slot layout: a state tree, every leaf (P, B, ...), the batch on axis 1.
# The recurrence reads no position, and a dead pool row's state takes
# dummy updates until an admission rewrites the whole row.
CACHE_BATCH_AXES = {"m": {"C": 1, "n": 1, "m": 1},
                    "s": {"c": 1, "n": 1, "h": 1, "m": 1}}

# chunk length of the chunkwise-parallel mLSTM (0: the quadratic form over
# the whole sequence); the reference's ``REPRO_MLSTM_CHUNK`` switch
MLSTM_CHUNK = int(os.environ.get("REPRO_MLSTM_CHUNK", "256"))

# a fresh state's max (the reference's), and the cushion's initial one
M_FRESH = -1e30
M_CUSHION = -30.0

total_qerr = T.total_qerr


def dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(inner width, heads, head dim)."""
    inner = cfg.ssm.expand * cfg.d_model if cfg.ssm else 2 * cfg.d_model
    NH = cfg.n_heads
    if inner % NH:
        raise ValueError(f"inner width {inner} is not a multiple of the "
                         f"{NH} heads")
    return inner, NH, inner // NH


def value_width(cfg: ModelConfig) -> int:
    """The mLSTM memory's value columns a rank holds: the head width, or
    its slice of it where a tensor-parallel rank's config cuts "values"."""
    hd = dims(cfg)[2]
    return hd // cfg.tp.size if C.tp_cut(cfg, "values") else hd


def _local_values(v: Tensor, cfg: ModelConfig) -> Tensor:
    """v (..., hd): this rank's value columns (v itself on one rank)."""
    n = value_width(cfg)
    return v if n == v.shape[-1] else C.rank_window(v, n)


def _gather_values(h: Tensor, cfg: ModelConfig) -> Tensor:
    """h (..., hd / tp): the ranks' value slices, gathered whole (exact:
    ``DC.gather_last`` adds zeros)."""
    return DC.gather_last(h) if C.tp_cut(cfg, "values") else h


def n_pairs(cfg: ModelConfig) -> int:
    if cfg.n_layers % 2:
        raise ValueError(f"the xLSTM stack takes an even layer count, got "
                         f"{cfg.n_layers}")
    return cfg.n_layers // 2


def _per_row(fn: Callable[..., Tensor], *xs: Tensor) -> Tensor:
    """``fn(*xs)``, on the card one batch row at a time: a decode row's sums
    then run in the kernels of a batch of one, whatever the pool's size
    (cuBLAS and the reductions pick their kernels by size). One call on the
    CPU."""
    B = xs[0].shape[0]
    if xs[0].device.type != "cuda" or B == 1:
        return fn(*xs)
    return torch.cat([fn(*(x[b:b + 1] for x in xs)) for b in range(B)])


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    inner, NH, _ = dims(cfg)
    D = cfg.d_model
    dt = C.dtype_of(cfg)
    w_if = C.draw(gen, (D, 2 * NH)) / math.sqrt(D)
    b_if = torch.cat([torch.zeros((NH,)), torch.linspace(3.0, 6.0, NH)])
    return {"w_qkv": C.dense_init(gen, D, 3 * inner, dt),
            "w_if": w_if,
            "b_if": b_if.to(torch.float32).to(gen.device),
            "w_o": C.dense_init(gen, D, inner, dt),
            "w_proj": C.dense_init(gen, inner, D, dt,
                                   scale=1.0 / math.sqrt(2 * cfg.n_layers))}


def _mlstm_qkvif(p: Params, x: Tensor, cfg: ModelConfig, qcfg: QuantConfig,
                 scales, taps, n_skip: int, groups: int = 1):
    """q, v (B, S, NH, hd), k (B, S, NH, hd) f32 scaled by 1/sqrt(hd); the
    log input and forget gates li, lf (B, S, NH) f32; the output gate og
    (B, S, inner)."""
    inner, NH, hd = dims(cfg)
    B, S, _ = x.shape
    qkv = C.qlinear(x, p["w_qkv"], None, qcfg, scales, "m_in", taps, n_skip,
                    groups)
    q, k, v = (t.reshape(B, S, NH, hd) for t in torch.split(qkv, inner, -1))
    # the reference divides by a numpy f64 scalar, which promotes k to f32
    k = k.float() / math.sqrt(hd)
    gif = C.matmul_rows(x.float(), p["w_if"]) + p["b_if"]
    li, lf_raw = torch.split(gif, NH, dim=-1)
    og = torch.sigmoid(C.matmul_rows(x, p["w_o"]))
    return q, k, v, li, F.logsigmoid(lf_raw), og


def _f32_state(st: Optional[Params]) -> Optional[Params]:
    return None if st is None else {k: v.float() for k, v in st.items()}


def _mlstm_mix(q: Tensor, k: Tensor, v: Tensor, li: Tensor, lf: Tensor,
               init_state: Optional[Params], return_state: bool):
    """The stabilized parallel (quadratic in S) mLSTM mixing. q, k, v (B,
    S, NH, hd); li, lf (B, S, NH). Returns h (B, NH, S, hd) f32, and with
    ``return_state`` the final state {C, n, m}. A masked decay is -inf, as
    in the reference; every max is clamped at -1e30 before it is
    subtracted, so no gradient meets -inf - -inf."""
    S = q.shape[1]
    init_state = _f32_state(init_state)
    b = torch.cumsum(lf, dim=1)
    bT = b.transpose(1, 2)                                   # (B, NH, S)
    liT = li.transpose(1, 2)
    # logD[t, s] = b_t - b_s + li_s for s <= t
    logD = bT[..., :, None] - bT[..., None, :] + liT[..., None, :]
    tri = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    neg_inf = torch.full((), -math.inf, device=q.device)
    logD = torch.where(tri, logD, neg_inf)
    if init_state is not None:
        inter_log = bT + init_state["m"][..., None]
    else:
        inter_log = torch.full_like(bT, -math.inf)
    m_row = torch.maximum(logD.amax(dim=-1), inter_log).clamp(min=M_FRESH)
    Dm = torch.exp(logD - m_row[..., None])

    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    scores = (qh @ kh.transpose(-1, -2)) * Dm
    num = scores @ vh
    den = scores.sum(-1)
    if init_state is not None:
        iw = torch.exp(inter_log - m_row)
        num = num + iw[..., None] * (qh @ init_state["C"])
        den = den + iw * (qh @ init_state["n"][..., :, None])[..., 0]
    norm = torch.maximum(den.abs(), torch.exp(-m_row))
    h = num / norm[..., None]
    if not return_state:
        return h

    bS = bT[..., -1]                                         # (B, NH)
    w_log = bS[..., None] - bT + liT
    m_state = w_log.amax(dim=-1)
    if init_state is not None:
        m_state = torch.maximum(m_state, bS + init_state["m"])
    w = torch.exp(w_log - m_state[..., None])
    Cn = (kh * w[..., None]).transpose(-1, -2) @ vh
    nn = (w[..., None, :] @ kh)[..., 0, :]
    if init_state is not None:
        iw0 = torch.exp(bS + init_state["m"] - m_state)
        Cn = Cn + iw0[..., None, None] * init_state["C"]
        nn = nn + iw0[..., None] * init_state["n"]
    return h, {"C": Cn, "n": nn, "m": m_state}


def mlstm_state(cfg: ModelConfig, batch: int, device) -> Params:
    _, NH, hd = dims(cfg)
    return {"C": torch.zeros((batch, NH, hd, value_width(cfg)),
                             device=device),
            "n": torch.zeros((batch, NH, hd), device=device),
            "m": torch.full((batch, NH), M_FRESH, device=device)}


def apply_mlstm(p: Params, x: Tensor, cfg: ModelConfig, qcfg: QuantConfig,
                scales: Optional[Params], taps: Optional[Dict],
                n_skip: int = 0, init_state: Optional[Params] = None,
                return_state: bool = False, chunk: Optional[int] = None,
                groups: int = 1):
    """The mLSTM block: the QKV / gate projections over the sequence, the
    mixing (quadratic, or chunkwise when ``S % chunk == 0`` and ``S >
    chunk``: quadratic inside a chunk, the state carried between chunks),
    the output gate and ``w_proj``."""
    B, S, _ = x.shape
    inner, NH, hd = dims(cfg)
    chunk = MLSTM_CHUNK if chunk is None else chunk
    q, k, v, li, lf, og = _mlstm_qkvif(p, x, cfg, qcfg, scales, taps,
                                       n_skip, groups)
    if C.tp_cut(cfg, "values"):
        # every rank forms q, k, v and the gates whole and mixes them into
        # its value slice of h: their gradients are the rank's shares,
        # summed here (v's is zero outside the rank's window), so the
        # block's weights and input get whole ones. Not x itself: it also
        # feeds the output gate, read whole after the gather
        q, k, v, li, lf = (DC.copy_to_tp(t) for t in (q, k, v, li, lf))
    v = _local_values(v, cfg)
    if chunk <= 0 or S <= chunk or S % chunk:
        res = _mlstm_mix(q, k, v, li, lf, init_state, return_state)
        h, state = res if return_state else (res, None)
    else:
        state = _f32_state(init_state) if init_state is not None \
            else mlstm_state(cfg, B, x.device)
        hs = []
        for c0 in range(0, S, chunk):
            sl = slice(c0, c0 + chunk)
            hc, state = _mlstm_mix(q[:, sl], k[:, sl], v[:, sl], li[:, sl],
                                   lf[:, sl], state, True)
            hs.append(hc)
        h = torch.cat(hs, dim=2)
    h = _gather_values(h, cfg)
    h = h.transpose(1, 2).reshape(B, S, inner).to(x.dtype) * og.to(x.dtype)
    out = C.qlinear(h, p["w_proj"], None, qcfg, scales, "m_out", taps,
                    n_skip, groups)
    return (out, state) if return_state else out


def decode_mlstm(p: Params, x: Tensor, state: Params, cfg: ModelConfig,
                 qcfg: QuantConfig, scales: Optional[Params],
                 taps: Optional[Dict] = None) -> Tuple[Tensor, Params]:
    """x: (B, 1, D); one stabilized recurrent step."""
    B = x.shape[0]
    inner, _, _ = dims(cfg)
    q, k, v, li, lf, og = _mlstm_qkvif(p, x, cfg, qcfg, scales, taps, 0)
    q, k, v = (t[:, 0].float() for t in (q, k, v))           # (B, NH, hd)
    v = _local_values(v, cfg)
    li, lf = li[:, 0], lf[:, 0]                              # (B, NH)
    m_new = torch.maximum(lf + state["m"], li)
    fp = torch.exp(lf + state["m"] - m_new)
    ip = torch.exp(li - m_new)
    Cn = fp[..., None, None] * state["C"] \
        + ip[..., None, None] * (k[..., :, None] * v[..., None, :])
    nn = fp[..., None] * state["n"] + ip[..., None] * k
    den = _per_row(lambda a, b_: (a[..., None, :] @ b_[..., :, None])
                   [..., 0, 0], q, nn)
    norm = torch.maximum(den.abs(), torch.exp(-m_new))
    h = _per_row(lambda a, c: (a[..., None, :] @ c)[..., 0, :], q, Cn)
    h = _gather_values(h / norm[..., None], cfg)
    h = h.reshape(B, 1, inner).to(x.dtype) * og
    out = C.qlinear(h, p["w_proj"], None, qcfg, scales, "m_out", taps)
    return out, {"C": Cn, "n": nn, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    inner, NH, hd = dims(cfg)
    D = cfg.d_model
    dt = C.dtype_of(cfg)
    w = C.dense_init(gen, D, 4 * inner, dt)
    r = C.draw(gen, (NH, hd, 4 * hd)) / math.sqrt(hd)
    return {"w": w, "r": r,
            "b": torch.zeros((4 * inner,), dtype=torch.float32,
                             device=gen.device),
            "w_proj": C.dense_init(gen, inner, D, dt,
                                   scale=1.0 / math.sqrt(2 * cfg.n_layers))}


def slstm_state(cfg: ModelConfig, batch: int, device) -> Params:
    _, NH, hd = dims(cfg)

    def z():
        return torch.zeros((batch, NH, hd), device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, NH, hd), M_FRESH, device=device)}


def _slstm_step(r: Tensor, wx_t: Tensor, state: Params, NH: int, hd: int,
                rows: bool = False) -> Tuple[Tensor, Params]:
    """wx_t: (B, 4 inner) f32, W x_t + b. Returns (h (B, NH, hd), state).
    ``rows``: the recurrent product a row at a time on the card (decode)."""
    B = wx_t.shape[0]

    def rec(h):
        return torch.einsum("bhd,hde->bhe", h, r)
    zall = wx_t.reshape(B, 4, NH, hd).transpose(1, 2).reshape(B, NH, 4 * hd) \
        + (_per_row(rec, state["h"]) if rows else rec(state["h"]))
    zi, zf, zz, zo = torch.split(zall, hd, dim=-1)
    lf = F.logsigmoid(zf)
    m_new = torch.maximum(lf + state["m"], zi)
    fp = torch.exp(lf + state["m"] - m_new)
    ip = torch.exp(zi - m_new)
    c = fp * state["c"] + ip * torch.tanh(zz)
    n = fp * state["n"] + ip
    h = torch.sigmoid(zo) * c / torch.clamp(n, min=1e-6)
    return h, {"c": c, "n": n, "h": h, "m": m_new}


def apply_slstm(p: Params, x: Tensor, cfg: ModelConfig, qcfg: QuantConfig,
                scales: Optional[Params], taps: Optional[Dict],
                n_skip: int = 0, init_state: Optional[Params] = None,
                return_state: bool = False, groups: int = 1):
    """The sLSTM block: W x over the sequence, then the scan, a loop over
    positions (``launch/cost.scan``: the dry-run counts one step S
    times)."""
    B, S, _ = x.shape
    inner, NH, hd = dims(cfg)
    wx = C.qlinear(x, p["w"], None, qcfg, scales, "s_in", taps, n_skip,
                   groups).float() + p["b"]
    state = _f32_state(init_state) if init_state is not None \
        else slstm_state(cfg, B, x.device)
    hs, state = cost.scan(
        S, lambda t, st: _slstm_step(p["r"], wx[:, t], st, NH, hd), state)
    hs = torch.stack(hs, dim=1).reshape(B, S, inner).to(x.dtype)
    out = C.qlinear(hs, p["w_proj"], None, qcfg, scales, "s_out", taps,
                    n_skip, groups)
    return (out, state) if return_state else out


def decode_slstm(p: Params, x: Tensor, state: Params, cfg: ModelConfig,
                 qcfg: QuantConfig, scales: Optional[Params],
                 taps: Optional[Dict] = None) -> Tuple[Tensor, Params]:
    B = x.shape[0]
    inner, NH, hd = dims(cfg)
    wx = C.qlinear(x, p["w"], None, qcfg, scales, "s_in", taps).float() \
        + p["b"]
    h, state = _slstm_step(p["r"], wx[:, 0], state, NH, hd, rows=True)
    out = C.qlinear(h.reshape(B, 1, inner).to(x.dtype), p["w_proj"], None,
                    qcfg, scales, "s_out", taps)
    return out, state


# ---------------------------------------------------------------------------
# The pair stack
# ---------------------------------------------------------------------------

def pair_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"ln_m": C.norm_init(cfg, gen.device), "mlstm": mlstm_init(gen, cfg),
            "ln_s": C.norm_init(cfg, gen.device), "slstm": slstm_init(gen, cfg)}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> C.ParamTree:
    """Seeded random weights on the generator's device."""
    p = C.embed_init(gen, cfg)
    p["layers"] = C.stack_trees([pair_init(gen, cfg)
                                 for _ in range(n_pairs(cfg))])
    p["ln_f"] = C.norm_init(cfg, gen.device)
    return C.ParamTree(p)


def cache_roles(cfg: ModelConfig, kv_dtype=None,
                per_slot_scales: bool = False) -> Params:
    """Serving roles of the recurrent state, the reference's: batch on
    "B", the head dim on "M" (``kv_dtype`` is unused: the state is never
    int8).

    What a tensor-parallel rank holds (the roles stay the reference's;
    only where the values live differs, not a value): the mLSTM memory
    ``C`` (P, B, NH, hd, hd) cut on its last axis, the values, as the
    roles say; it is nearly all of the state's bytes (at xlstm-350m's
    width 12 pairs x 4 heads x 512 x 512 x 4 B = 50.3 MB a slot), and that
    axis is contracted nowhere (a rank forms its slice of h from q and
    its slice of ``C``; h is gathered once a block). ``n`` and the
    sLSTM's ``c``, ``n``, ``h`` and ``m`` stay whole on every rank,
    although the roles name tp on their last axis: that axis is
    contracted (``q . n`` in the mLSTM's denominator; ``h . r`` in the
    sLSTM's recurrence, which would take a collective at every position
    of a prefill), and they total under 0.5 MB a slot."""
    return {"m": {"C": (None, "B", None, None, "M"),
                  "n": (None, "B", None, "M"),
                  "m": (None, "B", None)},
            "s": {"c": (None, "B", None, "M"), "n": (None, "B", None, "M"),
                  "h": (None, "B", None, "M"), "m": (None, "B", None, "M")}}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
               dtype=None, kv_dtype=None, prefix_len: int = 0,
               per_slot_scales: bool = False) -> Params:
    """The state tree, stacked over the pairs, every leaf (P, B, ...) f32.
    The other arguments are the families' common signature, unused: the
    state is O(1) and never int8 (``registry`` refuses ``kv_dtype``)."""
    P = n_pairs(cfg)

    def stacked(st):
        return {k: v[None].repeat(P, *([1] * v.dim())) for k, v in st.items()}
    return {"m": stacked(mlstm_state(cfg, batch, device)),
            "s": stacked(slstm_state(cfg, batch, device))}


def cushion_zeros(cfg: ModelConfig, m: int, device, dtype=None) -> Params:
    """The CushionState: a batch-free initial state (broadcast at use), C /
    n / c / h zero and the max states at -30, in the model dtype by
    default. ``m`` (a prefix length) has no meaning here."""
    dtype = C.dtype_of(cfg) if dtype is None else dtype
    P = n_pairs(cfg)
    _, NH, hd = dims(cfg)

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)
    return {"state": {
        "m": {"C": full((P, NH, hd, hd), 0.0), "n": full((P, NH, hd), 0.0),
              "m": full((P, NH), M_CUSHION)},
        "s": {"c": full((P, NH, hd), 0.0), "n": full((P, NH, hd), 0.0),
              "h": full((P, NH, hd), 0.0), "m": full((P, NH, hd), M_CUSHION)}}}


def local_cushion(cushion: Optional[Params], cfg: ModelConfig
                  ) -> Optional[Params]:
    """The CushionState as a tensor-parallel rank reads it: the mLSTM
    memory ``C`` on its value slice (``cache_roles``), every other leaf
    whole (itself on one rank)."""
    if cushion is None or not C.tp_cut(cfg, "values"):
        return cushion
    st = cushion["state"]
    return {"state": {"m": {**st["m"], "C": _local_values(st["m"]["C"],
                                                          cfg)},
                      "s": st["s"]}}


def cushion_summed(cushion: Params, cfg: ModelConfig) -> Params:
    """Which leaves of the CushionState a tensor-parallel rank reads in
    part (``local_cushion``), a tree of bools: where the values are cut,
    the mLSTM memory ``C`` (its value slice) and ``n`` and ``m`` (read
    whole, towards the rank's slice of h only), whose gradients are the
    rank's shares, summed over tp; never the sLSTM state, which every rank
    reads and computes whole (a sum would double it)."""
    cut = C.tp_cut(cfg, "values")
    return {"state": {g: {k: cut and g == "m" for k in leaves}
                      for g, leaves in cushion["state"].items()}}


def _bcast_state(st: Params, B: int) -> Params:
    """A batch-free state tree (P, ...) broadcast to (P, B, ...) (a view)."""
    return {g: {k: v[:, None].expand(v.shape[0], B, *v.shape[1:])
                for k, v in leaves.items()} for g, leaves in st.items()}


def _pair_state(st: Optional[Params], i: int) -> Tuple[Optional[Params],
                                                       Optional[Params]]:
    if st is None:
        return None, None
    return ({k: v[i] for k, v in st["m"].items()},
            {k: v[i] for k, v in st["s"].items()})


def _pair_block(lp: Params, x: Tensor, cfg: ModelConfig, qcfg: QuantConfig,
                lsc: Params, st_m: Optional[Params], st_s: Optional[Params],
                collect: bool, n_skip: int, return_state: bool, groups: int):
    """One mLSTM / sLSTM pair: (x, taps or None, {"m", "s"} state after the
    sequence or None)."""
    taps: Optional[Dict] = {} if collect else None
    if collect:
        taps["block_in"] = Q.site_stats(x, n_skip)
    hn = C.apply_norm(lp["ln_m"], x, cfg)
    o = apply_mlstm(lp["mlstm"], hn, cfg, qcfg, lsc, taps, n_skip,
                    init_state=st_m, return_state=return_state,
                    groups=groups)
    if return_state:
        o, new_m = o
    x = x + o
    hn = C.apply_norm(lp["ln_s"], x, cfg)
    o = apply_slstm(lp["slstm"], hn, cfg, qcfg, lsc, taps, n_skip,
                    init_state=st_s, return_state=return_state,
                    groups=groups)
    state = None
    if return_state:
        o, new_s = o
        state = {"m": new_m, "s": new_s}
    return x + o, taps, state


def forward(params, tokens: Tensor, cfg: ModelConfig, qcfg: QuantConfig, *,
            scales: Optional[Params] = None, cushion: Optional[Params] = None,
            collect: bool = False, n_skip: int = 0,
            prepend_embeds: Optional[Tensor] = None,
            return_cache: bool = False, groups: int = 1, remat: bool = True):
    """Full-sequence forward from the cushion's state (or a fresh one).
    With ``collect`` the taps hold every site's statistics and
    ``block_in``, stacked over the pairs; ``return_cache`` (serving: the
    prefill, the cushion's extraction) adds the state after the sequence,
    {"m": {C, n, m}, "s": {c, n, h, m}} (P, B, ...), and keeps the last
    position's logits only (``common.lm_head``'s ``last``: a
    tensor-parallel rank gathers one position's vocabulary, not every
    position's).
    ``groups``: stacked forwards, as ``transformer.forward``. ``remat``:
    one checkpoint a pair (``common.remat_call``)."""
    params = C.as_tree(params)
    x = T.embed_with_prepend(params, tokens, cfg, prepend_embeds)
    B = x.shape[0]
    P = n_pairs(cfg)
    lscales = C.resolve_scales(scales, SITES, P, qcfg, x.device)
    init = None
    if cushion is not None:
        if "state" not in cushion:
            raise ValueError("an xLSTM cushion is an initial state tree "
                             "({'state': {'m': ..., 's': ...}})")
        init = _bcast_state(local_cushion(cushion, cfg)["state"], B)
    layer_taps, states = [], []
    for i, (lp, lsc) in enumerate(zip(C.unstack(params["layers"], P),
                                      C.unstack(lscales, P))):
        st_m, st_s = _pair_state(init, i)
        x, taps, state = C.remat_call(remat, _pair_block, lp, x, cfg, qcfg,
                                      lsc, st_m, st_s, collect, n_skip,
                                      return_cache, groups)
        if return_cache:
            states.append(state)
        layer_taps.append(taps)
    x = C.apply_norm(params["ln_f"], x, cfg)
    head_taps: Optional[Dict] = {} if collect else None
    logits = C.lm_head(params, x, cfg, qcfg, scales, head_taps, n_skip,
                       groups, last=return_cache)
    taps_out: Dict = {}
    if collect:
        taps_out = {"layers": C.stack_trees(layer_taps), **head_taps,
                    "final_in": Q.site_stats(x, n_skip)}
    if return_cache:
        return logits, taps_out, C.stack_trees(states)
    return logits, taps_out


def prefill(params, tokens: Tensor, cache: Params, cfg: ModelConfig,
            qcfg: QuantConfig, *, scales: Optional[Params] = None,
            cushion: Optional[Params] = None,
            prepend_embeds: Optional[Tensor] = None, remat: bool = False
            ) -> Tuple[Tensor, Params, Tensor]:
    """Run the prompt from the cushion's state and write the state after
    it into ``cache``, in place. Returns (last-position logits (B,1,V),
    cache, the prompt length): the head reads every position, as in the
    reference, whose dynamic ranges span them."""
    logits, _, states = forward(params, tokens, cfg, qcfg, scales=scales,
                                cushion=cushion,
                                prepend_embeds=prepend_embeds,
                                return_cache=True, remat=remat)
    for old, new in zip(tree_leaves(cache), tree_leaves(states)):
        old.copy_(new)
    S = tokens.shape[1] + (0 if prepend_embeds is None
                           else prepend_embeds.shape[1])
    return logits, cache, torch.tensor(S, dtype=torch.int32,
                                       device=logits.device)


def decode_step(params, token: Tensor, pos: Tensor, cache: Params,
                cfg: ModelConfig, qcfg: QuantConfig, *,
                scales: Optional[Params] = None) -> Tuple[Tensor, Params]:
    """One recurrent step of every pair; ``pos`` is unused (the state holds
    no positions). Every state leaf is written in place."""
    params = C.as_tree(params)
    P = n_pairs(cfg)
    x = C.embed_tokens(params, token[:, None], cfg)
    lscales = C.resolve_scales(scales, SITES, P, qcfg, x.device)
    for i, (lp, lsc) in enumerate(zip(C.unstack(params["layers"], P),
                                      C.unstack(lscales, P))):
        st_m, st_s = _pair_state(cache, i)
        hn = C.apply_norm(lp["ln_m"], x, cfg)
        o, new_m = decode_mlstm(lp["mlstm"], hn, st_m, cfg, qcfg, lsc)
        x = x + o
        hn = C.apply_norm(lp["ln_s"], x, cfg)
        o, new_s = decode_slstm(lp["slstm"], hn, st_s, cfg, qcfg, lsc)
        x = x + o
        for st, new in ((st_m, new_m), (st_s, new_s)):
            for k, v in new.items():
                st[k].copy_(v)
    x = C.apply_norm(params["ln_f"], x, cfg)
    logits = C.lm_head(params, x, cfg, qcfg, scales, None)
    return logits[:, 0], cache


def loss_fn(params, tokens: Tensor, labels: Tensor, cfg: ModelConfig,
            qcfg: QuantConfig, *, scales=None, cushion=None,
            collect: bool = False, n_skip: int = 0, remat: bool = True,
            lam: float = 0.0):
    """Next-token CE (+ λ·L_q when ``lam`` > 0), as
    ``transformer.loss_fn``."""
    logits, taps = forward(params, tokens, cfg, qcfg, scales=scales,
                           cushion=cushion, collect=collect or lam > 0,
                           n_skip=n_skip, remat=remat)
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


def placeholder_all_scales(cfg: ModelConfig, device) -> Params:
    sc = C.placeholder_scales(SITES, n_pairs(cfg), device)
    sc["head"] = Q.SiteScale(
        scale=torch.ones((), dtype=torch.float32, device=device),
        zero=torch.zeros((), dtype=torch.float32, device=device))
    return sc
