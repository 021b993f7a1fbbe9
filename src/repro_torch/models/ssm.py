"""Mamba selective-SSM mixer (inside the Jamba hybrid), ported from
``repro/models/ssm.py``:

    dims(cfg)                                     -> (inner, N, d_conv, dt_rank)
    mamba_init(gen, cfg)                          -> params
    apply_mamba(p, x, cfg, qcfg, scales, taps...) -> out [, state]
    init_state(cfg, B, device)                    -> {"h", "conv"}
    decode_mamba(p, x, state, cfg, qcfg, scales)  -> (out, state)

Sites: ``mamba_in`` (the in-projection's input) and ``mamba_out`` (the
out-projection's input); with ``groups`` > 1 each stacked forward keeps
its own dynamic ranges and L_q there (``models/common.py``).

Port notes:

* The scan. The reference runs ``jax.lax.associative_scan`` over
  ``(B, S, inner, N)`` f32 tensors ``deltaA`` / ``deltaBx``. The port runs
  the recurrence ``h_t = a_t h_{t-1} + b_t`` position by position, the
  arithmetic of ``decode_mamba``, forming ``a_t`` and ``b_t`` for a chunk
  of ``SCAN_CHUNK`` positions at a time, so the four-axis tensors exist
  for one chunk only. The two associate the products differently and
  agree to f32 rounding (``tests/test_torch_ssm.py`` states the bar). The
  loop reads nothing back to the host, and autograd runs through it.
* The conv, the scan and the ``dt`` products are jnp in the reference,
  outside any Pallas kernel, and plain PyTorch here; the two linears run
  through ``qlinear`` (``w8a8_matmul`` on the card under true int8). The
  ``w_x`` and ``dt_w`` products go through ``common.matmul_rows``: at
  decode a slot's row is then the same in a pool as alone on the card.
* A tensor-parallel rank with the channels cut (``common.tp_cut``,
  "inner": the reference's cache roles cut ``h`` and ``conv`` on them)
  runs the mixer on its inner/tp channels (``dims``), so the conv, the
  recurrence and the state stay local: ``w_in`` holds its channels of x
  and of z, ``conv_*``, ``dt_*``, ``A_log`` and ``Dskip`` its channels,
  ``w_out`` its rows (row-parallel: summed over the ranks). ``w_x`` is
  whole on every rank: the ranks' conv outputs are gathered and every
  rank forms the whole (B, S, R + 2N) projection, so dt, B and C are one
  rank's bit for bit. B and C enter every channel's state: summed partial
  products, rounded otherwise, moved jamba-v0.1-52b's W8A8 prefill logits
  at two ranks by up to 1.4 on an H100, where the gathered channels leave
  them one rank's exactly.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.distributed import collectives as DC
from repro_torch.models import common as C

Tensor = torch.Tensor
Params = Dict[str, Any]

SITES = ("mamba_in", "mamba_out")

def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(inner, d_state, d_conv, dt_rank); inner is a tensor-parallel
    rank's channels where they are cut."""
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    if C.tp_cut(cfg, "inner"):
        inner //= cfg.tp.size
    dt_rank = max(1, int(np.ceil(cfg.d_model / 16)))
    return inner, s.d_state, s.d_conv, dt_rank


def mamba_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Seeded random weights: S4D-real ``A_log``, ``dt_b`` the inverse
    softplus of a log-uniform dt in [0.001, 0.1], as the reference."""
    inner, d_state, d_conv, dt_rank = dims(cfg)
    D = cfg.d_model
    dt = C.dtype_of(cfg)
    dev = gen.device

    def f32(*shape, rand=torch.randn):
        return C.draw(gen, shape, rand)

    A = torch.arange(1, d_state + 1, dtype=torch.float32,
                     device=dev)[None].repeat(inner, 1)
    dt0 = torch.exp(f32(inner, rand=torch.rand)
                    * (np.log(0.1) - np.log(0.001)) + np.log(0.001))
    return {
        "w_in": C.dense_init(gen, D, 2 * inner, dt),
        "conv_w": (f32(d_conv, inner) / np.sqrt(d_conv)).to(dt),
        "conv_b": torch.zeros((inner,), dtype=dt, device=dev),
        "w_x": C.dense_init(gen, inner, dt_rank + 2 * d_state, dt),
        "dt_w": C.dense_init(gen, dt_rank, inner, dt),
        "dt_b": torch.log(torch.exp(dt0) - 1.0),
        "A_log": torch.log(A),
        "Dskip": torch.ones((inner,), dtype=torch.float32, device=dev),
        "w_out": C.dense_init(gen, inner, D, dt,
                              scale=1.0 / np.sqrt(2 * cfg.n_layers)),
    }


def _conv_full(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Causal depthwise conv. x: (B, S, C); w: (d_conv, C); b: (C,)."""
    d_conv = w.shape[0]
    xt = F.pad(x.transpose(1, 2), (d_conv - 1, 0))
    y = F.conv1d(xt, w.to(x.dtype).T[:, None, :], groups=x.shape[-1])
    return y.transpose(1, 2) + b


def _ssm_inputs(p: Params, xc: Tensor, cfg: ModelConfig
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """xc: (B, S, inner) after the conv. Returns dt (B, S, inner), Bm and
    Cm (B, S, N), all f32: the step's a_t = exp(dt_t A) and
    b_t = dt_t x_t Bm_t are formed by the caller."""
    _, d_state, _, dt_rank = dims(cfg)
    xin = xc
    if C.tp_cut(cfg, "inner"):
        # every rank forms the whole projection from the ranks' channels
        # (w_x whole on every rank): one rank's product bit for bit
        xin = DC.gather_last(xc)
    proj = C.matmul_rows(xin, p["w_x"].to(xc.dtype))
    dt_raw, Bm, Cm = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(C.matmul_rows(dt_raw.float(), p["dt_w"].float())
                    + p["dt_b"])
    return dt, Bm.float(), Cm.float()


def _step_terms(dt: Tensor, xc: Tensor, Bm: Tensor, A: Tensor
                ) -> Tuple[Tensor, Tensor]:
    """a = exp(dt A), b = (dt x) Bm for (..., inner) dt / xc and (..., N)
    Bm: (..., inner, N) f32 each."""
    a = torch.exp(dt[..., None] * A)
    b = (dt * xc.float())[..., None] * Bm[..., None, :]
    return a, b


def _combine(a1: Tensor, b1: Tensor, a2: Tensor, b2: Tensor
             ) -> Tuple[Tensor, Tensor]:
    """The scan's operator, the reference's ``combine``: (a1, b1) then
    (a2, b2) is (a2 a1, a2 b1 + b2), the sum one fused multiply-add as XLA
    forms it (``addcmul``)."""
    return a2 * a1, torch.addcmul(b2, a2, b1)


def _interleave(even: Tensor, odd: Tensor) -> Tensor:
    """even[0], odd[0], even[1], ... along dim 1 (even has as many
    positions as odd, or one more)."""
    B, n = even.shape[0], even.shape[1] + odd.shape[1]
    out = even.new_empty((B, n) + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """The inclusive scan of (a, b) along dim 1 under ``_combine``, with
    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs, scan
    the pairs, combine each pair's prefix with the next even element, and
    interleave; so every product is associated as the reference's."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = associative_scan(*_combine(a[:, 0:-1:2], b[:, 0:-1:2],
                                        a[:, 1::2], b[:, 1::2]))
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    return (_interleave(torch.cat([a[:, :1], ea], 1), oa),
            _interleave(torch.cat([b[:, :1], eb], 1), ob))


def _scan(dt: Tensor, xc: Tensor, Bm: Tensor, Cm: Tensor, A: Tensor,
          h: Tensor) -> Tuple[Tensor, Tensor]:
    """The recurrence h_t = a_t h_{t-1} + b_t from h (B, inner, N) f32 over
    the S positions of dt / xc (B, S, inner) and Bm / Cm (B, S, N), as the
    reference's prefill: h folded into the first b, then
    ``associative_scan`` over the (B, S, inner, N) terms. Returns (y (B, S,
    inner) = sum_n h_t C_t, the last h)."""
    a, b = _step_terms(dt, xc, Bm, A)
    b = torch.cat([torch.addcmul(b[:, :1], a[:, :1], h[:, None]), b[:, 1:]], 1)
    _, hs = associative_scan(a, b)
    return torch.einsum("bsin,bsn->bsi", hs, Cm), hs[:, -1]


def apply_mamba(p: Params, x: Tensor, cfg: ModelConfig, qcfg: QuantConfig,
                scales: Optional[Params], taps: Optional[Dict],
                n_skip: int = 0, init_state: Optional[Params] = None,
                return_state: bool = False, groups: int = 1):
    """Full-sequence Mamba mixer. x: (B, S, D). init_state: {"h": (B,
    inner, N) or (inner, N), "conv": (B, d_conv-1, inner) or (d_conv-1,
    inner)}, the cushion's state (batch-free broadcasts over B). With
    ``return_state`` also returns the state after the sequence: its ``h``
    and the last d_conv-1 inputs of the conv, zero-padded (the reference
    pads with zeros, not with the initial state's conv rows)."""
    B, S, _ = x.shape
    inner, d_state, d_conv, _ = dims(cfg)
    xz = C.qlinear(x, p["w_in"], None, qcfg, scales, "mamba_in", taps,
                   n_skip, groups)
    xin, z = xz.chunk(2, dim=-1)
    if init_state is not None and "conv" in init_state:
        cv = init_state["conv"]
        if cv.dim() == 2:
            cv = cv[None].expand(B, *cv.shape)
        xpad = torch.cat([cv.to(xin.dtype), xin], dim=1)
        xc = _conv_full(xpad, p["conv_w"], p["conv_b"])[:, d_conv - 1:]
    else:
        xc = _conv_full(xin, p["conv_w"], p["conv_b"])
    xc = F.silu(xc)

    dt, Bm, Cm = _ssm_inputs(p, xc, cfg)
    A = -torch.exp(p["A_log"])
    if init_state is not None and "h" in init_state:
        h0 = init_state["h"].float()
        if h0.dim() == 2:
            h0 = h0[None].expand(B, *h0.shape)
    else:
        h0 = torch.zeros((B, inner, d_state), dtype=torch.float32,
                         device=x.device)
    y, h = _scan(dt, xc, Bm, Cm, A, h0)
    y = y + p["Dskip"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = C.qlinear(y, p["w_out"], None, qcfg, scales, "mamba_out", taps,
                    n_skip, groups, row_parallel=C.tp_cut(cfg, "inner"))
    if return_state:
        pad = torch.zeros((B, d_conv - 1, inner), dtype=xin.dtype,
                          device=x.device)
        conv = torch.cat([pad, xin], dim=1)[:, -(d_conv - 1):]
        return out, {"h": h, "conv": conv}
    return out


def init_state(cfg: ModelConfig, batch: int, device) -> Params:
    inner, d_state, d_conv, _ = dims(cfg)
    return {"h": torch.zeros((batch, inner, d_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, d_conv - 1, inner),
                                dtype=C.dtype_of(cfg), device=device)}


def decode_mamba(p: Params, x: Tensor, state: Params, cfg: ModelConfig,
                 qcfg: QuantConfig, scales: Optional[Params],
                 taps: Optional[Dict] = None) -> Tuple[Tensor, Params]:
    """One token. x: (B, 1, D); state: {"h": (B, inner, N) f32, "conv":
    (B, d_conv-1, inner)}. Returns (out, the new state)."""
    xz = C.qlinear(x, p["w_in"], None, qcfg, scales, "mamba_in", taps)
    xin, z = xz.chunk(2, dim=-1)                          # (B, 1, inner)
    win = torch.cat([state["conv"].to(xin.dtype), xin], dim=1)
    xc = torch.einsum("bci,ci->bi", win, p["conv_w"].to(xin.dtype)) \
        + p["conv_b"]
    xc = F.silu(xc)[:, None]                              # (B, 1, inner)
    dt, Bm, Cm = _ssm_inputs(p, xc, cfg)
    a, b = _step_terms(dt[:, 0], xc[:, 0], Bm[:, 0], -torch.exp(p["A_log"]))
    h = torch.addcmul(b, a, state["h"])
    y = torch.einsum("bin,bn->bi", h, Cm[:, 0]) \
        + p["Dskip"] * xc[:, 0].float()
    y = y[:, None].to(x.dtype) * F.silu(z)
    out = C.qlinear(y, p["w_out"], None, qcfg, scales, "mamba_out", taps,
                    row_parallel=C.tp_cut(cfg, "inner"))
    return out, {"h": h, "conv": win[:, 1:]}
