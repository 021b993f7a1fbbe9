"""Prefill attention with a fully visible CushionCache prefix (kernel +
plain version), and its backward.

q: (B, H, S, hd); k/v: (B, Kh, T, hd) with Kh | H (GQA); with ``causal``,
``prefix_len = m`` and ``prefix_live = lv`` (default m) key j is visible to
query i iff j < lv or m <= j <= i + m. ``prefix_live`` is the cushion
search's live length (the reference's ``prefix_valid = arange(m) < lv``):
rows [lv, m) of a padded prefix are seen by no query. Without ``causal``
(an encoder's self-attention, a cross-attention over encoder states) every
key j < T is visible to every query, T any length: the kernels take no
prefix there (``prefix_len`` must be 0).

A CUDA tensor launches ``csrc/flash_attention.cu`` (both modes; it takes
strided views, so callers hand it (B, S, H, hd) activations transposed in
place); a CPU tensor takes ``flash_attention_plain``, through which autograd
flows on the CPU. On the card, a call that autograd records (grad mode on
and an input that requires grad) goes through ``FlashAttentionFn``: its
forward launches the same kernel with the per-row log-sum-exp written out,
its backward launches ``csrc/flash_attention_bwd.cu``
(``flash_attention_bwd``). Every other call passes no log-sum-exp buffer
and is the serving path's kernel, bit for bit.

A meta tensor (the dry-run) takes the card's route, autograd included,
without launching: each launch returns empty meta outputs (the log-sum-exp
too) and records its FLOPs, bytes and launch in the dry-run's tally
(``launch/cost.kernel``): 4 B H S T hd forward and 8 B H S T hd
backward over the whole key range, what the reference's HLO counts for
its jnp oracle and that oracle's gradient (two and four dots of S x T x
hd).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _lib
from repro_torch.launch import cost

NEG_INF = -1e30
Tensor = torch.Tensor


def _live(prefix_len: int, prefix_live: Optional[int]) -> int:
    lv = prefix_len if prefix_live is None else int(prefix_live)
    if not 0 <= lv <= prefix_len:
        raise ValueError(f"prefix_live {lv} outside [0, {prefix_len}]")
    return lv


def _visible(S: int, T: int, causal: bool, prefix_len: int, lv: int,
             device) -> Tensor:
    """(S, T) bool: key j visible to query i."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    ok = (j < lv) | (j >= prefix_len)
    if causal:
        ok = ok & ((j < prefix_len) | (j <= i + prefix_len))
    return ok


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor,
                          causal: bool = True, prefix_len: int = 0,
                          prefix_live: Optional[int] = None,
                          return_lse: bool = False):
    """Plain PyTorch version (``ref.flash_attention_ref``, with the live
    mask of ``models/common.py`` ``attention_full``): dense f32 scores,
    -1e30 mask, softmax, output in q's dtype. With ``return_lse`` also the
    per-row log-sum-exp (B, H, S) f32 that the kernel writes for its
    backward."""
    B, H, S, hd = q.shape
    Kh, T = k.shape[1], k.shape[2]
    lv = _live(prefix_len, prefix_live)
    if Kh != H:
        k = k.repeat_interleave(H // Kh, dim=1)
        v = v.repeat_interleave(H // Kh, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) \
        / math.sqrt(hd)
    if causal or lv < prefix_len:
        mask = _visible(S, T, causal, prefix_len, lv, q.device)
        logits = torch.where(mask[None, None], logits,
                             torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", w, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def flash_attention_bwd_plain(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                              lse: Tensor, do: Tensor, prefix_len: int = 0,
                              prefix_live: Optional[int] = None,
                              causal: bool = True
                              ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of ``flash_attention_bwd``, in f32 from the forward's
    output ``o`` and per-row log-sum-exp ``lse`` (B, H, S), with the mask of
    the forward's plain version (``_visible``):

        p = exp(q.k / sqrt(hd) - lse) where visible, else 0
        D = rowsum(do * o)      dS = p (do.v - D)
        dq = dS k / sqrt(hd)    dk = dS^T q / sqrt(hd)    dv = p^T do

    dk and dv summed over each kv-head's G query heads. Returns (dq, dk,
    dv) in the dtypes of q, k and v."""
    B, H, S, hd = q.shape
    Kh, T = k.shape[1], k.shape[2]
    G = H // Kh
    lv = _live(prefix_len, prefix_live)
    scale = 1.0 / math.sqrt(hd)
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    qf, dof = q.float(), do.float()
    s = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
    mask = _visible(S, T, causal, prefix_len, lv, q.device)[None, None]
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]),
                    torch.zeros((), device=q.device))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhsd,bhtd->bhst", dof, vf) - delta)
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kf) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf) * scale
    dv = torch.einsum("bhst,bhsd->bhtd", p, dof)
    dk = dk.reshape(B, Kh, G, T, hd).sum(2)
    dv = dv.reshape(B, Kh, G, T, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: Tensor, k: Tensor, v: Tensor) -> None:
    B, H, S, hd = q.shape
    Kh, T = k.shape[1], k.shape[2]
    if k.shape != (B, Kh, T, hd) or v.shape != k.shape or H % Kh:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must share one dtype, f32 or bf16")
    if hd not in (16, 32, 64, 80) and not (hd == 128
                                           and q.dtype == torch.bfloat16):
        raise ValueError(f"head_dim {hd} not built (16, 32, 64, 80; 128 in "
                         f"bf16)")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("head_dim must be the contiguous axis")


def _check_mode(causal: bool, prefix_len: int, T: int) -> None:
    """Non-causal attention takes T >= 1 keys behind no prefix."""
    if not causal and (prefix_len or T < 1):
        raise ValueError(f"non-causal attention takes T >= 1 keys and no "
                         f"prefix, got T {T}, prefix_len {prefix_len}")


def _launch(q: Tensor, k: Tensor, v: Tensor, prefix_len: int, lv: int,
            with_lse: bool, causal: bool = True
            ) -> Tuple[Tensor, Optional[Tensor]]:
    """One ``flash_attention`` launch; the per-row log-sum-exp (B, H, S)
    f32 is written only ``with_lse``."""
    _check(q, k, v)
    _check_mode(causal, prefix_len, k.shape[2])
    B, H, S, hd = q.shape
    Kh, T = k.shape[1], k.shape[2]
    if q.device.type == "meta":
        out = torch.empty((B, S, H, hd), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
               if with_lse else None)
        cost.kernel("flash_attention", 4.0 * B * H * S * T * hd, (q, k, v),
                    (out, lse))
        return out, lse
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("the bf16 kernel copies q/k/v rows in 16-byte "
                         "pieces: rows must start 16-byte aligned")
    _lib.require_cuda(q, k, v)
    buf = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    out = buf.transpose(1, 2)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    code = _lib.lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        int(q.dtype == torch.bfloat16), int(causal), B, H, Kh, S, T, hd,
        int(prefix_len),
        lv, q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2), _lib.stream_ptr(q))
    _lib.check(code, "flash_attention")
    _lib.count("flash_attention")
    return out, lse


def _rows_aligned(t: Tensor) -> bool:
    """A bf16 tensor's rows start 16-byte aligned (the pointer, and every
    stride but the last a multiple of 8 elements): what 16-byte ``cp.async``
    copies of its rows need."""
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 \
        and all(s % 8 == 0 for s in t.stride()[:3])


def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                        lse: Tensor, do: Tensor, prefix_len: int = 0,
                        prefix_live: Optional[int] = None,
                        causal: bool = True
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v), given
    its output ``o``, its per-row log-sum-exp ``lse`` (B, H, S) f32 and the
    output's gradient ``do``. A CUDA tensor launches
    ``csrc/flash_attention_bwd.cu`` (one launch: the row sums D, then dk/dv
    by key tile and dq by query tile, then in bf16 the heads' dk/dv summed
    per kv-head); a CPU tensor takes ``flash_attention_bwd_plain``. A bf16
    operand whose rows are not 16-byte aligned (``do`` from autograd comes
    in any layout) is copied contiguous first."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, prefix_len,
                                         prefix_live, causal)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    _check(q, k, v)
    B, H, S, hd = q.shape
    Kh, T = k.shape[1], k.shape[2]
    _check_mode(causal, prefix_len, T)
    lv = _live(prefix_len, prefix_live)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)} must "
                         f"match q {tuple(q.shape)}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous (B, H, S) f32 tensor")
    do = do.to(q.dtype)
    bf16 = q.dtype == torch.bfloat16
    q, k, v, o, do = (t if (_rows_aligned(t) if bf16 else t.stride(3) == 1)
                      else t.contiguous() for t in (q, k, v, o, do))
    if q.device.type == "meta":
        return _bwd_meta(q, k, v, o, lse, do)
    _lib.require_cuda(q, k, v, o, lse, do)
    # the gradients in their inputs' layouts (strides are passed), so that
    # autograd neither copies them into the leaves' layouts nor, behind a
    # transposed (B, S, H, hd) view, makes them contiguous
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lib = _lib.lib()
    ws = torch.empty(lib.flash_attention_bwd_workspace_elems(
        int(bf16), B, H, Kh, S, T, hd), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*[
        s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]])
    code = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), ws.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), int(bf16), int(causal), B, H, Kh, S,
        T, hd,
        int(prefix_len), lv, strides, _lib.stream_ptr(q))
    _lib.check(code, "flash_attention_bwd")
    _lib.count("flash_attention_bwd")
    return dq, dk, dv


def _bwd_meta(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
              do: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The meta route of ``flash_attention_bwd``: the gradients in their
    inputs' layouts and the (B, H, S) f32 workspace the card allocates, one
    launch of 8·B·H·S·T·hd FLOPs."""
    B, H, S, hd = q.shape
    T = k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    ws = torch.empty(B * H * S, dtype=torch.float32, device=q.device)
    cost.kernel("flash_attention_bwd", 8.0 * B * H * S * T * hd,
                (q, k, v, o, lse, do), (dq, dk, dv))
    del ws
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` on the card, differentiable: the forward kernel
    writes the per-row log-sum-exp, the backward is
    ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, prefix_len, prefix_live, causal):
        out, lse = _launch(q, k, v, prefix_len, prefix_live, with_lse=True,
                           causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mode = (prefix_len, prefix_live, causal)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, *ctx.mode)
        return dq, dk, dv, None, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                    prefix_len: int = 0, prefix_live: Optional[int] = None
                    ) -> Tensor:
    """Returns (B, H, S, hd) in q's dtype. On the card the result is a
    (B, H, S, hd) view of a contiguous (B, S, H, hd) buffer."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, prefix_len,
                                     prefix_live)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    lv = _live(prefix_len, prefix_live)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, int(prefix_len), lv,
                                      bool(causal))
    return _launch(q, k, v, prefix_len, lv, with_lse=False,
                   causal=causal)[0]
