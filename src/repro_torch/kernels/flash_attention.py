"""Prefill attention with a fully visible CushionCache prefix (kernel +
plain version).

q: (B, H, S, hd); k/v: (B, Kh, T, hd) with Kh | H (GQA); with ``causal``
and ``prefix_len = m`` key j is visible to query i iff j < m or j <= i + m.
A CUDA tensor launches ``csrc/flash_attention.cu`` (causal only; it takes
strided views, so callers hand it (B, S, H, hd) activations transposed in
place); a CPU tensor takes ``flash_attention_plain``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib

NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, prefix_len: int = 0
                          ) -> torch.Tensor:
    """Plain PyTorch version (``ref.flash_attention_ref``): dense f32
    scores, -1e30 mask, softmax, output in q's dtype."""
    B, H, S, hd = q.shape
    Kh, T = k.shape[1], k.shape[2]
    if Kh != H:
        k = k.repeat_interleave(H // Kh, dim=1)
        v = v.repeat_interleave(H // Kh, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) \
        / math.sqrt(hd)
    if causal:
        i = torch.arange(S, device=q.device)[:, None]
        j = torch.arange(T, device=q.device)[None, :]
        mask = (j < prefix_len) | (j <= i + prefix_len)
        logits = torch.where(mask[None, None], logits,
                             torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w, v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, prefix_len: int = 0
                    ) -> torch.Tensor:
    """Returns (B, H, S, hd) in q's dtype. On the card the result is a
    (B, H, S, hd) view of a contiguous (B, S, H, hd) buffer."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, prefix_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not causal:
        raise NotImplementedError("the flash_attention kernel is causal "
                                  "(with a visible prefix) only")
    B, H, S, hd = q.shape
    Kh, T = k.shape[1], k.shape[2]
    if k.shape != (B, Kh, T, hd) or v.shape != k.shape or H % Kh:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must share one dtype, f32 or bf16")
    if hd not in (16, 32, 64):
        raise ValueError(f"head_dim {hd} not built (16, 32, 64)")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("head_dim must be the contiguous axis")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("the bf16 kernel copies q/k/v rows in 16-byte "
                         "pieces: rows must start 16-byte aligned")
    _lib.require_cuda(q, k, v)
    buf = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    out = buf.transpose(1, 2)
    code = _lib.lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), B, H, Kh, S, T, hd, int(prefix_len),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2), _lib.stream_ptr(q))
    _lib.check(code, "flash_attention")
    _lib.count("flash_attention")
    return out
