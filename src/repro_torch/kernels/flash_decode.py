"""Single-query decode attention over a contiguous KV cache (kernel + plain
version).

q: (B, H, hd); k/v: (B, Smax, K, hd), fp, or int8 with per-kv-head dequant
scales k_scale/v_scale (K,); kc/vc: (m, K, hd) fp cushion covering positions
[0, m) (int8 caches only: an fp cache holds the cushion in-cache); pos: ()
or (B,) int32. Row b attends positions <= pos[b] (and the whole cushion);
pos < 0 retires a row. A CUDA tensor launches ``csrc/flash_decode.cu``; a
CPU tensor takes ``flash_decode_plain``. Per-row (B, K) scales and the paged
layout are not ported yet (ROADMAP queue 2).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _lib

NEG_INF = -1e30


def _posv(pos, B: int, device) -> torch.Tensor:
    p = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1)
    return p.expand(B)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pos, k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None,
                       kc: Optional[torch.Tensor] = None,
                       vc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version (``ref.flash_decode_ref``): dense f32 scores
    over the whole cache with the cushion spliced over [0, m)."""
    B, H, hd = q.shape
    Smax, K = k.shape[1], k.shape[2]
    G = H // K
    m = 0 if kc is None else kc.shape[0]
    kf = k.float()
    vf = v.float()
    if k_scale is not None:
        if k_scale.dim() == 2:
            kf = kf * k_scale.float()[:, None, :, None]
            vf = vf * v_scale.float()[:, None, :, None]
        else:
            kf = kf * k_scale.float()[None, None, :, None]
            vf = vf * v_scale.float()[None, None, :, None]
    if m:
        kcb = kc.float()[None].expand(B, *kc.shape)
        vcb = vc.float()[None].expand(B, *vc.shape)
        kf = torch.cat([kcb, kf[:, m:]], dim=1)
        vf = torch.cat([vcb, vf[:, m:]], dim=1)
    qg = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgh,btkh->bkgt", qg, kf) / math.sqrt(hd)
    posv = _posv(pos, B, q.device)
    idx = torch.arange(Smax, device=q.device)
    valid = idx[None, :] <= posv[:, None]
    if m:
        valid = valid | (idx < m)[None, :]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", w, vf)
    out = torch.where(valid.any(dim=1)[:, None, None, None], out,
                      torch.zeros((), device=q.device))
    return out.reshape(B, H, hd).to(q.dtype)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None,
                 kc: Optional[torch.Tensor] = None,
                 vc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Returns (B, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, pos, k_scale, v_scale, kc, vc)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    B, H, hd = q.shape
    Smax, K = k.shape[1], k.shape[2]
    quantized = k_scale is not None
    m = 0 if kc is None else kc.shape[0]
    if m and not quantized:
        raise ValueError("fp caches hold the cushion in-cache (kc/vc are "
                         "for int8 caches)")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be f32 or bf16, got {q.dtype}")
    if k.shape != (B, Smax, K, hd) or v.shape != k.shape or H % K:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if hd not in (16, 32, 64) or H // K > 8:
        raise ValueError(f"head_dim {hd} / group {H // K} not built")
    cache_dt = torch.int8 if quantized else q.dtype
    if k.dtype != cache_dt or v.dtype != cache_dt:
        raise ValueError(f"cache dtype must be {cache_dt}, got {k.dtype}")
    tensors = [q, k, v]
    if quantized:
        if k_scale.dim() != 1 or v_scale is None or v_scale.dim() != 1:
            raise NotImplementedError(
                "per-row (B, K) KV scales come with the continuous-batching "
                "slice (ROADMAP queue 2)")
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or s.shape != (K,):
                raise ValueError("KV scales must be f32 (K,)")
        tensors += [k_scale, v_scale]
    if m:
        for c in (kc, vc):
            if c.shape != (m, K, hd) or c.dtype != q.dtype:
                raise ValueError("kc/vc must be (m, K, hd) in q's dtype")
        tensors += [kc, vc]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode takes contiguous operands")
    posv = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    if posv.numel() not in (1, B) or not posv.is_contiguous():
        raise ValueError(f"pos must be () or ({B},) int32")
    _lib.require_cuda(*tensors, posv)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    code = _lib.lib().flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        kc.data_ptr() if m else None, vc.data_ptr() if m else None,
        posv.data_ptr(), int(posv.numel() == B and posv.dim() == 1),
        out.data_ptr(), int(q.dtype == torch.bfloat16), int(quantized),
        B, H, K, Smax, hd, m, _lib.stream_ptr(q))
    _lib.check(code, "flash_decode")
    _lib.count("flash_decode")
    return out
