"""Static per-tensor activation quantizer (kernel + plain version).

``act_quant_static(x, scale, zero)`` computes
``clip(round_half_even(x / s + z), 0, 2^bits - 1) - 128`` as int8: the int8
storage of an asymmetric activation whose zero point the caller shifts by
-128 in the matmul epilogue. A CUDA tensor launches the hand-written kernel
(``csrc/act_quant.cu``); a CPU tensor takes ``act_quant_static_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib


def act_quant_static_plain(x: torch.Tensor, scale: torch.Tensor,
                           zero: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Plain PyTorch version (src/repro/kernels/ref.py
    ``act_quant_static_ref``), in f32 whatever the input dtype."""
    qmax = 2 ** bits - 1
    xq = torch.clamp(torch.round(x.float() / scale.float() + zero.float()),
                     0, qmax) - 128
    return xq.to(torch.int8)


def _check_scalar(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.float32 or t.numel() != 1:
        raise ValueError(f"{name} must be one float32 element, got "
                         f"{t.dtype} {tuple(t.shape)}")


def act_quant_static(x: torch.Tensor, scale: torch.Tensor,
                     zero: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """x: (M, D) f32 or bf16; scale, zero: one-element f32 tensors on x's
    device. Returns int8 (M, D)."""
    if x.device.type == "cpu":
        return act_quant_static_plain(x, scale, zero, bits)
    if x.device.type != "cuda":
        raise ValueError(f"act_quant_static: unsupported device {x.device}")
    if bits != 8:
        raise ValueError("act_quant_static kernel is 8-bit")
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"x must be contiguous f32/bf16, got {x.dtype}")
    _check_scalar(scale, "scale")
    _check_scalar(zero, "zero")
    _lib.require_cuda(x, scale, zero)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    code = _lib.lib().act_quant_static_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), scale.data_ptr(),
        zero.data_ptr(), out.data_ptr(), x.numel(), _lib.stream_ptr(x))
    _lib.check(code, "act_quant_static")
    _lib.count("act_quant_static")
    return out
