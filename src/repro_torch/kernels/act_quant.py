"""Activation quantizers (kernels + plain versions).

``act_quant_static(x, scale, zero)`` computes
``clip(round_half_even(x / s + z), 0, 2^bits - 1) - 128`` as int8: the int8
storage of an asymmetric activation whose zero point the caller shifts by
-128 in the matmul epilogue.

``act_quant_ptoken(x, bits)`` is the per-token dynamic quantizer: per row,
``mn = min(min(x), 0)`` and ``mx = max(max(x), 0)`` give a scale and an
integer zero point, and the codes are stored the same way. It returns
``(codes int8 (M, D), scale f32 (M, 1), zero f32 (M, 1))``, the Pallas
kernel's contract. The input's dtype sets the arithmetic: an f32 input takes
the Pallas kernel's (``scale = max((mx - mn) / qmax, 1e-8)``, all in f32); a
bf16 input the JAX model path's on a bf16 activation (``params_from_minmax``
and ``quantize`` as bf16 ops: each step rounded to bf16; scale and zero come
out holding bf16 values). A caller that wants the Pallas arithmetic on a bf16
activation upcasts it first, as the Pallas kernel does.

Under tensor parallelism a row-parallel site's rows are cut over the
ranks, and the row's range is the ranks' min and max:
``act_quant_ptoken_range(x)`` is the kernel's range-only mode (each row's
``(mn, mx)`` with the zero folded in, f32 (M, 1) each), and
``act_quant_ptoken(x, bits, rng=(mn, mx))`` its given-range mode (the
codes, scale and zero it makes from that range). Min and max are exact, so
a rank's codes are those of the whole row.

A CUDA tensor launches the hand-written kernels (``csrc/act_quant.cu``); a
CPU tensor takes the plain versions; a meta tensor (the dry-run) returns
empty outputs of the kernel's shapes and records one launch, no FLOPs and
its bytes in the dry-run's tally (``launch/cost.kernel``). The serving
path launches ``act_quant_static`` only above 16 rows: at decode the int matmuls quantize
their A operand themselves (``quant_w8a8_matmul``, ``quant_w4a8_matmul``),
with the same arithmetic (``csrc/act_quant.cuh``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _lib
from repro_torch.launch import cost


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
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"act_quant_static: unsupported device {x.device}")
    if bits != 8:
        raise ValueError("act_quant_static kernel is 8-bit")
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"x must be contiguous f32/bf16, got {x.dtype}")
    _check_scalar(scale, "scale")
    _check_scalar(zero, "zero")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.device.type == "meta":
        cost.kernel("act_quant_static", 0, (x, scale, zero), (out,))
        return out
    _lib.require_cuda(x, scale, zero)
    code = _lib.lib().act_quant_static_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), scale.data_ptr(),
        zero.data_ptr(), out.data_ptr(), x.numel(), _lib.stream_ptr(x))
    _lib.check(code, "act_quant_static")
    _lib.count("act_quant_static")
    return out


def act_quant_ptoken_range_plain(x: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the range-only mode: each row's ``min(min(x), 0)``
    and ``max(max(x), 0)``, f32 (M, 1)."""
    mn = torch.clamp(x.amin(dim=-1, keepdim=True), max=0.0)
    mx = torch.clamp(x.amax(dim=-1, keepdim=True), min=0.0)
    return mn.float(), mx.float()


def act_quant_ptoken_plain(x: torch.Tensor, bits: int = 8, rng=None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Plain PyTorch version: on f32 input ``ref.act_quant_ref(
    per_token=True)``; on any other dtype ``quantization.params_from_minmax``
    and ``quantize`` in that dtype (bf16 on the card; the CPU also takes
    f16). ``rng``: each row's given (mn, mx), (M, 1) each, in place of its
    own. Every divisor is a tensor, never a Python number: a CUDA division
    by a host scalar multiplies by its reciprocal, which is not the IEEE
    quotient."""
    qmax = 2 ** bits - 1
    q_t = torch.tensor(float(qmax), dtype=x.dtype, device=x.device)
    if rng is None:
        mn = torch.clamp(x.amin(dim=-1, keepdim=True), max=0.0)
        mx = torch.clamp(x.amax(dim=-1, keepdim=True), min=0.0)
    else:
        mn, mx = (r.reshape(-1, 1).to(x.dtype) for r in rng)
    if x.dtype == torch.float32:
        scale = torch.clamp((mx - mn) / q_t, min=1e-8)
        zero = torch.round(torch.clamp(-mn / scale, 0, qmax))
    else:
        scale = (mx - mn) / q_t
        zero = 0 - mn / torch.where(scale == 0, 1.0, scale)
        zero = torch.round(torch.clamp(zero, 0, qmax))
        scale = torch.where(scale <= 0, 1.0, scale)
    q = torch.clamp(torch.round(x / scale + zero), 0, qmax)
    return ((q.to(torch.int32) - 128).to(torch.int8), scale.float(),
            zero.float())


def _ptoken_launch(x: torch.Tensor, bits: int, mode: int, rng=None):
    """One launch of the per-token kernel in ``mode`` (0 whole, 1 range
    only, 2 the given range); checks every operand first. Returns (codes,
    scale, zero), or (mn, mx) in the range-only mode. On meta the outputs
    are empty and the launch is recorded in the dry-run's tally."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"act_quant_ptoken: unsupported device {x.device}")
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    if x.dim() != 2 or not x.is_contiguous() \
            or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be contiguous 2-D f32/bf16, got {x.dtype} "
                         f"{tuple(x.shape)}")
    M, D = x.shape
    if x.device.type == "meta":
        return _ptoken_meta(x, mode, rng)
    f32 = dict(dtype=torch.float32, device=x.device)
    if mode == 2:
        lo, hi = (r.reshape(M, 1).float().contiguous() for r in rng)
        _lib.require_cuda(x, lo, hi)
    else:
        lo, hi = torch.empty((M, 1), **f32), torch.empty((M, 1), **f32)
    out = scale = zero = None
    if mode != 1:
        out = torch.empty((M, D), dtype=torch.int8, device=x.device)
        scale = torch.empty((M, 1), **f32)
        zero = torch.empty((M, 1), **f32)
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    code = _lib.lib().act_quant_ptoken_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), ptr(out), ptr(scale),
        ptr(zero), lo.data_ptr(), hi.data_ptr(), mode, M, D,
        float(2 ** bits - 1), _lib.stream_ptr(x))
    _lib.check(code, "act_quant_ptoken")
    _lib.count(("act_quant_ptoken", "act_quant_ptoken_range",
                "act_quant_ptoken_given")[mode])
    return (lo, hi) if mode == 1 else (out, scale, zero)


def _ptoken_meta(x: torch.Tensor, mode: int, rng=None):
    """The meta route of ``_ptoken_launch``."""
    M, D = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    col = [torch.empty((M, 1), **f32) for _ in range(2)]
    name = ("act_quant_ptoken", "act_quant_ptoken_range",
            "act_quant_ptoken_given")[mode]
    if mode == 1:
        cost.kernel(name, 0, (x,), col)
        return tuple(col)
    out = torch.empty((M, D), dtype=torch.int8, device=x.device)
    cost.kernel(name, 0, (x, *(rng if mode == 2 else ())), (out, *col))
    return (out, *col)


def act_quant_ptoken(x: torch.Tensor, bits: int = 8, rng=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (M, D) f32 or bf16 (the CPU also takes other float dtypes).
    Returns (int8 (M, D), scale f32 (M, 1), zero f32 (M, 1)). ``rng``: each
    row's (mn, mx), (M, 1) f32 each (values x's dtype holds), in place of
    the row's own (the given-range mode; counted under
    ``act_quant_ptoken_given``)."""
    if x.device.type == "cpu":
        return act_quant_ptoken_plain(x, bits, rng)
    return _ptoken_launch(x, bits, 0 if rng is None else 2, rng)


def act_quant_ptoken_range(x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's (min(min(x), 0), max(max(x), 0)), f32 (M, 1) each: the
    per-token kernel's range-only mode (counted under
    ``act_quant_ptoken_range``)."""
    if x.device.type == "cpu":
        return act_quant_ptoken_range_plain(x)
    return _ptoken_launch(x, 8, 1)
