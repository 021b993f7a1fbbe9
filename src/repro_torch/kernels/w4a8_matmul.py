"""W4A8 matmul: int8 activations times int4-packed weights with group-wise
weight scales (kernel + plain version).

``w4a8_matmul(x_int, w_packed, s_x, z_x, s_w, colsum, group_size)``
computes

    out = (sum_g s_w[g] * float(x_int[:, g] @ w[g]) - z * colsum) * s_x

with ``w = unpack_int4(w_packed, K)``, each group's product an exact int32,
the groups added in order, and ``z = z_x + z_shift`` (``z_shift`` folds the
int8 storage offset of the activation codes, -128, as in ``w8a8_matmul``).
``colsum`` is the *scale-weighted* column sum ``sum_g s_w[g] * colsum_g``
that ``prequantize(weight_bits=4)`` stores, so the zero-point correction is
one rank-1 subtract. A CUDA tensor launches ``csrc/w4a8_matmul.cu``; a CPU
tensor takes ``w4a8_matmul_plain``; a meta tensor records the launch in the
dry-run's tally, as ``w8a8_matmul`` does. ``quant_w4a8_matmul`` takes the f32 /
bf16 activation and its static scale and zero instead of the codes, as
``quant_w8a8_matmul`` does. ``s_w`` is read in its stored dtype,
f32 or bf16 (the weight's, as ``prequantize`` keeps it), and converted
exactly.

``accumulate=True`` returns the f32 accumulator ``sum_g s_w[g] *
float(x_int[:, g] @ w[g])`` with no epilogue (``colsum`` and ``z_shift``
are then not read), in either regime and in the fused staging. Tensor
parallelism's row-parallel sites take it: each rank sums its groups, the
ranks' f32 sums are added, and ``w4a8_epilogue`` applies the epilogue once
with the whole weight's scaled ``colsum``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.act_quant import (act_quant_static,
                                           act_quant_static_plain)
from repro_torch.kernels.w8a8_matmul import (SCALE_DTYPES, X_KINDS,
                                             _check_scalar, decode_max_m,
                                             int_product_exact, meta_launch,
                                             workspace)


def unpack_int4(packed: torch.Tensor, k: int) -> torch.Tensor:
    """(ceil(k/2), ...) int8 nibble pairs -> (k, ...) int8, sign-extended
    (``core.quantization.pack_int4`` layout: element 2i in the low nibble of
    byte i, 2i+1 in the high nibble)."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = p >> 4                  # arithmetic: the byte's sign is the nibble's
    w = torch.stack([lo, hi], dim=1).reshape(p.shape[0] * 2, *p.shape[1:])
    return w[:k].to(torch.int8)


def w4a8_epilogue(acc: torch.Tensor, s_x: torch.Tensor, z_x: torch.Tensor,
                  colsum: torch.Tensor, z_shift: float = 0.0,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(acc - z * colsum) * s_x`` on the f32 accumulator, z = z_x +
    z_shift, one rounding a step in the kernel's order, on any device."""
    z = z_x.float() + z_shift
    out = (acc - z * colsum.float()) * s_x.float()
    return out.to(out_dtype)


def w4a8_matmul_plain(x_int: torch.Tensor, w_packed: torch.Tensor,
                      s_x: torch.Tensor, z_x: torch.Tensor, s_w: torch.Tensor,
                      colsum: torch.Tensor, group_size: int,
                      z_shift: float = 0.0,
                      out_dtype: torch.dtype = torch.float32,
                      accumulate: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the kernel's sums in the kernel's order (the
    groups added one after another into an f32 zero), one separately
    rounded tensor op per step. Any K (odd K through ``unpack_int4``).
    ``accumulate``: the f32 sum, no epilogue."""
    M, K = x_int.shape
    w = unpack_int4(w_packed, K)
    acc = torch.zeros((M, w.shape[1]), dtype=torch.float32,
                      device=x_int.device)
    for k0 in range(0, K, group_size):
        k1 = k0 + group_size
        part = int_product_exact(x_int[:, k0:k1], w[k0:k1]).float()
        acc = acc + part * s_w[k0 // group_size].float()
    if accumulate:
        return acc
    return w4a8_epilogue(acc, s_x, z_x, colsum, z_shift, out_dtype)


def _launch(x: torch.Tensor, w_packed: torch.Tensor, s_x: torch.Tensor,
            z_x: torch.Tensor, s_w: torch.Tensor, colsum: torch.Tensor,
            group_size: int, z_shift: float,
            out_dtype: torch.dtype, accumulate: bool = False
            ) -> torch.Tensor:
    """One launch of ``csrc/w4a8_matmul.cu`` on int8 codes, or (M <= 16) on
    an f32 / bf16 activation that the kernel quantizes while it stages it;
    checks every operand first. ``accumulate``: the f32 accumulator
    (``colsum`` may be None). On meta: ``w8a8_matmul.meta_launch``."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"w4a8_matmul: unsupported device {x.device}")
    if x.dtype not in X_KINDS or w_packed.dtype != torch.int8:
        raise ValueError(f"w4a8_matmul takes int8, f32 or bf16 x and int8 "
                         f"w_packed, got {x.dtype} and {w_packed.dtype}")
    if x.dim() != 2 or w_packed.dim() != 2:
        raise ValueError("w4a8_matmul takes 2-D operands")
    M, K = x.shape
    Kp, N = w_packed.shape
    if K % 2 or Kp * 2 != K:
        raise ValueError(f"packed rows {Kp} do not hold an even K={K}")
    if K % 4 or group_size % 4 or K % group_size:
        raise ValueError(f"K={K} and group_size={group_size} must be "
                         f"multiples of 4 with groups tiling K")
    if x.dtype != torch.int8 and M > decode_max_m(x.device.type):
        raise ValueError(f"the kernel quantizes x only at M <= "
                         f"{decode_max_m(x.device.type)}, got M={M}")
    G = K // group_size
    if s_w.dtype not in SCALE_DTYPES or s_w.shape != (G, N) \
            or not s_w.is_contiguous():
        raise ValueError(f"s_w must be contiguous f32 or bf16 ({G}, {N}), "
                         f"got {s_w.dtype} {tuple(s_w.shape)}")
    if accumulate:
        out_dtype = torch.float32
    elif colsum is None or colsum.dtype != torch.float32 \
            or colsum.shape != (N,) or not colsum.is_contiguous():
        raise ValueError("colsum must be contiguous f32 (N,)")
    if not (x.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("w4a8_matmul takes contiguous operands")
    if (x.dtype == torch.int8 and x.data_ptr() % 4) \
            or w_packed.data_ptr() % 4:
        raise ValueError("w4a8_matmul int8 operands must be 4-byte aligned")
    _check_scalar(s_x, "s_x")
    _check_scalar(z_x, "z_x")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    if x.device.type == "meta":
        return meta_launch("w4a8_matmul_acc" if accumulate else "w4a8_matmul",
                           x, w_packed, N, out_dtype,
                           (s_w, s_x, z_x, None if accumulate else colsum),
                           group_size)
    _lib.require_cuda(x, w_packed, s_w, s_x, z_x,
                      *(() if colsum is None else (colsum,)))
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    ws = workspace(x, M, N, K, group_size)
    code = _lib.lib().w4a8_matmul_launch(
        x.data_ptr(), X_KINDS[x.dtype], w_packed.data_ptr(), s_w.data_ptr(),
        int(s_w.dtype == torch.bfloat16),
        0 if accumulate else colsum.data_ptr(), s_x.data_ptr(),
        z_x.data_ptr(), float(z_shift), out.data_ptr(),
        2 if accumulate else int(out_dtype == torch.bfloat16), M, N, K,
        group_size, ws.data_ptr(), _lib.stream_ptr(x))
    _lib.check(code, "w4a8_matmul")
    _lib.count("w4a8_matmul_acc" if accumulate else "w4a8_matmul")
    if x.dtype != torch.int8:
        _lib.count("act_quant_static_fused")
    return out


def w4a8_matmul(x_int: torch.Tensor, w_packed: torch.Tensor,
                s_x: torch.Tensor, z_x: torch.Tensor, s_w: torch.Tensor,
                colsum: torch.Tensor, group_size: int, z_shift: float = 0.0,
                out_dtype: torch.dtype = torch.float32,
                accumulate: bool = False) -> torch.Tensor:
    """x_int: (M, K) int8; w_packed: (K/2, N) int8; s_x, z_x: one-element
    f32 tensors; s_w: (K / group_size, N) f32 or bf16; colsum: (N,) f32. Returns
    (M, N) in ``out_dtype`` (f32 or bf16, rounded once from the f32
    epilogue; ``accumulate``: the f32 accumulator, no epilogue). The kernel
    takes an even K, and K and ``group_size`` multiples of 4."""
    if x_int.device.type == "cpu":
        return w4a8_matmul_plain(x_int, w_packed, s_x, z_x, s_w, colsum,
                                 group_size, z_shift, out_dtype, accumulate)
    if x_int.device.type in ("cuda", "meta") and x_int.dtype != torch.int8:
        raise ValueError("w4a8_matmul takes int8 operands")
    return _launch(x_int, w_packed, s_x, z_x, s_w, colsum, group_size,
                   z_shift, out_dtype, accumulate)


def quant_w4a8_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor,
                            s_x: torch.Tensor, z_x: torch.Tensor,
                            s_w: torch.Tensor, colsum: torch.Tensor,
                            group_size: int,
                            out_dtype: torch.dtype = torch.float32,
                            accumulate: bool = False) -> torch.Tensor:
    """``act_quant_static_plain`` then ``w4a8_matmul_plain`` with the -128
    storage shift folded into the epilogue: the function of both routes of
    ``quant_w4a8_matmul``."""
    return w4a8_matmul_plain(act_quant_static_plain(x, s_x, z_x), w_packed,
                             s_x, z_x, s_w, colsum, group_size, -128.0,
                             out_dtype, accumulate)


def quant_w4a8_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                      s_x: torch.Tensor, z_x: torch.Tensor, s_w: torch.Tensor,
                      colsum: torch.Tensor, group_size: int,
                      out_dtype: torch.dtype = torch.float32,
                      accumulate: bool = False) -> torch.Tensor:
    """The activation quantized with the site's static scale and zero
    (``act_quant_static``), times the packed int4 weight. x: (M, K) f32 or
    bf16; the rest as ``w4a8_matmul``. On the card, M <= 16 is one launch
    of the w4a8 kernel, which quantizes x while it stages it (counted under
    ``w4a8_matmul`` and ``act_quant_static_fused``); M > 16 launches
    ``act_quant_static`` and then the kernel on the codes. A CPU tensor
    takes the plain version."""
    if x.device.type == "cpu":
        return quant_w4a8_matmul_plain(x, w_packed, s_x, z_x, s_w, colsum,
                                       group_size, out_dtype, accumulate)
    if x.dim() == 2 and x.shape[0] > decode_max_m(x.device.type):
        x = act_quant_static(x, s_x, z_x)
    return _launch(x, w_packed, s_x, z_x, s_w, colsum, group_size, -128.0,
                   out_dtype, accumulate)
