"""W8A8 per-tensor-static matmul (kernel + plain version).

``w8a8_matmul(x_int, w_int, s_x, z_x, s_w, colsum)`` computes
``(float(x_int @ w_int) - z * float(colsum)) * (s_x * s_w)`` with an exact
int32 product and ``z = z_x + z_shift``. ``z_shift`` lets the caller pass
the calibrated zero point as it is stored and fold the int8 storage offset
(-128) in here, instead of a separate subtraction per call. A CUDA tensor
launches ``csrc/w8a8_matmul.cu``; a CPU tensor takes ``w8a8_matmul_plain``.
``s_w`` is read in its stored dtype, f32 or bf16 (the weight's, as
``prequantize`` keeps it), and converted exactly.

``quant_w8a8_matmul(x, ...)`` takes the f32 / bf16 activation and the
site's static scale and zero instead of the codes: the serving path's one
call per site (``core/quantization.py``).

A ``meta`` tensor (the dry-run, ``launch/dryrun.py``) takes the card's
route without launching: each wrapper returns empty meta outputs of the
kernel's shapes and records its FLOPs (2 M N K), bytes and launch into the
dry-run's tally (``launch/cost.kernel``); it never builds the library.

``out_dtype=torch.int32`` returns the exact accumulator ``x_int @ w_int``
with no epilogue (``colsum`` is then not read). Tensor parallelism's
row-parallel sites (``wo``, ``w_down``) take it: the ranks sum their
int32 partials, which is exact, and ``w8a8_epilogue`` applies the
epilogue once to the sum with the whole weight's ``colsum``, in the
kernel's order, so a sharded W8A8 layer computes what the whole one does.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.act_quant import (act_quant_static,
                                           act_quant_static_plain)
from repro_torch.launch import cost

F32_EXACT_K = 1024  # 1024 * 128 * 128 == 2**24: f32 partial sums stay exact


def int_product_exact(xq: torch.Tensor, w_int: torch.Tensor) -> torch.Tensor:
    """Bit-exact int8 x int8 -> int32 product through f32 matmuls (as
    ``_int_product_f32_exact`` in the JAX package): every chunk of at most
    1024 along K sums to below 2**24 in magnitude, which f32 holds exactly,
    and the chunks are added in int32. Works on any device (f32 matmuls on
    the card must not use TF32)."""
    K = w_int.shape[0]
    xf = xq.float()
    wf = w_int.float()
    acc = None
    for k0 in range(0, K, F32_EXACT_K):
        k1 = min(k0 + F32_EXACT_K, K)
        part = (xf[..., k0:k1] @ wf[k0:k1]).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def w8a8_epilogue(acc: torch.Tensor, s_x: torch.Tensor, z_x: torch.Tensor,
                  s_w: torch.Tensor, colsum: torch.Tensor,
                  z_shift: float = 0.0,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(float(acc) - z * float(colsum)) * (s_x * s_w)``, z = z_x +
    z_shift, one rounding a step in the kernel's order (each step a tensor
    op of its own: nothing contracts into a fused multiply-add), on any
    device."""
    z = z_x.float() + z_shift
    out = (acc.float() - z * colsum.float()) * (s_x.float() * s_w.float())
    return out.to(out_dtype)


def w8a8_matmul_plain(x_int: torch.Tensor, w_int: torch.Tensor,
                      s_x: torch.Tensor, z_x: torch.Tensor,
                      s_w: torch.Tensor,
                      colsum: Optional[torch.Tensor] = None,
                      z_shift: float = 0.0,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version (``ref.w8a8_matmul_ref`` with the epilogue of
    ``quantization._int8_matmul``); ``out_dtype=torch.int32`` returns the
    accumulator."""
    acc = int_product_exact(x_int, w_int)
    if out_dtype == torch.int32:
        return acc
    if colsum is None:
        colsum = w_int.to(torch.int32).sum(0)
    return w8a8_epilogue(acc, s_x, z_x, s_w, colsum, z_shift, out_dtype)


SCALE_DTYPES = (torch.float32, torch.bfloat16)
# the kernels' A operand: int8 codes, or an activation they quantize
X_KINDS = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
# what the kernel writes: the epilogue's f32 or bf16, or the int32 acc
OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


# ``D_MAX_M`` of ``csrc/int_matmul.cuh``: what the meta route takes for
# ``decode_max_m`` without loading the library (the card's launch counts,
# which the dry-run's must equal, hold the two together)
DECODE_MAX_M = 16


@functools.cache
def _lib_decode_max_m() -> int:
    return int(_lib.lib().int_matmul_decode_max_m())


def decode_max_m(device_type: str = "cuda") -> int:
    """The most rows of the int matmuls' decode regime
    (``csrc/int_matmul.cuh``), the only one that quantizes A itself, as the
    kernels define it: on the card it loads the kernel library; on meta it
    is ``DECODE_MAX_M``."""
    return DECODE_MAX_M if device_type == "meta" else _lib_decode_max_m()


def workspace_elems(M: int, N: int, K: int, group: int) -> int:
    """``int_matmul_workspace_elems`` of ``csrc/int_matmul.cuh`` (the
    decode regime's (K / group, M, N) partials and a ticket a 128-column
    tile; none above ``DECODE_MAX_M`` rows), for the meta route."""
    if M > DECODE_MAX_M or group <= 0:
        return 0
    return (K // group) * M * N + -(-N // 128)


def meta_launch(name: str, x: torch.Tensor, w: torch.Tensor, N: int,
                out_dtype: torch.dtype, reads, group: int) -> torch.Tensor:
    """The meta route of either int matmul's launch, its operands checked
    as for the card: the (M, N) output,
    the workspace the card allocates (held while the launch runs), and
    one launch of ``name`` (and of ``act_quant_static_fused`` when the
    kernel quantizes an f32 / bf16 x in its staging) recorded with 2·M·N·K
    FLOPs and each operand read once."""
    M, K = x.shape
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    ws = torch.empty(workspace_elems(M, N, K, group), dtype=torch.int32,
                     device=x.device)
    cost.kernel(name, 2.0 * M * N * K, (x, w, *reads), (out,),
                fused=() if x.dtype == torch.int8
                else ("act_quant_static_fused",), int8=True)
    del ws
    return out


def _check_scalar(t: torch.Tensor, name: str,
                  dtypes=(torch.float32,)) -> None:
    if t.dtype not in dtypes or t.numel() != 1:
        raise ValueError(f"{name} must be one element of "
                         f"{[str(d) for d in dtypes]}, got "
                         f"{t.dtype} {tuple(t.shape)}")


# the decode regime's int32 workspace (partials and tickets), zeros kept
# per device and stream and left zero by every launch; a second stream gets
# a buffer of its own (a CUDA graph's capture stream too: serving/graphs.py
# warms up there first and keeps the buffer it captured alive)
WORKSPACE: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def workspace(x: torch.Tensor, M: int, N: int, K: int,
              group: int) -> torch.Tensor:
    """The int matmuls' workspace for this call, sized by the kernel's
    ``int_matmul_workspace_elems`` and grown on demand."""
    n = max(int(_lib.lib().int_matmul_workspace_elems(M, N, K, group)), 1)
    key = (x.device, _lib.stream_ptr(x))
    ws = WORKSPACE.get(key)
    if ws is None or ws.numel() < n:
        ws = torch.zeros(n, dtype=torch.int32, device=x.device)
        WORKSPACE[key] = ws
    return ws


def _launch(x: torch.Tensor, w_int: torch.Tensor, s_x: torch.Tensor,
            z_x: torch.Tensor, s_w: torch.Tensor,
            colsum: Optional[torch.Tensor], z_shift: float,
            out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of ``csrc/w8a8_matmul.cu`` on int8 codes, or (M <= 16) on
    an f32 / bf16 activation that the kernel quantizes while it stages it;
    checks every operand first. On meta: ``meta_launch``."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"w8a8_matmul: unsupported device {x.device}")
    if x.dtype not in X_KINDS or w_int.dtype != torch.int8:
        raise ValueError(f"w8a8_matmul takes int8, f32 or bf16 x and int8 "
                         f"w, got {x.dtype} and {w_int.dtype}")
    if x.dim() != 2 or w_int.dim() != 2:
        raise ValueError("w8a8_matmul takes 2-D operands")
    M, K = x.shape
    K2, N = w_int.shape
    if K != K2:
        raise ValueError(f"contracting dims differ: {K} vs {K2}")
    if K % 4:
        raise ValueError(f"K={K} must be a multiple of 4 (dp4a words)")
    if x.dtype != torch.int8 and M > decode_max_m(x.device.type):
        raise ValueError(f"the kernel quantizes x only at M <= "
                         f"{decode_max_m(x.device.type)}, got M={M}")
    if not (x.is_contiguous() and w_int.is_contiguous()):
        raise ValueError("w8a8_matmul takes contiguous operands")
    if (x.dtype == torch.int8 and x.data_ptr() % 4) or w_int.data_ptr() % 4:
        raise ValueError("w8a8_matmul int8 operands must be 4-byte aligned")
    if out_dtype not in OUT_KINDS:
        raise ValueError(f"out_dtype must be f32, bf16 or int32, got "
                         f"{out_dtype}")
    acc_only = out_dtype == torch.int32
    if colsum is None and not acc_only:
        colsum = w_int.sum(0, dtype=torch.int32)
    if colsum is not None and (colsum.dtype != torch.int32
                               or colsum.shape != (N,)
                               or not colsum.is_contiguous()):
        raise ValueError("colsum must be contiguous int32 (N,)")
    _check_scalar(s_x, "s_x")
    _check_scalar(z_x, "z_x")
    _check_scalar(s_w, "s_w", SCALE_DTYPES)
    if x.device.type == "meta":
        return meta_launch("w8a8_matmul", x, w_int, N, out_dtype,
                           (colsum, s_x, z_x, s_w), K)
    _lib.require_cuda(x, w_int, s_x, z_x, s_w,
                      *(() if colsum is None else (colsum,)))
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    ws = workspace(x, M, N, K, K)
    code = _lib.lib().w8a8_matmul_launch(
        x.data_ptr(), X_KINDS[x.dtype], w_int.data_ptr(),
        0 if colsum is None else colsum.data_ptr(),
        s_x.data_ptr(), z_x.data_ptr(), s_w.data_ptr(),
        int(s_w.dtype == torch.bfloat16), float(z_shift), out.data_ptr(),
        OUT_KINDS[out_dtype], M, N, K, ws.data_ptr(),
        _lib.stream_ptr(x))
    _lib.check(code, "w8a8_matmul")
    _lib.count("w8a8_matmul")
    if x.dtype != torch.int8:
        _lib.count("act_quant_static_fused")
    return out


def w8a8_matmul(x_int: torch.Tensor, w_int: torch.Tensor, s_x: torch.Tensor,
                z_x: torch.Tensor, s_w: torch.Tensor,
                colsum: Optional[torch.Tensor] = None, z_shift: float = 0.0,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x_int: (M, K) int8; w_int: (K, N) int8; s_x, z_x: one-element f32
    tensors; s_w: one f32 or bf16 element; colsum: (N,) int32 column sums of ``w_int`` (computed when
    absent). Returns (M, N) in ``out_dtype`` (f32 or bf16, rounded once from
    the f32 epilogue; int32: the accumulator, no epilogue)."""
    if x_int.device.type == "cpu":
        return w8a8_matmul_plain(x_int, w_int, s_x, z_x, s_w, colsum,
                                 z_shift, out_dtype)
    if x_int.device.type in ("cuda", "meta") and x_int.dtype != torch.int8:
        raise ValueError("w8a8_matmul takes int8 operands")
    return _launch(x_int, w_int, s_x, z_x, s_w, colsum, z_shift, out_dtype)


def quant_w8a8_matmul_plain(x: torch.Tensor, w_int: torch.Tensor,
                            s_x: torch.Tensor, z_x: torch.Tensor,
                            s_w: torch.Tensor,
                            colsum: Optional[torch.Tensor] = None,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """``act_quant_static_plain`` then ``w8a8_matmul_plain`` with the -128
    storage shift folded into the epilogue: the function of both routes of
    ``quant_w8a8_matmul``."""
    return w8a8_matmul_plain(act_quant_static_plain(x, s_x, z_x), w_int, s_x,
                             z_x, s_w, colsum, -128.0, out_dtype)


def quant_w8a8_matmul(x: torch.Tensor, w_int: torch.Tensor,
                      s_x: torch.Tensor, z_x: torch.Tensor, s_w: torch.Tensor,
                      colsum: Optional[torch.Tensor] = None,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The activation quantized with the site's static scale and zero
    (``act_quant_static``), times the int8 weight. x: (M, K) f32 or bf16;
    s_x, z_x: one-element f32 tensors; the rest as ``w8a8_matmul``. On the
    card, M <= 16 is one launch of the w8a8 kernel, which quantizes x while
    it stages it (counted under ``w8a8_matmul`` and
    ``act_quant_static_fused``); M > 16 launches ``act_quant_static`` and
    then the kernel on the codes. A CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return quant_w8a8_matmul_plain(x, w_int, s_x, z_x, s_w, colsum,
                                       out_dtype)
    if x.dim() == 2 and x.shape[0] > decode_max_m(x.device.type):
        x = act_quant_static(x, s_x, z_x)
    return _launch(x, w_int, s_x, z_x, s_w, colsum, -128.0, out_dtype)
