"""Quantization core (paper §3), ported from ``repro/core/quantization.py``.

Activations are asymmetric with a per-tensor range (``pt_static``:
calibrated; ``pt_dynamic``: computed on the fly) or a per-token range
(``ptoken_dynamic``: the ``act_quant_ptoken`` kernel on the card); weights
are symmetric. Two execution paths: fake-quant in float (the dynamic
baselines, calibration statistics and the fidelity experiments) and true
integer, which runs the static activation quantizer and ``w8a8_matmul``
(int8-resident weights, W8A8) or ``w4a8_matmul`` (int4-packed weights with
group-wise scales, W4A8) on the card: one launch at decode, whose A
staging quantizes the activation, or ``act_quant_static`` and the matmul.

Under tensor parallelism (``distributed/collectives.py``, a mesh of more
than one rank active) a weight is the rank's shard: its per-tensor range
is the whole weight's (``pmax``), and a row-parallel site (``wo``,
``w_down``: the contracting axis sharded) sums the ranks' partial
products, int32 accumulators where the product is W8A8 (exact, with the
epilogue applied once to the sum), W4A8's f32 group-scaled accumulators
(the epilogue applied once, with the whole weight's scaled column sums),
and f32 otherwise. A dynamic activation range over a row-parallel site's
features (cut over the ranks) is the ranks' min and max: per tensor
(``pt_dynamic``) of the local ranges, per row (``ptoken_dynamic``) of the
rows' (M, 1) partial ranges, which ``act_quant_ptoken``'s range-only mode
gives and its given-range mode quantizes with. Min and max are exact, so
every scale, zero point and code is the unsharded run's.

Type promotion follows JAX, not PyTorch: JAX promotes a bf16 array against
a 0-dim f32 array to f32, PyTorch keeps bf16. ``_promote`` casts both
operands of each mixed binary step to the JAX result type, so quantized
codes match the reference bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.distributed import collectives as DC
from repro_torch.kernels.act_quant import (act_quant_ptoken,
                                           act_quant_ptoken_range)
from repro_torch.kernels.w4a8_matmul import unpack_int4  # noqa: F401 (the reference's name)
from repro_torch.kernels.w4a8_matmul import (quant_w4a8_matmul,
                                             w4a8_epilogue, w4a8_matmul)
from repro_torch.kernels.w8a8_matmul import (quant_w8a8_matmul, w8a8_epilogue,
                                             w8a8_matmul)

# what tensor parallelism does not shard yet raises NotImplementedError: a
# continuous pool reads a ValueError at admission as a request that can
# never fit and drops it, where this refusal must stop the run
_TP_LATER = "(ROADMAP queue 1, item 6.4b)"

Tensor = torch.Tensor


def _promote(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Cast two tensors to their JAX (non-weak) common dtype."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


# ---------------------------------------------------------------------------
# Quantization parameters (scale / zero-point), eq. (3)-(4)
# ---------------------------------------------------------------------------

def qrange(bits: int, symmetric: bool) -> Tuple[int, int]:
    if symmetric:
        return -(2 ** (bits - 1) - 1), 2 ** (bits - 1) - 1
    return 0, 2 ** bits - 1


def params_from_minmax(mn: Tensor, mx: Tensor, bits: int, symmetric: bool
                       ) -> Tuple[Tensor, Tensor]:
    """scale, zero_point from observed (min, max). Shapes broadcast."""
    qmin, qmax = qrange(bits, symmetric)
    if symmetric:
        amax = torch.maximum(mn.abs(), mx.abs())
        scale = amax / qmax
        zero = torch.zeros_like(scale)
    else:
        mn = torch.clamp(mn, max=0.0)
        mx = torch.clamp(mx, min=0.0)
        scale = (mx - mn) / (qmax - qmin)
        zero = qmin - mn / torch.where(scale == 0, 1.0, scale)
        zero = torch.round(torch.clamp(zero, qmin, qmax))
    scale = torch.where(scale <= 0, 1.0, scale)
    return scale, zero


def quantize(x: Tensor, scale: Tensor, zero: Tensor, bits: int,
             symmetric: bool) -> Tensor:
    qmin, qmax = qrange(bits, symmetric)
    t = torch.div(*_promote(x, scale))
    t = torch.add(*_promote(t, zero))
    return torch.clamp(torch.round(t), qmin, qmax)


def dequantize(xq: Tensor, scale: Tensor, zero: Tensor) -> Tensor:
    t = torch.sub(*_promote(xq, zero))
    return torch.mul(*_promote(t, scale))


def fake_quant(x: Tensor, scale: Tensor, zero: Tensor, bits: int,
               symmetric: bool) -> Tensor:
    """Quantize -> dequantize with a straight-through gradient (scale and
    zero receive none)."""
    scale, zero = scale.detach(), zero.detach()
    y = dequantize(quantize(x, scale, zero, bits, symmetric), scale, zero)
    y = y.to(x.dtype)
    return x + (y - x).detach()


# ---------------------------------------------------------------------------
# Activation quantization per granularity
# ---------------------------------------------------------------------------

def _tp_extrema(mn: Tensor, mx: Tensor) -> Tuple[Tensor, Tensor]:
    """The ranks' elementwise min of ``mn`` and max of ``mx`` over tp (in
    f32, which holds any bf16 value exactly), in their dtype."""
    return (DC.pmin(mn.float()).to(mn.dtype),
            DC.pmax(mx.float()).to(mx.dtype))


def act_minmax(x: Tensor, per_token: bool, groups: int = 1,
               row_parallel: bool = False) -> Tuple[Tensor, Tensor]:
    """Per-token ranges, or one per-tensor range (the global batch's under
    a data axis, ``distributed/collectives.use_data``); with ``groups`` > 1
    the leading axis holds ``groups`` stacked tensors, each with its own
    range (shaped to broadcast against x). ``row_parallel``: x is a rank's
    slice of the features, and the range is the ranks' (whole on every
    rank, the per-row one from ``act_quant_ptoken``'s range-only mode)."""
    tp = row_parallel and DC.tp_size() > 1
    if per_token:
        if tp:
            mn, mx = act_quant_ptoken_range(
                x.reshape(-1, x.shape[-1]).contiguous())
            mn, mx = _tp_extrema(mn, mx)
            lead = tuple(x.shape[:-1]) + (1,)
            return mn.reshape(lead).to(x.dtype), mx.reshape(lead).to(x.dtype)
        return x.amin(dim=-1, keepdim=True), x.amax(dim=-1, keepdim=True)
    if tp:
        if groups > 1:
            raise ValueError("stacked groups (the search's candidates) run "
                             "on one rank")
        return DC.tp_extrema(x)
    if groups > 1:
        if DC.data_size() > 1:
            raise ValueError("stacked groups (the search's candidates) run "
                             "on one rank's batch, not over a data axis")
        xg = x.reshape(groups, -1)
        shape = (groups,) + (1,) * (x.dim() - 1)
        return xg.amin(1).reshape(shape), xg.amax(1).reshape(shape)
    # over the global batch under a data axis
    return DC.global_extrema(x)


def _ptoken_fake_quant(x: Tensor, cfg: QuantConfig,
                       row_parallel: bool = False) -> Tensor:
    """Per-token dynamic fake-quant through ``act_quant_ptoken``: the kernel
    quantizes the (M, D) view (in the activation's arithmetic: bf16-rounded
    steps for bf16, JAX's model path; f32 otherwise), and tensor ops
    dequantize ``(code + 128 - zero) * scale`` and apply the straight-through
    ``x + (y - x)`` in the activation's dtype, as ``fake_quant`` does. At a
    row-parallel site under tp the rows' ranges are the ranks' (the
    kernel's range-only mode, then its given-range mode)."""
    dt = x.dtype
    D = x.shape[-1]
    x2 = x.detach().reshape(-1, D).contiguous()
    rng = None
    if row_parallel and DC.tp_size() > 1:
        rng = _tp_extrema(*act_quant_ptoken_range(x2))
    codes, scale, zero = act_quant_ptoken(x2, bits=cfg.a_bits, rng=rng)
    y = (codes.to(dt) + 128 - zero.to(dt)) * scale.to(dt)
    return x + (y.reshape(x.shape) - x).detach()


def act_fake_quant(x: Tensor, cfg: QuantConfig,
                   static_scale: Optional[Tensor] = None,
                   static_zero: Optional[Tensor] = None,
                   groups: int = 1, rng: Optional[Tuple] = None,
                   row_parallel: bool = False) -> Tensor:
    """``rng``: x's per-tensor (min, max), where the caller has it
    (``site_taps``; not under tp at a row-parallel site, whose range is the
    ranks'). ``row_parallel``: as ``act_minmax``."""
    if row_parallel and DC.tp_size() > 1:
        rng = None
    if cfg.mode == "none":
        return x
    if cfg.mode == "pt_static":
        if static_scale is None:
            raise ValueError("static mode needs calibrated scales")
        return fake_quant(x, static_scale, static_zero, cfg.a_bits,
                          cfg.symmetric_a)
    if cfg.mode == "ptoken_dynamic":
        if not cfg.symmetric_a:
            return _ptoken_fake_quant(x, cfg, row_parallel)
        if x.device.type != "cpu":
            raise ValueError("symmetric per-token activations have no "
                             "kernel; they run on the CPU only")
    mn, mx = rng if rng is not None and cfg.mode == "pt_dynamic" else \
        act_minmax(x.detach(), cfg.mode == "ptoken_dynamic", groups,
                   row_parallel)
    scale, zero = params_from_minmax(mn, mx, cfg.a_bits, cfg.symmetric_a)
    return fake_quant(x, scale, zero, cfg.a_bits, cfg.symmetric_a)


# ---------------------------------------------------------------------------
# Weight quantization: symmetric, group-wise along the contracting dim
# ---------------------------------------------------------------------------

def weight_fake_quant(w: Tensor, cfg: QuantConfig,
                      row_parallel: bool = False) -> Tensor:
    """w: (..., d_in, d_out); groups tile the d_in (contracting) axis.
    ``row_parallel``: w is a rank's rows of a weight whose d_in is sharded;
    groups follow the whole weight's d_in (a group over all of it takes
    the ranks' max)."""
    if cfg.mode == "none" and not cfg.true_int8:
        return w
    if cfg.w_bits >= 16:
        return w
    d_in = w.shape[-2]
    d_all = d_in * (DC.tp_size() if row_parallel else 1)
    whole = not (cfg.w_group and d_all % cfg.w_group == 0)
    g = d_all if whole else cfg.w_group
    if d_in % g and not whole:
        raise NotImplementedError(
            f"weight groups of {g} rows straddle the shards of {d_in} "
            f"rows: not sharded yet {_TP_LATER}")
    g = min(g, d_in)
    shp = w.shape
    wg = w.reshape(*shp[:-2], d_in // g, g, shp[-1])
    with torch.no_grad():
        mn, mx = torch.aminmax(wg, dim=-2, keepdim=True)
        amax = torch.maximum(mx, -mn)           # the groups' max |w|
        if whole and row_parallel:
            amax = DC.pmax(amax)
        scale, _ = params_from_minmax(-amax, amax, cfg.w_bits, True)
        # fake_quant with the zero point of symmetric codes, 0, left out:
        # adding and subtracting it changes no value but the sign of a
        # zero, which the straight-through sum below washes out (the
        # experts' weights are fake-quantized on every call, as in the
        # reference: two passes fewer over them)
        qmin, qmax = qrange(cfg.w_bits, True)
        t = torch.div(*_promote(wg, scale)).round_().clamp_(qmin, qmax)
        y = torch.mul(*_promote(t, scale)).to(wg.dtype)
    return (wg + (y - wg).detach()).reshape(shp)


def weight_quant_int(w: Tensor, cfg: QuantConfig) -> Tuple[Tensor, Tensor]:
    """One per-tensor weight scale (the dequant is one scalar multiply in
    the matmul epilogue). Returns (w_int8, scale); the scale keeps the
    weight's dtype, as in JAX. A rank's shard takes the whole weight's
    range."""
    amax = DC.pmax(w.abs().amax())
    scale, _ = params_from_minmax(-amax, amax, cfg.w_bits, True)
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    wq = quantize(w, scale, zero, cfg.w_bits, True).to(torch.int8)
    return wq, scale


def weight_quant_int4(w: Tensor, cfg: QuantConfig
                      ) -> Tuple[Tensor, Tensor, int]:
    """Group-wise symmetric int4 quantization (the W4A8 path), with the
    group, amax and scale computation of ``weight_fake_quant``. Values lie
    in the restricted range [-7, 7] (``qrange``): the packed format could
    hold -8, the quantizers never emit it. w: (d_in, d_out). Returns (wq
    int8 (d_in, d_out), scale (n_groups, d_out) in w's dtype, group)."""
    d_in, d_out = w.shape
    g = cfg.w_group if cfg.w_group and d_in % cfg.w_group == 0 else d_in
    wg = w.reshape(d_in // g, g, d_out)
    amax = wg.abs().amax(dim=-2, keepdim=True)                  # (G, 1, N)
    scale, zero = params_from_minmax(-amax, amax, 4, True)
    wq = quantize(wg, scale, zero, 4, True).to(torch.int8)
    return wq.reshape(d_in, d_out), scale[:, 0, :], g


def pack_int4(wq: Tensor) -> Tensor:
    """Pack int4 values (int8 storage, [-8, 7]) along axis 0, two per byte:
    element 2i in the LOW nibble of byte i, 2i+1 in the HIGH nibble. An odd
    axis gets a zero nibble of padding (``unpack_int4(p, k)`` slices it
    off). Returns int8 (ceil(K/2), ...)."""
    if wq.shape[0] % 2:
        wq = torch.cat([wq, wq.new_zeros((1,) + tuple(wq.shape[1:]))])
    lo = wq[0::2].view(torch.uint8) & 0xF
    hi = wq[1::2].view(torch.uint8) & 0xF
    return (lo | (hi << 4)).view(torch.int8)


# ---------------------------------------------------------------------------
# Quantized linear
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SiteScale:
    """Calibrated static range for one activation site."""
    scale: Tensor
    zero: Tensor


def _f32(t) -> Tensor:
    return t if t.dtype == torch.float32 else t.float()


def _weight_scale(t: Tensor) -> Tensor:
    """A weight scale as the int matmuls read it: f32 and bf16 as stored,
    any other dtype converted (exactly) to f32."""
    return t if t.dtype in (torch.float32, torch.bfloat16) else t.float()


def _static_int_matmul(x: Tensor, w: Dict[str, Tensor], s_x: Tensor,
                       z_x: Tensor, cfg: QuantConfig,
                       row_parallel: bool = False) -> Tensor:
    """x quantized with a per-tensor scale and zero, times an int weight:
    ``w_int`` (int8, one scale, int32 ``colsum``; W8A8) or ``w_packed``
    (int4 nibbles, group-wise scales, scaled f32 ``colsum``; W4A8).

    Asymmetric 8-bit codes with f32 scales (always the case for calibrated
    scales) go through ``quant_w8a8_matmul`` / ``quant_w4a8_matmul``: on
    the card one launch at M <= 16, whose staging quantizes x, or
    ``act_quant_static`` and the matmul above; on the CPU their plain
    versions. The codes live in [0, 255] and are stored offset by -128, a
    shift that folds into the epilogue (z = z_x - 128); x / s + z is
    computed in f32, which is JAX's arithmetic whenever the scale and zero
    are f32. The epilogue:

      W8A8: (X_int @ W_int - z colsum) s_x s_w
      W4A8: s_x * (sum_g s_w[g] * (X_int[:, g] @ W_int[g]) - z colsum_scaled)

    The reference's W4A8 routes (a folded-scale f32 GEMM, the Pallas
    per-block accumulation) agree with each other to f32 accumulation, not
    bit for bit; this one sums exact per-group int32 partials in group
    order. A row-parallel site under tensor parallelism (W8A8, 8-bit
    asymmetric codes) takes the int32 accumulator of its shard, sums it
    over the ranks and applies the epilogue once, with ``w["colsum"]`` the
    whole weight's; a row-parallel W4A8 site (its packed rows cut by whole
    groups, ``w_scale`` whole on every rank, as the reference keeps it)
    takes its groups' scales and the kernel's f32 accumulator, sums that
    over the ranks in f32 and applies ``s_x (sum - z colsum_scaled)`` once.
    Dynamic ranges of a bf16 activation stay bf16 (``pt_dynamic``
    under true int8): the codes are then ``quantize``'s tensor ops in bf16,
    as the reference computes them with jnp outside its kernels, and the
    int matmul runs on them. Symmetric or narrower codes have no kernel:
    those take tensor ops on the CPU and raise elsewhere."""
    K = x.shape[-1]
    lead = x.shape[:-1]
    packed = "w_packed" in w
    N = (w["w_packed"] if packed else w["w_int"]).shape[-1]
    tp = DC.tp_size() if row_parallel else 1
    G = w["w_scale"].shape[0] if packed else 1
    if (K * tp) % G:
        raise ValueError(f"groups ({G}) must tile the contracting dim "
                         f"({K * tp})")
    gsize = K * tp // G
    if packed and K % gsize:
        raise NotImplementedError(
            f"W4A8 groups of {gsize} rows straddle a rank's {K} rows of "
            f"the contracting axis: not sharded {_TP_LATER}")
    od = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    s_w = _weight_scale(w["w_scale"])
    x2 = x.reshape(-1, K)
    kernel_codes = (not cfg.symmetric_a and cfg.a_bits == 8
                    and s_x.dtype == torch.float32
                    and z_x.dtype == torch.float32)
    off = 0 if cfg.symmetric_a else 2 ** (cfg.a_bits - 1)
    if tp > 1:
        if cfg.symmetric_a or cfg.a_bits != 8:
            raise NotImplementedError(
                "a row-parallel site shards 8-bit asymmetric activation "
                f"codes only {_TP_LATER}")
        if kernel_codes:
            xa, z_shift = x2.contiguous(), -128.0
        else:
            xa = (quantize(x2, s_x, z_x, 8, False) - off).to(torch.int8)
            xa, z_shift = xa.contiguous(), -float(off)
        s1, z1 = _f32(s_x).reshape(()), _f32(z_x).reshape(())
        if packed:
            n_g = K // gsize
            r = DC.tp_rank()
            mine = s_w[r * n_g:(r + 1) * n_g].contiguous()
            run = quant_w4a8_matmul if kernel_codes else w4a8_matmul
            acc = run(xa, w["w_packed"], s1, z1, mine, None, gsize,
                      accumulate=True)
            out = w4a8_epilogue(DC.psum(acc), s1, z1, _f32(w["colsum"]),
                                z_shift, od)
        else:
            acc = (quant_w8a8_matmul(xa, w["w_int"], s1, z1, s_w, None,
                                     out_dtype=torch.int32) if kernel_codes
                   else w8a8_matmul(xa, w["w_int"], s1, z1, s_w,
                                    out_dtype=torch.int32))
            out = w8a8_epilogue(DC.psum(acc), s1, z1, s_w, w["colsum"],
                                z_shift, od)
        return out.reshape(*lead, N).to(x.dtype)
    if kernel_codes:
        x2 = x2.contiguous()
        if packed:
            out = quant_w4a8_matmul(x2, w["w_packed"], s_x, z_x, s_w,
                                    _f32(w["colsum"]), gsize, out_dtype=od)
        else:
            out = quant_w8a8_matmul(x2, w["w_int"], s_x, z_x, s_w,
                                    w["colsum"], out_dtype=od)
        return out.reshape(*lead, N).to(x.dtype)
    if x.device.type != "cpu" and (cfg.symmetric_a or cfg.a_bits != 8):
        raise ValueError(
            "the int matmuls take asymmetric 8-bit codes; got "
            f"a_bits={cfg.a_bits}, symmetric={cfg.symmetric_a}: that "
            "combination runs on the CPU only")
    xq = (quantize(x2, s_x, z_x, cfg.a_bits, cfg.symmetric_a)
          - off).to(torch.int8)
    if packed:
        out = w4a8_matmul(xq, w["w_packed"], _f32(s_x), _f32(z_x), s_w,
                          _f32(w["colsum"]), gsize, z_shift=-float(off),
                          out_dtype=od)
    else:
        out = w8a8_matmul(xq, w["w_int"], _f32(s_x), _f32(z_x), s_w,
                          colsum=w["colsum"], z_shift=-float(off),
                          out_dtype=od)
    return out.reshape(*lead, N).to(x.dtype)


def _ptoken_int_matmul(x: Tensor, wq: Tensor, s_w: Tensor, s_x: Tensor,
                       z_x: Tensor, cfg: QuantConfig,
                       colsum: Optional[Tensor] = None,
                       row_parallel: bool = False) -> Tensor:
    """x quantized with per-row scales and zeros ((..., 1) each), times the
    int8 weight, in the reference's arithmetic (``_int8_matmul``'s plain
    path): codes by ``quantize`` in x's dtype with the -2^(b-1) storage
    offset, the exact int32 product, then ``f32(acc) - z_x colsum`` times
    ``s_x s_w`` per row. The product runs through ``w8a8_matmul`` (the
    kernel on the card, its plain version on the CPU) with unit scales and
    a zero point of 0, so its epilogue returns ``f32(acc)`` exactly; the
    per-row epilogue follows as tensor ops. ``row_parallel`` (under tp):
    x and ``wq`` are the rank's part of the contracting axis, s_x / z_x the
    rows' ranks-wide parameters, ``colsum`` the whole weight's; the ranks'
    int32 accumulators are summed (exact) before the epilogue."""
    K = x.shape[-1]
    lead = x.shape[:-1]
    N = wq.shape[-1]
    off = 0 if cfg.symmetric_a else 2 ** (cfg.a_bits - 1)
    xq = (quantize(x, s_x, z_x, cfg.a_bits, cfg.symmetric_a)
          - off).to(torch.int8)
    z = (z_x - off).reshape(-1, 1).float()
    if colsum is None:
        colsum = wq.sum(0, dtype=torch.int32)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    if row_parallel:
        acc = DC.psum(w8a8_matmul(xq.reshape(-1, K).contiguous(),
                                  wq.contiguous(), one, torch.zeros_like(one),
                                  one, out_dtype=torch.int32)).float()
    else:
        acc = w8a8_matmul(xq.reshape(-1, K).contiguous(), wq.contiguous(),
                          one, torch.zeros_like(one), one, colsum=colsum)
    out = (acc - z * colsum.float()) \
        * (s_x.reshape(-1, 1).float() * s_w.float())
    return out.reshape(*lead, N).to(x.dtype)


def true_int_dot(x: Tensor, w: Tensor, cfg: QuantConfig,
                 site: Optional[SiteScale],
                 row_parallel: bool = False,
                 rng: Optional[Tuple] = None) -> Tensor:
    """int8 x int8 -> int32 matmul with the dequant in its epilogue; the
    weight is quantized on every call (``prequantized_int_dot`` is the
    int8-resident variant). A per-tensor range (``pt_static``,
    ``pt_dynamic``) takes the scalar epilogue of ``_static_int_matmul``,
    ``ptoken_dynamic``'s per-row ranges the per-row one of
    ``_ptoken_int_matmul``. A rank's shard is quantized with the whole
    weight's range; a row-parallel shard's ``colsum`` is summed over the
    ranks, and its dynamic range is the ranks' (``act_minmax``)."""
    wq, s_w = weight_quant_int(w, cfg)
    tp = row_parallel and DC.tp_size() > 1
    if cfg.mode == "pt_static":
        if site is None:
            raise ValueError("pt_static needs a calibrated site scale")
        s_x, z_x = site.scale, site.zero
    else:
        mn, mx = rng if (rng is not None and cfg.mode == "pt_dynamic"
                         and not tp) else \
            act_minmax(x, cfg.mode == "ptoken_dynamic", 1, row_parallel)
        s_x, z_x = params_from_minmax(mn, mx, cfg.a_bits, cfg.symmetric_a)
    colsum = wq.sum(0, dtype=torch.int32)
    if row_parallel:
        colsum = DC.psum(colsum)
    if cfg.mode == "ptoken_dynamic":
        return _ptoken_int_matmul(x, wq, s_w, s_x, z_x, cfg, colsum, tp)
    return _static_int_matmul(
        x, {"w_int": wq.contiguous(), "w_scale": s_w, "colsum": colsum},
        s_x, z_x, cfg, row_parallel)


def prequantized_int_dot(x: Tensor, w: Dict[str, Tensor], cfg: QuantConfig,
                         site: Optional[SiteScale],
                         row_parallel: bool = False) -> Tensor:
    """Serving path with integer-resident weights; needs calibrated static
    scales. Two formats, told apart by key: ``w_int`` (int8, W8A8) and
    ``w_packed`` (int4 nibbles, group-wise scales, W4A8), both through
    ``_static_int_matmul``. Activations are int8 in both."""
    if cfg.mode != "pt_static" or site is None:
        raise ValueError(
            "prequantized (int8-resident) weights serve the pt_static "
            "deployment path only and need calibrated site scales; got "
            f"mode={cfg.mode!r}, site={'set' if site is not None else None}")
    return _static_int_matmul(x, w, site.scale, site.zero, cfg, row_parallel)


def prequantize(w: Tensor, cfg: QuantConfig,
                weight_bits: int = 8) -> Dict[str, Tensor]:
    """Quantize one (d_in, d_out) weight into its resident serving dict.

    weight_bits=8: {"w_int" int8 (K, N), "w_scale" scalar, "colsum"
    (N,) int32}. weight_bits=4: {"w_packed" int8 (ceil(K/2), N) nibble
    pairs, "w_scale" (G, N) group scales, "colsum" (N,) f32 *scaled*
    column sums sum_g s_w[g, n] colsum_g[n]}. Scales keep the weight's
    dtype, as in JAX; the kernels read them as they are stored."""
    if weight_bits == 4:
        wq, scale, g = weight_quant_int4(w, cfg)
        G = w.shape[0] // g
        colsum_g = wq.to(torch.int32).reshape(G, g, -1).sum(1)    # (G, N)
        colsum = (colsum_g.float() * scale).sum(0)
        return {"w_packed": pack_int4(wq), "w_scale": scale,
                "colsum": colsum}
    if weight_bits != 8:
        raise ValueError(f"weight_bits must be 8 or 4, got {weight_bits}")
    wq, scale = weight_quant_int(w, cfg)
    return {"w_int": wq.contiguous(), "w_scale": scale,
            "colsum": wq.sum(0, dtype=torch.int32)}


_PREQUANT_KEYS = ("wqkv", "wo", "w_up", "w_gate", "w_down", "w_in", "w_out",
                  "w_proj")


def prequantize_tree(params: Any, cfg: QuantConfig, min_ndim: int = 2,
                     weight_bits: int = 8) -> Any:
    """Replace qdot-consumed weight matrices (stacked over layers or not)
    with integer-resident dicts (int8 ``w_int`` or, with ``weight_bits=4``,
    nibble-packed ``w_packed``); stacked ``(L, ...)`` leaves are quantized
    one layer at a time and stacked again. Lists of dicts (the hybrid's
    sublayers) are walked as the reference walks them. Embeddings and
    every ``moe`` leaf stay fp."""
    if weight_bits not in (8, 4):
        raise ValueError(f"weight_bits must be 8 or 4, got {weight_bits}")

    def eligible(k, v, path):
        if not (isinstance(v, torch.Tensor) and v.dim() >= min_ndim):
            return False
        if "embed" in path or "moe" in path:
            return False
        if k in _PREQUANT_KEYS:
            return True
        return k == "w" and bool(path) and path[-1] == "head"

    def convert(v):
        if v.dim() == 2:
            return prequantize(v, cfg, weight_bits)
        parts = [prequantize(a, cfg, weight_bits) for a in v.unbind(0)]
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}

    def visit(d, path=()):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = visit(v, path + (k,))
            elif isinstance(v, (list, tuple)):
                out[k] = [visit(e, path + (k, i)) if isinstance(e, dict)
                          else e for i, e in enumerate(v)]
            elif eligible(k, v, path):
                out[k] = convert(v)
            else:
                out[k] = v
        return out
    return visit(params)


def _sum_rows(y: Tensor) -> Tensor:
    """A row-parallel site's partial products summed over the ranks, in
    f32, rounded once to y's dtype."""
    if DC.tp_size() == 1:
        return y
    return DC.psum(y.float()).to(y.dtype)


def qdot(x: Tensor, w: Any, cfg: QuantConfig,
         site: Optional[SiteScale] = None, groups: int = 1,
         row_parallel: bool = False, rng: Optional[Tuple] = None) -> Tensor:
    """Quantized x @ w. ``w`` is (d_in, d_out) or a prequantized dict.
    ``groups`` > 1: x stacks that many independent tensors along its
    leading axis, each fake-quantized with its own dynamic range (the
    integer paths take one range and refuse it). ``row_parallel``: under
    tensor parallelism x and w are the rank's shards of the contracting
    axis, and the ranks' partial products are summed (see the module
    docstring); it changes nothing on one rank. ``rng``: x's per-tensor
    (min, max) for a dynamic range, where the caller has it."""
    if isinstance(w, dict):
        if groups > 1:
            raise ValueError("integer-resident weights serve one tensor "
                             "at a time (groups=1)")
        return prequantized_int_dot(x, w, cfg, site, row_parallel)
    if cfg.mode == "none":
        y = x @ w
        return _sum_rows(y) if row_parallel else y
    if cfg.true_int8 and w.dim() == 2 and cfg.a_bits == 8 and cfg.w_bits == 8:
        if groups > 1 and cfg.mode != "pt_static":
            raise ValueError("the true int8 matmul takes one dynamic range "
                             "(groups=1)")
        return true_int_dot(x, w, cfg, site, row_parallel, rng)
    xq = act_fake_quant(x, cfg, site.scale if site is not None else None,
                        site.zero if site is not None else None, groups, rng,
                        row_parallel)
    y = xq @ weight_fake_quant(w, cfg, row_parallel)
    return _sum_rows(y) if row_parallel else y


# ---------------------------------------------------------------------------
# Quantization error L_q, eq. (6), + site statistics for calibration
# ---------------------------------------------------------------------------

def site_qerr(x: Tensor, cfg: QuantConfig, site: Optional[SiteScale],
              n_skip: int = 0, groups: int = 1,
              rng: Optional[Tuple] = None, cut: bool = False) -> Tensor:
    """||X - q(X)||^2 over the token part (positions >= n_skip): a scalar
    (the global batch's under a data axis), or with ``groups`` > 1 one
    value per stacked tensor, (groups,). ``rng``: the token part's
    per-tensor (min, max), where the caller has it. ``cut``: x's last axis
    is the rank's slice of a tensor-parallel cut, and the ranks' partial
    sums are summed (the range is the ranks')."""
    cut = cut and DC.tp_size() > 1
    if cut and groups > 1:
        raise ValueError("stacked groups (the search's candidates) run on "
                         "one rank")
    if n_skip:
        x = x[..., n_skip:, :]
    if cfg.mode == "pt_static" and site is not None:
        scale, zero = site.scale, site.zero
    elif rng is not None and cfg.mode != "ptoken_dynamic":
        scale, zero = params_from_minmax(*rng, cfg.a_bits, cfg.symmetric_a)
    else:
        mn, mx = act_minmax(x.detach(), cfg.mode == "ptoken_dynamic", groups,
                            cut)
        scale, zero = params_from_minmax(mn, mx, cfg.a_bits, cfg.symmetric_a)
    scale, zero = scale.detach(), zero.detach()
    xq = dequantize(quantize(x, scale, zero, cfg.a_bits, cfg.symmetric_a),
                    scale, zero)
    err = torch.sub(*_promote(x, xq)).float().square()
    if groups > 1:
        return err.reshape(groups, -1).sum(1)
    err = DC.global_sum(err.sum())
    return DC.psum(err) if cut else err


def site_stats(x: Tensor, n_skip: int = 0, cut: bool = False
               ) -> Dict[str, Tensor]:
    """A site's range (differentiable: the range penalty of prefix tuning
    reads it) and per-channel absmax, over the global batch under a data
    axis and, with ``cut`` (x's last axis is the rank's slice of a
    tensor-parallel cut), over the ranks' channels."""
    if n_skip:
        x = x[..., n_skip:, :]
    amin, amax, absmax_ch = DC.global_site_stats(x.float(), cut)
    return {"amin": amin, "amax": amax, "absmax_ch": absmax_ch}


def site_taps(x: Tensor, cfg: QuantConfig, site: Optional[SiteScale],
              n_skip: int = 0, groups: int = 1, cut: bool = False):
    """A site's taps, ``{"qerr", "amin", "amax", "absmax_ch"}``, and x's
    per-tensor (min, max) for the site's quantizer (``qdot(..., rng=)``),
    or None. The statistics' range serves L_q's range and the quantizer's:
    they are the same values (a min and a max are exact in x's dtype), so
    a site takes its range once (one all-reduce under a data axis).
    ``cut``: the input of a row-parallel site under tensor parallelism,
    whose statistics and L_q are the ranks' (``site_stats``,
    ``site_qerr``)."""
    stats = site_stats(x, n_skip, cut)
    rng = None
    if groups == 1:
        rng = (stats["amin"].detach().to(x.dtype),
               stats["amax"].detach().to(x.dtype))
    taps = {"qerr": site_qerr(x, cfg, site, n_skip, groups, rng, cut),
            **stats}
    return taps, (rng if not n_skip else None)


def _is_site(d) -> bool:
    return isinstance(d, dict) and "amin" in d


def _map_sites(fn, *trees):
    t0 = trees[0]
    if _is_site(t0):
        return fn(*trees)
    return {k: _map_sites(fn, *(t[k] for t in trees)) for k in t0}


def scales_from_stats(stats: Any, cfg: QuantConfig) -> Any:
    """{amin, amax, absmax_ch} site leaves -> SiteScale leaves."""
    def one(site):
        scale, zero = params_from_minmax(site["amin"], site["amax"],
                                         cfg.a_bits, cfg.symmetric_a)
        return SiteScale(scale=scale, zero=zero)
    return _map_sites(one, stats)


def merge_stats(a: Any, b: Any) -> Any:
    """Running union of two stats trees (min of mins, max of maxes)."""
    if a is None:
        return b

    def one(sa, sb):
        return {"amin": torch.minimum(sa["amin"], sb["amin"]),
                "amax": torch.maximum(sa["amax"], sb["amax"]),
                "absmax_ch": torch.maximum(sa["absmax_ch"], sb["absmax_ch"])}
    return _map_sites(one, a, b)
