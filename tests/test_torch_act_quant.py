"""The port's activation quantizers on the CPU.

* The serving path's one call per site, ``quant_w8a8_matmul`` /
  ``quant_w4a8_matmul``: on the card the static quantizer runs inside the
  int matmul's A staging at M <= 16 and as ``act_quant_static`` above; on
  the CPU both routes are their plain version, ``act_quant_static_plain``
  followed by the matmul's plain version. That composition is held bit for
  bit to itself, to the model entries (``prequantized_int_dot``,
  ``true_int_dot``) and to JAX's Pallas ``act_quant_static`` followed by
  its ``w8a8_matmul`` / ``w4a8_matmul`` (interpret mode), for M in
  {1, 4, 16, 17} (both sides of the fused route's 16 rows), f32 and bf16
  x, and bf16 and f32 ``s_w``.
* The hypothesis properties of ``tests/test_quantization.py``, held by the
  port: the round-trip error is within scale/2 inside the clip range,
  fake-quant is idempotent, ``act_quant_static_plain`` and
  ``act_quant_ptoken_plain`` always give codes in [-128, qmax - 128], and
  both agree with JAX on the same numpy inputs.

Tolerances: codes bit-exact everywhere; the W8A8 output bit-exact against
the composition, the model entries and Pallas; the W4A8 output bit-exact against the composition, within rtol
1e-4, atol 1e-3 of Pallas (queue 3: the reference's own bar between its
routes, which sum the group products in another order); the round trip
within scale/2 + 1e-4 (the bar of ``tests/test_quantization.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import quantization as JQ  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.kernels.act_quant import act_quant_static as j_act_quant  # noqa: E402
from repro.kernels.w4a8_matmul import w4a8_matmul as j_w4a8  # noqa: E402
from repro.kernels.w8a8_matmul import w8a8_matmul as j_w8a8  # noqa: E402
from repro_torch.configs import QuantConfig  # noqa: E402
from repro_torch.core import quantization as TQ  # noqa: E402
from repro_torch.kernels.act_quant import (  # noqa: E402
    act_quant_ptoken, act_quant_ptoken_plain, act_quant_static,
    act_quant_static_plain)
from repro_torch.kernels.w4a8_matmul import (  # noqa: E402
    quant_w4a8_matmul, quant_w4a8_matmul_plain, w4a8_matmul_plain)
from repro_torch.kernels.w8a8_matmul import (  # noqa: E402
    quant_w8a8_matmul, quant_w8a8_matmul_plain, w8a8_matmul_plain)

try:
    import hypothesis
    import hypothesis.extra.numpy as hnp
    import hypothesis.strategies as st
except ImportError:     # pragma: no cover
    hypothesis = hnp = st = None

QW8 = QuantConfig(mode="pt_static", true_int8=True)
S_X, Z_X = np.float32(0.031), np.float32(111.0)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tt(a):
    return torch.from_numpy(np.array(a))


def _x(M, K, seed):
    """An activation that clips at both ends of the (S_X, Z_X) range."""
    return (np.random.RandomState(seed).randn(M, K) * 3 + 0.3) \
        .astype(np.float32)


def _x_pair(M, K, seed, xdt):
    """The same values as a torch tensor and a jax array of dtype xdt."""
    xj = jnp.asarray(_x(M, K, seed)).astype(xdt)
    return tt(np.asarray(xj.astype(jnp.float32))).to(DTYPES[xdt]), xj


@pytest.mark.parametrize("sw_dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 16, 17])
def test_quant_w8a8_matches_composition_and_pallas(M, xdt, sw_dt):
    K, N = 256, 256
    rs = np.random.RandomState(M)
    w = rs.randint(-127, 128, (K, N)).astype(np.int8)
    colsum = w.astype(np.int32).sum(0)
    s_w = jnp.asarray(0.0042, sw_dt)
    tx, jx = _x_pair(M, K, M + 1, xdt)
    tsw = torch.tensor(float(s_w)).to(DTYPES[sw_dt])
    sx, zx = tt(S_X), tt(Z_X)
    got = quant_w8a8_matmul(tx, tt(w), sx, zx, tsw, tt(colsum))
    codes = act_quant_static_plain(tx, sx, zx)
    comp = w8a8_matmul_plain(codes, tt(w), sx, zx, tsw, tt(colsum),
                             z_shift=-128.0)
    assert torch.equal(got, comp)
    assert torch.equal(got, quant_w8a8_matmul_plain(tx, tt(w), sx, zx, tsw))
    # the model entry, on a (1, M, K) activation (it returns x's dtype)
    site = TQ.SiteScale(sx, zx)
    ent = TQ.prequantized_int_dot(
        tx[None], {"w_int": tt(w), "w_scale": tsw, "colsum": tt(colsum)},
        QW8, site)
    want = quant_w8a8_matmul(tx, tt(w), sx, zx, tsw, tt(colsum),
                             out_dtype=DTYPES[xdt])
    assert torch.equal(ent[0], want.to(DTYPES[xdt]))
    # JAX: the Pallas quantizer, then the Pallas matmul on its codes
    jcodes = j_act_quant(jx, S_X, Z_X, interpret=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    pallas = j_w8a8(jcodes, jnp.asarray(w), S_X, Z_X - 128, s_w,
                    bn=128, bk=128, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("sw_dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 16, 17])
def test_quant_w4a8_matches_composition_and_pallas(M, xdt, sw_dt):
    K, N, group = 256, 128, 64
    rs = np.random.RandomState(100 + M)
    wq = rs.randint(-7, 8, (K, N)).astype(np.int8)
    packed = np.array(JQ.pack_int4(jnp.asarray(wq)))
    s_w = jnp.asarray(rs.rand(K // group, N) * 0.02 + 1e-3, sw_dt)
    colsum = np.asarray(
        (jnp.asarray(wq.astype(np.int32).reshape(K // group, group, N)
                     .sum(1), jnp.float32) * s_w).sum(0), np.float32)
    tsw = tt(np.asarray(s_w, np.float32)).to(DTYPES[sw_dt])
    tx, jx = _x_pair(M, K, M + 2, xdt)
    sx, zx = tt(S_X), tt(Z_X)
    got = quant_w4a8_matmul(tx, tt(packed), sx, zx, tsw, tt(colsum), group)
    codes = act_quant_static_plain(tx, sx, zx)
    comp = w4a8_matmul_plain(codes, tt(packed), sx, zx, tsw, tt(colsum),
                             group, z_shift=-128.0)
    assert torch.equal(got, comp)
    assert torch.equal(got, quant_w4a8_matmul_plain(
        tx, tt(packed), sx, zx, tsw, tt(colsum), group))
    ent = TQ.prequantized_int_dot(
        tx[None], {"w_packed": tt(packed), "w_scale": tsw,
                   "colsum": tt(colsum)}, QW8, TQ.SiteScale(sx, zx))
    want = quant_w4a8_matmul(tx, tt(packed), sx, zx, tsw, tt(colsum), group,
                             out_dtype=DTYPES[xdt])
    assert torch.equal(ent[0], want.to(DTYPES[xdt]))
    jcodes = j_act_quant(jx, S_X, Z_X, interpret=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    pallas = j_w4a8(jcodes, jnp.asarray(packed), S_X, Z_X - 128, s_w,
                    jnp.asarray(colsum), group_size=group, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("lead", [(3,), (2, 9)])
def test_true_int_dot_is_the_quantizing_matmul(lead):
    """``true_int_dot`` (the weight quantized per call) goes through the
    same entry: its result is ``quant_w8a8_matmul`` on the flattened
    activation and the per-call int8 weight."""
    x = tt((np.random.RandomState(5).randn(*lead, 64) * 2).astype(
        np.float32))
    w = tt((np.random.RandomState(6).randn(64, 40) * 0.1).astype(
        np.float32))
    site = TQ.SiteScale(torch.tensor(0.02), torch.tensor(120.0))
    got = TQ.true_int_dot(x, w, QW8, site)
    wq, s_w = TQ.weight_quant_int(w, QW8)
    want = quant_w8a8_matmul(x.reshape(-1, 64), wq, site.scale, site.zero,
                             s_w, wq.sum(0, dtype=torch.int32))
    assert torch.equal(got, want.reshape(*lead, 40))


if hypothesis is not None:
    # derandomized: the same examples in every run and on every worker
    settings = hypothesis.settings(max_examples=25, deadline=None,
                                   derandomize=True)
    floats = st.floats(min_value=-1e3, max_value=1e3, allow_nan=False,
                       width=32)
    def f32(v):
        return float(np.float32(v))

    wide = st.floats(min_value=f32(-3e38), max_value=f32(3e38),
                     allow_nan=False,
                     allow_infinity=False, width=32)

    @settings
    @hypothesis.given(hnp.arrays(np.float32,
                                 hnp.array_shapes(min_dims=2, max_dims=3,
                                                  max_side=16),
                                 elements=floats),
                      st.sampled_from([4, 6, 8]),
                      st.booleans())
    def test_quant_roundtrip_error_bound(x, bits, symmetric):
        """|x - dq(q(x))| <= scale/2 elementwise within the clip range,
        through the port's ``quantize`` / ``dequantize`` and, for 8-bit
        asymmetric codes, through ``act_quant_static_plain``'s codes."""
        xt = tt(x)
        mn, mx = TQ.act_minmax(xt, per_token=False)
        scale, zero = TQ.params_from_minmax(mn, mx, bits, symmetric)
        xq = TQ.dequantize(TQ.quantize(xt, scale, zero, bits, symmetric),
                           scale, zero)
        qlo, qhi = TQ.qrange(bits, symmetric)
        lo = TQ.dequantize(torch.tensor(float(qlo)), scale, zero)
        hi = TQ.dequantize(torch.tensor(float(qhi)), scale, zero)
        inside = (xt >= lo) & (xt <= hi)
        err = (xt - xq).abs()
        assert bool((err[inside] <= float(scale) / 2 + 1e-4).all())
        if bits == 8 and not symmetric:
            codes = act_quant_static_plain(xt.reshape(-1, x.shape[-1]),
                                           scale, zero).reshape(x.shape)
            dq = TQ.dequantize(codes.float() + 128, scale, zero)
            err = (xt - dq).abs()
            assert bool((err[inside] <= float(scale) / 2 + 1e-4).all())

    @settings
    @hypothesis.given(hnp.arrays(np.float32, (8, 16), elements=floats),
                      st.sampled_from([6, 8]))
    def test_fake_quant_idempotent(x, bits):
        """The port's ``fake_quant`` twice is ``fake_quant`` once, and the
        static kernel's codes of its own dequantized codes are the same
        codes."""
        xt = tt(x)
        mn, mx = TQ.act_minmax(xt, per_token=False)
        scale, zero = TQ.params_from_minmax(mn, mx, bits, False)
        y1 = TQ.fake_quant(xt, scale, zero, bits, False)
        y2 = TQ.fake_quant(y1, scale, zero, bits, False)
        np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-5,
                                   atol=1e-5)
        if bits == 8:
            c1 = act_quant_static_plain(xt, scale, zero)
            y = TQ.dequantize(c1.float() + 128, scale, zero)
            assert torch.equal(act_quant_static_plain(y, scale, zero), c1)

    @settings
    @hypothesis.given(hnp.arrays(np.float32,
                                 hnp.array_shapes(min_dims=2, max_dims=2,
                                                  max_side=16),
                                 elements=wide),
                      st.floats(min_value=f32(1e-30), max_value=f32(1e30), width=32),
                      st.integers(min_value=0, max_value=255),
                      st.sampled_from([4, 8]),
                      st.sampled_from(["float32", "bfloat16"]))
    def test_codes_in_range(x, s, z, bits, dtype):
        """Codes in [-128, qmax - 128] for any finite input and scale: the
        clip comes before the int8 storage, so nothing wraps."""
        xt = tt(x).to(DTYPES[dtype])
        c = act_quant_static(xt, torch.tensor(s, dtype=torch.float32),
                             torch.tensor(float(z)))
        assert c.dtype == torch.int8
        assert int(c.min()) >= -128 and int(c.max()) <= 127
        # a row's range must stay finite: mx - mn of values up to 3e38
        # would overflow f32 in the reference as here
        q, sc, zp = act_quant_ptoken(xt / 4, bits=bits)
        assert int(q.min()) >= -128 and int(q.max()) <= 2 ** bits - 1 - 128
        assert bool((sc > 0).all()) and bool(torch.isfinite(sc).all())
        assert bool((zp >= 0).all()) and bool((zp <= 2 ** bits - 1).all())

    @settings
    @hypothesis.given(hnp.arrays(np.float32, (8, 16), elements=floats),
                      st.floats(min_value=f32(1e-3), max_value=10.0, width=32),
                      st.integers(min_value=0, max_value=255),
                      st.sampled_from([4, 8]))
    def test_quantizers_agree_with_jax(x, s, z, bits):
        """On the same numpy input: the static codes equal JAX's Pallas
        kernel (interpret mode) and ``ref.act_quant_static_ref`` for f32
        and bf16 x; the per-token codes, scales and zero points equal
        ``ref.act_quant_ref(per_token=True)`` on f32 x and JAX's
        ``params_from_minmax`` and ``quantize`` on bf16 x, on every row
        whose bf16 scale is a normal number."""
        s, z = np.float32(s), np.float32(z)
        for dt in ("float32", "bfloat16"):
            xj = jnp.asarray(x).astype(dt)
            xt = tt(np.asarray(xj.astype(jnp.float32))).to(DTYPES[dt])
            got = act_quant_static_plain(xt, tt(s), tt(z)).numpy()
            np.testing.assert_array_equal(
                got, np.asarray(j_act_quant(xj, s, z, interpret=True)))
            np.testing.assert_array_equal(
                got, np.asarray(R.act_quant_static_ref(
                    xj.astype(jnp.float32), s, z)))
        q, sc, zp = act_quant_ptoken_plain(tt(x), bits=bits)
        for g, w in zip((q, sc, zp), R.act_quant_ref(jnp.asarray(x),
                                                     bits=bits,
                                                     per_token=True)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        js, jz = JQ.params_from_minmax(*JQ.act_minmax(xb, True), bits,
                                       False)
        jq = JQ.quantize(xb, js, jz, bits, False)
        xbf = np.asarray(xb.astype(jnp.float32))
        q, sc, zp = act_quant_ptoken_plain(tt(xbf).to(torch.bfloat16),
                                           bits=bits)
        # rows whose bf16 scale is subnormal: XLA on the CPU flushes it to
        # zero (and then takes scale 1), PyTorch and the card keep it
        # (ROADMAP queue 3); every other row is held bit for bit
        rng = np.maximum(xbf.max(-1), 0) - np.minimum(xbf.min(-1), 0)
        normal = ~((rng > 0) & (rng / (2 ** bits - 1)
                                < np.finfo(np.float32).tiny))
        np.testing.assert_array_equal(
            (q.numpy().astype(np.float32) + 128)[normal],
            np.asarray(jq, np.float32)[normal])
        np.testing.assert_array_equal(sc.numpy()[normal],
                                      np.asarray(js, np.float32)[normal])
        np.testing.assert_array_equal(zp.numpy()[normal],
                                      np.asarray(jz, np.float32)[normal])
