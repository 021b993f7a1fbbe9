"""Port parity, kernel level: each kernel module's plain PyTorch version
(what the wrapper runs on a CPU tensor) against the JAX Pallas kernel in
interpret mode and against ``repro/kernels/ref.py``, on the same numpy
inputs.

Tolerances: int8 codes and int32 products bit-exact; the w8a8 f32 epilogue
within 1 ulp (XLA may contract the zero-point multiply-subtract into an
FMA); attention in f32 within atol = rtol = 1e-5 (different reduction
order: the Pallas kernels fold keys block by block, the plain versions
densely).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as R  # noqa: E402
from repro.kernels.act_quant import act_quant_static as j_act_quant  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash_attn  # noqa: E402
from repro.kernels.flash_decode import flash_decode as j_flash_decode  # noqa: E402
from repro.kernels.w8a8_matmul import w8a8_matmul as j_w8a8  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.act_quant import (act_quant_static,  # noqa: E402
                                           act_quant_static_plain)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode  # noqa: E402
from repro_torch.kernels.w8a8_matmul import (int_product_exact,  # noqa: E402
                                             w8a8_matmul, w8a8_matmul_plain)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def f32(x):
    return torch.tensor(x, dtype=torch.float32)


@pytest.mark.parametrize("M,K,N", [(4, 256, 384), (37, 2048, 128),
                                   (300, 128, 256)])
def test_w8a8_plain_matches_pallas_and_ref(M, K, N):
    rs = np.random.RandomState(M + K)
    x = rs.randint(-128, 128, (M, K)).astype(np.int8)
    w = rs.randint(-127, 128, (K, N)).astype(np.int8)
    s_x, z_x, s_w = np.float32(0.031), np.float32(-17.0), np.float32(0.0042)
    # int32 product exact (K = 2048 crosses the 1024-chunk boundary)
    exact = x.astype(np.int64) @ w.astype(np.int64)
    np.testing.assert_array_equal(int_product_exact(t(x), t(w)).numpy(),
                                  exact)
    colsum = t(w.astype(np.int32).sum(0))
    ours = w8a8_matmul(t(x), t(w), f32(s_x), f32(z_x), f32(s_w), colsum)
    plain = w8a8_matmul_plain(t(x), t(w), f32(s_x), f32(z_x), f32(s_w))
    np.testing.assert_array_equal(ours.numpy(), plain.numpy())
    pallas = j_w8a8(jnp.asarray(x), jnp.asarray(w), s_x, z_x, s_w,
                    bn=128, bk=128, interpret=True)
    ref = R.w8a8_matmul_ref(jnp.asarray(x), jnp.asarray(w), s_x, z_x, s_w)
    np.testing.assert_array_max_ulp(ours.numpy(), np.asarray(pallas), 1)
    np.testing.assert_array_max_ulp(ours.numpy(), np.asarray(ref), 1)


def test_w8a8_z_shift_and_bf16_out():
    """z_shift folds the -128 storage offset: identical to passing z-128;
    the bf16 output is the f32 result rounded once."""
    rs = np.random.RandomState(1)
    x = t(rs.randint(-128, 128, (9, 64)).astype(np.int8))
    w = t(rs.randint(-127, 128, (64, 40)).astype(np.int8))
    a = w8a8_matmul(x, w, f32(0.02), f32(113.0), f32(0.01), z_shift=-128.0)
    b = w8a8_matmul(x, w, f32(0.02), f32(-15.0), f32(0.01))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    c = w8a8_matmul(x, w, f32(0.02), f32(-15.0), f32(0.01),
                    out_dtype=torch.bfloat16)
    assert torch.equal(c, b.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_quant_plain_matches_pallas_and_ref(dtype):
    rs = np.random.RandomState(3)
    x32 = (rs.randn(256, 96) * 4 + 1).astype(np.float32)
    x = jnp.asarray(x32).astype(dtype)
    s, z = np.float32(0.037), np.float32(101.0)
    xt = t(x32).to(getattr(torch, dtype))
    ours = act_quant_static(xt, f32(s), f32(z))
    assert ours.dtype == torch.int8
    np.testing.assert_array_equal(
        ours.numpy(), act_quant_static_plain(xt, f32(s), f32(z)).numpy())
    pallas = j_act_quant(x, s, z, bm=128, interpret=True)
    ref = R.act_quant_static_ref(x.astype(jnp.float32), s, z)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_act_quant_rounds_half_to_even():
    x = f32([0.5, 1.5, 2.5, -0.5, -1.5, 300.0, -300.0])
    out = act_quant_static(x[None], f32(1.0), f32(0.0))
    # codes round(x) clipped to [0, 255], stored -128
    assert out.tolist() == [[-128, -126, -126, -128, -128, 127, -128]]


# head_dim 16, and 80 (stablelm-3b's: no power of two)
@pytest.mark.parametrize("prefix,hd", [(0, 16), (3, 16), (0, 80), (3, 80)],
                         ids=["0", "3", "0-hd80", "3-hd80"])
def test_flash_attention_plain_matches_pallas_and_ref(prefix, hd):
    B, H, Kh, S = 2, 6, 2, 24
    T = S + prefix
    rs = np.random.RandomState(prefix)
    q = rs.randn(B, H, S, hd).astype(np.float32)
    k = rs.randn(B, Kh, T, hd).astype(np.float32)
    v = rs.randn(B, Kh, T, hd).astype(np.float32)
    ours = flash_attention(t(q), t(k), t(v), causal=True, prefix_len=prefix)
    pallas = j_flash_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, prefix_len=prefix, bq=8, bkv=8,
                          interpret=True)
    ref = R.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True,
                                prefix_len=prefix)
    for other in (pallas, ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(other),
                                   rtol=1e-5, atol=1e-5)
    # the model-level entry takes (B, S, H, hd) and returns the same
    o2 = ops.attention(t(q).transpose(1, 2), t(k).transpose(1, 2),
                       t(v).transpose(1, 2), prefix_len=prefix)
    np.testing.assert_allclose(o2.transpose(1, 2).numpy(), ours.numpy(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("mode,pos,hd", [
    ("fp", 41, 16), ("fp", [5, -1], 16), ("int8", 37, 16),
    ("int8", [2, 50], 16), ("fp", [5, -1], 80), ("int8", [2, 50], 80),
], ids=["fp-41", "fp-pos1", "int8-37", "int8-pos3", "fp-pos1-hd80",
        "int8-pos3-hd80"])
def test_flash_decode_plain_matches_pallas_and_ref(mode, pos, hd):
    """fp and int8+cushion caches; scalar and per-row pos, with a retired
    row (pos < 0) and a row whose pos is inside the cushion; head_dim 16
    and 80 (stablelm-3b's)."""
    B, K, G, Smax, m = 2, 2, 3, 64, 4
    rs = np.random.RandomState(len(str(pos)))
    q = rs.randn(B, K * G, hd).astype(np.float32)
    kw = {}
    tkw = {}
    if mode == "fp":
        k = rs.randn(B, Smax, K, hd).astype(np.float32)
        v = rs.randn(B, Smax, K, hd).astype(np.float32)
    else:
        k = rs.randint(-127, 128, (B, Smax, K, hd)).astype(np.int8)
        v = rs.randint(-127, 128, (B, Smax, K, hd)).astype(np.int8)
        ks = (rs.rand(K) * 0.05 + 0.01).astype(np.float32)
        vs = (rs.rand(K) * 0.05 + 0.01).astype(np.float32)
        kc = rs.randn(m, K, hd).astype(np.float32)
        vc = rs.randn(m, K, hd).astype(np.float32)
        kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                  kc=jnp.asarray(kc), vc=jnp.asarray(vc))
        tkw = dict(k_scale=t(ks), v_scale=t(vs), kc=t(kc), vc=t(vc))
    jpos = jnp.asarray(pos, jnp.int32)
    ours = flash_decode(t(q), t(k), t(v), torch.tensor(pos, dtype=torch.int32),
                        **tkw)
    pallas = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jpos, bkv=16, interpret=True, **kw)
    ref = R.flash_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jpos, **kw)
    for other in (pallas, ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(other),
                                   rtol=1e-5, atol=1e-5)
