"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: these need an NVIDIA card with ``nvcc`` and skip without
one (the fixture decides, never the module's import). On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_cuda.py     # on a machine without jax

Tolerances: w8a8_matmul, w4a8_matmul, act_quant_static and
act_quant_ptoken bit-exact (the kernels repeat the plain versions' f32 or
bf16-rounded arithmetic step by step); attention in bf16 within
one bf16 ulp of the plain version's f32-accumulated result; the paged
decode kernel bit-identical to the contiguous one on the gathered pool.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.act_quant import (  # noqa: E402
    act_quant_ptoken, act_quant_ptoken_plain, act_quant_static,
    act_quant_static_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.flash_decode import (  # noqa: E402
    flash_decode, flash_decode_paged, flash_decode_paged_plain,
    flash_decode_plain, gather_pages)
from repro_torch.kernels.w4a8_matmul import (w4a8_matmul,  # noqa: E402
                                             w4a8_matmul_plain)
from repro_torch.kernels.w8a8_matmul import (w8a8_matmul,  # noqa: E402
                                             w8a8_matmul_plain)

pytestmark = pytest.mark.cuda
BF16_ULP = 2.0 ** -7          # relative spacing bound of bf16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA unavailable)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _within_ulp(a, b):
    a, b = a.float(), b.float()
    assert bool(((a - b).abs() <= BF16_ULP * b.abs() + 1e-6).all()), \
        float((a - b).abs().max())


@pytest.mark.parametrize("M,K,N", [(4, 960, 1600), (37, 2560, 960),
                                   (300, 128, 100)])
def test_w8a8_kernel_bit_exact(dev, M, K, N):
    g = torch.Generator(dev).manual_seed(M)
    x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    sc = [torch.tensor(v, device=dev) for v in (0.031, 111.0, 0.0042)]
    for dt in (torch.float32, torch.bfloat16):
        a = w8a8_matmul(x, w, *sc, z_shift=-128.0, out_dtype=dt)
        b = w8a8_matmul_plain(x, w, *sc, z_shift=-128.0, out_dtype=dt)
        assert torch.equal(a, b)


def test_act_quant_kernel_bit_exact(dev):
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn((2048, 960), generator=g, device=dev) * 4
    s, z = torch.tensor(0.03, device=dev), torch.tensor(99.0, device=dev)
    for t in (x, x.to(torch.bfloat16)):
        assert torch.equal(act_quant_static(t, s, z),
                           act_quant_static_plain(t, s, z))


@pytest.mark.parametrize("M,K,N,group", [(4, 960, 1600, 960),
                                         (37, 2560, 960, 128),
                                         (300, 256, 100, 64)])
def test_w4a8_kernel_bit_exact(dev, M, K, N, group):
    """One group of 960 and twenty of 128 (smollm), ragged M, an N that is
    no multiple of 4 (the unvectorized load)."""
    g = torch.Generator(dev).manual_seed(M)
    x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int8)
    wp = torch.randint(-128, 128, (K // 2, N), generator=g, device=dev,
                       dtype=torch.int8)
    s_w = torch.rand((K // group, N), generator=g, device=dev) * 0.02 + 1e-3
    colsum = torch.randn((N,), generator=g, device=dev)
    sc = [torch.tensor(v, device=dev) for v in (0.031, 111.0)]
    for dt in (torch.float32, torch.bfloat16):
        a = w4a8_matmul(x, wp, *sc, s_w, colsum, group, z_shift=-128.0,
                        out_dtype=dt)
        b = w4a8_matmul_plain(x, wp, *sc, s_w, colsum, group, z_shift=-128.0,
                              out_dtype=dt)
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        w4a8_matmul(x[:, :-2].contiguous(), wp[:-1].contiguous(), *sc,
                    s_w[:, :], colsum, group)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,D", [(4, 960), (2048, 2560)])
def test_act_quant_ptoken_kernel_bit_exact(dev, M, D, bits):
    """Both arithmetics (f32 on f32 input, bf16-rounded on bf16 input),
    with an all-zero row, an outlier row and an all-positive row; any other
    dtype raises on the card, where the plain version would take it."""
    g = torch.Generator(dev).manual_seed(D)
    x = torch.randn((M, D), generator=g, device=dev) * 3 + 0.2
    x[1] = 0.0
    x[2, 5] = 250.0
    x[3] = x[3].abs() + 0.1
    for t in (x, x.to(torch.bfloat16)):
        a = act_quant_ptoken(t, bits=bits)
        b = act_quant_ptoken_plain(t, bits=bits)
        for u, v in zip(a, b):
            assert torch.equal(u, v), t.dtype
    with pytest.raises(ValueError):
        act_quant_ptoken(x.half(), bits=bits)


def test_attention_kernels_within_one_bf16_ulp(dev):
    g = torch.Generator(dev).manual_seed(1)
    B, H, Kh, S, hd, m = 2, 15, 5, 100, 64, 4
    bf = torch.bfloat16
    q = torch.randn((B, H, S, hd), generator=g, device=dev).to(bf)
    k = torch.randn((B, Kh, S + m, hd), generator=g, device=dev).to(bf)
    v = torch.randn((B, Kh, S + m, hd), generator=g, device=dev).to(bf)
    _within_ulp(flash_attention(q, k, v, prefix_len=m),
                flash_attention_plain(q, k, v, prefix_len=m))
    Smax = 256
    qd = torch.randn((B, H, hd), generator=g, device=dev).to(bf)
    kq = torch.randint(-127, 128, (B, Smax, Kh, hd), generator=g, device=dev,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (B, Smax, Kh, hd), generator=g, device=dev,
                       dtype=torch.int8)
    ks = torch.rand((Kh,), generator=g, device=dev) * 0.05 + 0.01
    kc = torch.randn((m, Kh, hd), generator=g, device=dev).to(bf)
    pos = torch.tensor([200, -1], dtype=torch.int32, device=dev)
    _within_ulp(flash_decode(qd, kq, vq, pos, ks, ks, kc, kc),
                flash_decode_plain(qd, kq, vq, pos, ks, ks, kc, kc))


def _pool(g, dev, B, P, ps, Kh, hd, dt):
    """A shuffled page store with junk in the scratch and spare pages."""
    n_pages = B * P + 3
    table = (torch.randperm(n_pages - 1, generator=g, device=dev)[:B * P]
             + 1).to(torch.int32).reshape(B, P)
    if dt == torch.int8:
        mk = lambda: torch.randint(-127, 128, (n_pages, ps, Kh, hd),  # noqa
                                   generator=g, device=dev, dtype=dt)
    else:
        mk = lambda: torch.randn((n_pages, ps, Kh, hd), generator=g,  # noqa
                                 device=dev).to(dt)
    return mk(), mk(), table


@pytest.mark.parametrize("quantized,per_row", [
    (False, False), (True, False), (True, True)],
    ids=["fp", "int8-K", "int8-BK"])
def test_paged_decode_bit_identical_to_contiguous(dev, quantized, per_row):
    """flash_decode_paged on a shuffled pool equals flash_decode on the
    gathered cache bit for bit, and both are within one bf16 ulp of the
    plain version; (K,) and per-row (B, K) scales, pos at m - 1, at a page
    boundary, mid-page and retired."""
    g = torch.Generator(dev).manual_seed(2)
    B, H, Kh, hd, P, ps, m = 4, 15, 5, 64, 10, 64, 4
    bf = torch.bfloat16
    kp, vp, table = _pool(g, dev, B, P, ps, Kh, hd,
                          torch.int8 if quantized else bf)
    q = torch.randn((B, H, hd), generator=g, device=dev).to(bf)
    pos = torch.tensor([m - 1, 2 * ps, 548, -1], dtype=torch.int32,
                       device=dev)
    kw = {}
    if quantized:
        shape = (B, Kh) if per_row else (Kh,)
        kw = dict(k_scale=torch.rand(shape, generator=g, device=dev) * 0.05
                  + 0.01,
                  v_scale=torch.rand(shape, generator=g, device=dev) * 0.05
                  + 0.01,
                  kc=torch.randn((m, Kh, hd), generator=g, device=dev).to(bf),
                  vc=torch.randn((m, Kh, hd), generator=g, device=dev).to(bf))
    paged = flash_decode_paged(q, kp, vp, table, pos, **kw)
    dense = flash_decode(q, gather_pages(kp, table), gather_pages(vp, table),
                         pos, **kw)
    torch.cuda.synchronize()
    assert torch.equal(paged, dense)
    _within_ulp(paged, flash_decode_paged_plain(q, kp, vp, table, pos, **kw))
    _within_ulp(dense, flash_decode_plain(q, gather_pages(kp, table),
                                          gather_pages(vp, table), pos,
                                          **kw))
    if not quantized:
        # an fp pool may carry the batch-free cushion as well
        kc = torch.randn((m, Kh, hd), generator=g, device=dev).to(bf)
        _within_ulp(flash_decode_paged(q, kp, vp, table, pos, kc=kc, vc=kc),
                    flash_decode_paged_plain(q, kp, vp, table, pos, kc=kc,
                                             vc=kc))
