"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: these need an NVIDIA card with ``nvcc`` and skip without
one (the fixture decides, never the module's import). On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_cuda.py     # on a machine without jax

Tolerances: w8a8_matmul and act_quant_static bit-exact (the kernels repeat
the plain versions' f32 arithmetic step by step); attention in bf16 within
one bf16 ulp of the plain version's f32-accumulated result; the paged
decode kernel bit-identical to the contiguous one on the gathered pool.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.act_quant import (act_quant_static,  # noqa: E402
                                           act_quant_static_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.flash_decode import (  # noqa: E402
    flash_decode, flash_decode_paged, flash_decode_paged_plain,
    flash_decode_plain, gather_pages)
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
