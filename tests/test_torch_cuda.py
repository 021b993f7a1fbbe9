"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: these need an NVIDIA card with ``nvcc`` and skip without
one (the fixture decides, never the module's import). On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_cuda.py     # on a machine without jax

Tolerances: w8a8_matmul, w4a8_matmul, act_quant_static and
act_quant_ptoken bit-exact (the kernels repeat the plain versions' f32 or
bf16-rounded arithmetic step by step), and so are the int matmuls that
quantize their f32 / bf16 A while staging it (M <= 16), against the
standalone quantizer followed by the matmul and against the plain
composition; attention in bf16 within
one bf16 ulp of the plain version's f32-accumulated result, in f32 within
1e-5; the paged decode kernel bit-identical to the contiguous one on the
gathered pool, a decode row bit-identical to the row computed alone, and
the last rows of a prefill bit-identical to a call on those rows alone.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.act_quant import (  # noqa: E402
    act_quant_ptoken, act_quant_ptoken_plain, act_quant_ptoken_range,
    act_quant_ptoken_range_plain, act_quant_static, act_quant_static_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_plain)
from repro_torch.kernels.flash_decode import (  # noqa: E402
    flash_decode, flash_decode_paged, flash_decode_paged_plain,
    flash_decode_plain, gather_pages)
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.w4a8_matmul import (  # noqa: E402
    quant_w4a8_matmul, quant_w4a8_matmul_plain, w4a8_matmul,
    w4a8_matmul_plain)
from repro_torch.kernels.w8a8_matmul import (  # noqa: E402
    quant_w8a8_matmul, quant_w8a8_matmul_plain, w8a8_matmul,
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


# the regimes of csrc/int_matmul.cuh: decode (M <= 16: split-K streaming,
# one slice or several per column tile) and tensor-core tiles (M > 16);
# smollm's sites at M = 4, 256 and 2048, the tied head at M = 4, K that is
# no multiple of 32, N that is no multiple of 4
W8_CASES = [(1, 960, 1600), (4, 960, 1600), (16, 2560, 960),
            (17, 960, 2560), (37, 2560, 960), (256, 960, 1600),
            (2048, 2560, 960), (2048, 960, 1600), (300, 128, 100),
            (4, 960, 49152), (5, 100, 102), (40, 100, 102), (3, 36, 7),
            # internvl2-26b's untied head (vocab 92,553, odd: the ragged-N
            # byte loads) at decode and in tensor-core tiles; jamba's
            # mamba_out (K = inner = 8192) and mamba_in (N = 16384)
            (1, 6144, 92553), (4, 6144, 92553), (300, 6144, 92553),
            (4, 8192, 4096), (2048, 8192, 4096), (2048, 4096, 16384)]


def _w8_case(dev, M, K, N, seed):
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    return x, w


@pytest.mark.parametrize("M,K,N", W8_CASES)
def test_w8a8_kernel_bit_exact(dev, M, K, N):
    """Both output dtypes, s_w in f32 and in bf16 (the weight's dtype)."""
    x, w = _w8_case(dev, M, K, N, M + K + N)
    sx, zx = (torch.tensor(v, device=dev) for v in (0.031, 111.0))
    for sw in (torch.tensor(0.0042, device=dev),
               torch.tensor(0.0042, device=dev).to(torch.bfloat16)):
        for dt in (torch.float32, torch.bfloat16):
            a = w8a8_matmul(x, w, sx, zx, sw, z_shift=-128.0, out_dtype=dt)
            b = w8a8_matmul_plain(x, w, sx, zx, sw, z_shift=-128.0,
                                  out_dtype=dt)
            torch.cuda.synchronize()
            assert torch.equal(a, b), (sw.dtype, dt)
def test_act_quant_kernel_bit_exact(dev):
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn((2048, 960), generator=g, device=dev) * 4
    s, z = torch.tensor(0.03, device=dev), torch.tensor(99.0, device=dev)
    for t in (x, x.to(torch.bfloat16)):
        assert torch.equal(act_quant_static(t, s, z),
                           act_quant_static_plain(t, s, z))


@pytest.mark.parametrize("n", [1, 3, 7, 8, 9, 1001, 4 * 960 + 5,
                               2048 * 2560 + 3])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_act_quant_static_odd_n_and_offset(dev, n, offset):
    """The scalar head (a slice whose data_ptr is not 16-byte aligned, so
    neither are its codes) and tail (n not a multiple of the vector) of the
    standalone kernel, f32 and bf16, against the plain version."""
    g = torch.Generator(dev).manual_seed(n + offset)
    buf = torch.randn((n + offset,), generator=g, device=dev) * 4
    s, z = torch.tensor(0.03, device=dev), torch.tensor(99.0, device=dev)
    for b in (buf, buf.to(torch.bfloat16)):
        t = b[offset:].view(1, n)
        assert t.data_ptr() % 16 or offset == 0
        assert torch.equal(act_quant_static(t, s, z),
                           act_quant_static_plain(t, s, z)), b.dtype


def _fp_x(dev, M, K, seed, offset=0):
    """A (M, K) f32 activation wide enough to clip at both ends of the
    site's range below; offset > 0 makes it a slice whose data_ptr is not
    16-byte aligned (the staging's scalar loads)."""
    g = torch.Generator(dev).manual_seed(seed)
    buf = torch.randn((M * K + offset,), generator=g, device=dev) * 3
    return buf[offset:].view(M, K)


def _fused_agrees(dev, fused, unfused, plain, M, K, seed):
    """fused(x) == unfused(x) == plain(x) bit for bit for f32 and bf16 x,
    aligned and not; each fused call at M <= 16 counts one w8a8 or w4a8
    launch and one fused quantization, and no standalone quantizer."""
    for offset in (0, 1):
        x32 = _fp_x(dev, M, K, seed, offset)
        xbf = torch.empty((M * K + offset,), dtype=torch.bfloat16,
                          device=dev)[offset:].view(M, K)
        xbf.copy_(x32)
        for x in (x32, xbf):
            _lib.reset_launches()
            a = fused(x)
            counts = dict(_lib.LAUNCHES)
            b, c = unfused(x), plain(x)
            torch.cuda.synchronize()
            assert counts["act_quant_static_fused"] == 1, counts
            assert counts["act_quant_static"] == 0, counts
            assert torch.equal(a, b), (x.dtype, offset)
            assert torch.equal(a, c), (x.dtype, offset)


@pytest.mark.parametrize("M,K,N", [c for c in W8_CASES if c[0] <= 16])
def test_w8a8_fused_quant_bit_exact(dev, M, K, N):
    """The decode regime's staging quantizes x (act_quant_static's
    arithmetic): equal to act_quant_static + w8a8_matmul and to the plain
    composition, s_w in f32 and bf16, both output dtypes."""
    _, w = _w8_case(dev, M, K, N, M + K + N)
    sx, zx = (torch.tensor(v, device=dev) for v in (0.031, 111.0))
    for sw in (torch.tensor(0.0042, device=dev),
               torch.tensor(0.0042, device=dev).to(torch.bfloat16)):
        for dt in (torch.float32, torch.bfloat16):
            _fused_agrees(
                dev,
                lambda x: quant_w8a8_matmul(x, w, sx, zx, sw, out_dtype=dt),
                lambda x: w8a8_matmul(act_quant_static(x, sx, zx), w, sx, zx,
                                      sw, z_shift=-128.0, out_dtype=dt),
                lambda x: quant_w8a8_matmul_plain(x, w, sx, zx, sw,
                                                  out_dtype=dt),
                M, K, M + N)


W4_CASES = [(1, 960, 1600, 960), (4, 960, 1600, 960),
            (16, 2560, 960, 128), (17, 2560, 960, 128),
            (37, 2560, 960, 128), (256, 960, 2560, 960),
            (2048, 2560, 960, 128), (2048, 960, 1600, 960),
            (300, 256, 100, 64), (4, 2560, 960, 64), (4, 200, 102, 100),
            (50, 200, 102, 100), (2, 36, 7, 12)]


def _w4_case(dev, M, K, N, group, seed):
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int8)
    wp = torch.randint(-128, 128, (K // 2, N), generator=g, device=dev,
                       dtype=torch.int8)
    s_w = torch.rand((K // group, N), generator=g, device=dev) * 0.02 + 1e-3
    colsum = torch.randn((N,), generator=g, device=dev)
    return x, wp, s_w, colsum


@pytest.mark.parametrize("M,K,N,group", W4_CASES)
def test_w4a8_kernel_bit_exact(dev, M, K, N, group):
    """One group of 960 and twenty of 128 (smollm), groups of 64, a group
    and K that are no multiples of 32, ragged M, an N that is no multiple
    of 4 (the unvectorized load); s_w in f32 and in bf16."""
    x, wp, s_w, colsum = _w4_case(dev, M, K, N, group, M + K + N)
    sc = [torch.tensor(v, device=dev) for v in (0.031, 111.0)]
    for sw in (s_w, s_w.to(torch.bfloat16)):
        for dt in (torch.float32, torch.bfloat16):
            a = w4a8_matmul(x, wp, *sc, sw, colsum, group, z_shift=-128.0,
                            out_dtype=dt)
            b = w4a8_matmul_plain(x, wp, *sc, sw, colsum, group,
                                  z_shift=-128.0, out_dtype=dt)
            torch.cuda.synchronize()
            assert torch.equal(a, b), (sw.dtype, dt)
    with pytest.raises(ValueError):
        w4a8_matmul(x[:, :-2].contiguous(), wp[:-1].contiguous(), *sc,
                    s_w[:, :], colsum, group)
    with pytest.raises(ValueError):
        w4a8_matmul(x, wp, *sc, s_w.half(), colsum, group)


@pytest.mark.parametrize("M,K,N,group", [c for c in W4_CASES if c[0] <= 16])
def test_w4a8_fused_quant_bit_exact(dev, M, K, N, group):
    """As ``test_w8a8_fused_quant_bit_exact``, for the packed int4 weight:
    one group and several, K and groups that are no multiples of 32."""
    _, wp, s_w, colsum = _w4_case(dev, M, K, N, group, M + K + N)
    sx, zx = (torch.tensor(v, device=dev) for v in (0.031, 111.0))
    for sw in (s_w, s_w.to(torch.bfloat16)):
        for dt in (torch.float32, torch.bfloat16):
            _fused_agrees(
                dev,
                lambda x: quant_w4a8_matmul(x, wp, sx, zx, sw, colsum, group,
                                            out_dtype=dt),
                lambda x: w4a8_matmul(act_quant_static(x, sx, zx), wp, sx,
                                      zx, sw, colsum, group, z_shift=-128.0,
                                      out_dtype=dt),
                lambda x: quant_w4a8_matmul_plain(x, wp, sx, zx, sw, colsum,
                                                  group, out_dtype=dt),
                M, K, M + N)


@pytest.mark.parametrize("K,N,group", [(960, 1600, 960), (2560, 960, 128)])
def test_int_matmul_rows_independent(dev, K, N, group):
    """Rows of an M = 2048 call (tensor-core tiles) equal the same rows in
    an M = 4 call (split-K streaming) and in an M = 256 call, bit for bit:
    chunked prefill relies on it. The same on f32 / bf16 input through the
    quantizing entries: at M = 2048 and 256 act_quant_static and the tiles,
    at M <= 16 the fused staging."""
    x, w = _w8_case(dev, 2048, K, N, 7)
    _, wp, s_w, colsum = _w4_case(dev, 2048, K, N, group, 8)
    sx, zx = (torch.tensor(v, device=dev) for v in (0.031, 111.0))
    sw8 = torch.tensor(0.0042, device=dev).to(torch.bfloat16)
    s_w = s_w.to(torch.bfloat16)
    xf = _fp_x(dev, 2048, K, 9)
    for inp, fn in (
            (x, lambda t: w8a8_matmul(t, w, sx, zx, sw8, z_shift=-128.0,
                                      out_dtype=torch.bfloat16)),
            (x, lambda t: w4a8_matmul(t, wp, sx, zx, s_w, colsum, group,
                                      z_shift=-128.0)),
            (xf, lambda t: quant_w8a8_matmul(t, w, sx, zx, sw8)),
            (xf.to(torch.bfloat16),
             lambda t: quant_w8a8_matmul(t, w, sx, zx, sw8,
                                         out_dtype=torch.bfloat16)),
            (xf, lambda t: quant_w4a8_matmul(t, wp, sx, zx, s_w, colsum,
                                             group)),
            (xf.to(torch.bfloat16),
             lambda t: quant_w4a8_matmul(t, wp, sx, zx, s_w, colsum, group,
                                         out_dtype=torch.bfloat16))):
        full = fn(inp)
        for r0, n in ((0, 4), (1001, 4), (2044, 4), (512, 256), (3, 1),
                      (100, 16), (7, 17)):
            part = fn(inp[r0:r0 + n].contiguous())
            torch.cuda.synchronize()
            assert torch.equal(full[r0:r0 + n], part), (inp.dtype, r0, n)


def test_int_matmul_two_streams(dev):
    """Decode calls on two streams at once, so their blocks can run
    together, each equal bit for bit the same call made alone: each stream
    merges through a workspace and tickets of its own."""
    x, w = _w8_case(dev, 4, 2560, 960, 9)
    _, wp, s_w, colsum = _w4_case(dev, 4, 2560, 960, 128, 10)
    sx, zx, sw = (torch.tensor(v, device=dev) for v in (0.031, 111.0,
                                                         0.0042))
    xf = _fp_x(dev, 4, 2560, 11).to(torch.bfloat16)
    calls = (lambda: w8a8_matmul(x, w, sx, zx, sw, z_shift=-128.0),
             lambda: w4a8_matmul(x, wp, sx, zx, s_w, colsum, 128,
                                 z_shift=-128.0),
             lambda: quant_w8a8_matmul(xf, w, sx, zx, sw),
             lambda: quant_w4a8_matmul(xf, wp, sx, zx, s_w, colsum, 128))
    want = [f() for f in calls]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    outs = []
    for _ in range(16):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append([f() for f in calls])
    torch.cuda.synchronize()
    for i, o in enumerate(outs):
        assert all(torch.equal(a, b) for a, b in zip(o, want)), i


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 4, 5, 2048])
@pytest.mark.parametrize("D", [1, 7, 100, 960, 2560, 4100, 8192])
def test_act_quant_ptoken_kernel_bit_exact(dev, M, D, bits):
    """Both arithmetics (f32 on f32 input, bf16-rounded on bf16 input),
    with an all-zero row, an outlier row and an all-positive row; D from
    one element to 8192 (128- and 256-thread blocks, rows staged in up to
    32 KB of shared memory), an odd D (rows not 16-byte aligned) and a
    slice whose data_ptr is not aligned; any other dtype raises on the
    card, where the plain version would take it."""
    g = torch.Generator(dev).manual_seed(D + M)
    x = torch.randn((M, D), generator=g, device=dev) * 3 + 0.2
    # rows 1, 2, 3 (mod M): all zero, an outlier, all positive
    x[1 % M] = 0.0
    x[2 % M, min(5, D - 1)] = 250.0
    x[3 % M] = x[3 % M].abs() + 0.1
    off = torch.empty((M * D + 1,), device=dev)[1:].view(M, D)
    off.copy_(x)
    for t in (x, x.to(torch.bfloat16), off):
        a = act_quant_ptoken(t, bits=bits)
        b = act_quant_ptoken_plain(t, bits=bits)
        for u, v in zip(a, b):
            assert torch.equal(u, v), (t.dtype, t.data_ptr() % 16)
    offb = torch.empty((M * D + 3,), dtype=torch.bfloat16,
                       device=dev)[3:].view(M, D)
    offb.copy_(x)
    for u, v in zip(act_quant_ptoken(offb, bits=bits),
                    act_quant_ptoken_plain(offb, bits=bits)):
        assert torch.equal(u, v), "bf16 slice"
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


def _attn_inputs(g, dev, B, Kh, G, S, m, hd, dt):
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(dt)  # noqa
    return mk(B, Kh * G, S, hd), mk(B, Kh, S + m, hd), mk(B, Kh, S + m, hd)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("hd", [16, 32, 64, 80])
@pytest.mark.parametrize("m", [0, 4, 37])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 300])
def test_flash_attention_bf16_edges_within_one_ulp(dev, S, m, hd, G):
    """The tensor-core kernel at ragged query and key tiles, a prefix that
    crosses no tile, a few or most of one, every built head_dim, MHA and
    GQA: within one bf16 ulp of the plain version."""
    g = torch.Generator(dev).manual_seed(S * 1000 + m * 10 + hd + G)
    q, k, v = _attn_inputs(g, dev, 2, 2, G, S, m, hd, torch.bfloat16)
    _within_ulp(flash_attention(q, k, v, prefix_len=m),
                flash_attention_plain(q, k, v, prefix_len=m))


@pytest.mark.parametrize("S,m,hd,G", [(300, 4, 64, 3), (512, 4, 64, 3),
                                      (130, 37, 32, 1)])
def test_flash_attention_rows_independent(dev, S, m, hd, G):
    """The last 100 query rows of a one-shot call equal, bit for bit, a call
    on those rows alone with the prefix moved by the cut (the chunked
    prefill's call): key tiles start at key 0 whatever the query tile."""
    g = torch.Generator(dev).manual_seed(S + m)
    q, k, v = _attn_inputs(g, dev, 2, 5 if G == 3 else 2, G, S, m, hd,
                           torch.bfloat16)
    cut = S - 100
    full = flash_attention(q, k, v, prefix_len=m)
    tail = flash_attention(q[:, :, cut:], k, v, prefix_len=m + cut)
    torch.cuda.synchronize()
    assert torch.equal(full[:, :, cut:], tail)


@pytest.mark.parametrize("hd", [64, 80])
def test_flash_attention_f32_within_1e5(dev, hd):
    """The f32 instantiation (CUDA cores, not redesigned)."""
    g = torch.Generator(dev).manual_seed(5)
    q, k, v = _attn_inputs(g, dev, 2, 5, 3, 100, 4, hd, torch.float32)
    torch.testing.assert_close(flash_attention(q, k, v, prefix_len=4),
                               flash_attention_plain(q, k, v, prefix_len=4),
                               rtol=1e-5, atol=1e-5)


def _decode_case(g, dev, mode, dt, B, Kh, G, hd, Smax, m):
    q = torch.randn((B, Kh * G, hd), generator=g, device=dev).to(dt)
    if mode == "fp":
        k = torch.randn((B, Smax, Kh, hd), generator=g, device=dev).to(dt)
        v = torch.randn((B, Smax, Kh, hd), generator=g, device=dev).to(dt)
        return q, k, v, {}
    k = torch.randint(-127, 128, (B, Smax, Kh, hd), generator=g, device=dev,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (B, Smax, Kh, hd), generator=g, device=dev,
                      dtype=torch.int8)
    shape = (B, Kh) if mode == "int8-BK" else (Kh,)
    sc = lambda: torch.rand(shape, generator=g, device=dev) * 0.05 + 0.01  # noqa
    return q, k, v, dict(
        k_scale=sc(), v_scale=sc(),
        kc=torch.randn((m, Kh, hd), generator=g, device=dev).to(dt),
        vc=torch.randn((m, Kh, hd), generator=g, device=dev).to(dt))


def _paginate(g, dev, k, v, ps):
    """dense (B, Smax, K, hd) k and v -> shuffled page stores with junk in
    the scratch page 0, and their shared (B, Smax / ps) table."""
    B, Smax = k.shape[:2]
    P = Smax // ps
    n_pages = B * P + 1
    table = (torch.randperm(n_pages - 1, generator=g, device=dev) + 1) \
        .to(torch.int32).reshape(B, P)
    stores = []
    for dense in (k, v):
        pages = torch.full((n_pages, ps, *dense.shape[2:]), 99,
                           dtype=dense.dtype, device=dev)
        pages[table.reshape(-1).long()] = dense.reshape(B * P, ps,
                                                        *dense.shape[2:])
        stores.append(pages)
    return stores[0], stores[1], table


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("mode", ["fp", "int8-K", "int8-BK"])
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_flash_decode_split_kv_edges(dev, paged, mode, dt):
    """pos at m - 1, on both sides of the first 64-position chunk edge, the
    last position and retired, in a 200-position cache (no multiple of
    64; paged: 5 pages of 40): within one bf16 ulp of the plain version
    (f32: 1e-5)."""
    g = torch.Generator(dev).manual_seed(11)
    B, Kh, G, hd, Smax, m = 6, 5, 3, 64, 200, 4
    q, k, v, kw = _decode_case(g, dev, mode, dt, B, Kh, G, hd, Smax, m)
    cm = m if mode != "fp" else 0
    pos = torch.tensor([cm - 1 if cm else 0, 63, 64, 65, Smax - 1, -1],
                       dtype=torch.int32, device=dev)
    if paged:
        kp, vp, table = _paginate(g, dev, k, v, 40)
        got = flash_decode_paged(q, kp, vp, table, pos, **kw)
        want = flash_decode_paged_plain(q, kp, vp, table, pos, **kw)
    else:
        got = flash_decode(q, k, v, pos, **kw)
        want = flash_decode_plain(q, k, v, pos, **kw)
    if dt == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        _within_ulp(got, want)
    if mode == "fp":
        assert not got[-1].any()          # retired, no cushion: zeros


@pytest.mark.parametrize("mode", ["fp", "int8-BK"])
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_flash_decode_batch_row_invariance(dev, paged, mode):
    """Row b of a B = 4 call equals the same row computed alone, bit for
    bit: the chunks and their merge order depend on the row's positions
    only."""
    g = torch.Generator(dev).manual_seed(12)
    B, Kh, G, hd, Smax, m = 4, 5, 3, 64, 640, 4
    q, k, v, kw = _decode_case(g, dev, mode, torch.bfloat16, B, Kh, G, hd,
                               Smax, m)
    pos = torch.tensor([548, 63, 639, -1], dtype=torch.int32, device=dev)
    if paged:
        kp, vp, table = _paginate(g, dev, k, v, 64)
        full = flash_decode_paged(q, kp, vp, table, pos, **kw)
    else:
        full = flash_decode(q, k, v, pos, **kw)
    for b in range(B):
        one = {n: (x[b:b + 1] if n.endswith("scale") else x)
               for n, x in kw.items()}
        if paged:
            alone = flash_decode_paged(q[b:b + 1], kp, vp, table[b:b + 1],
                                       pos[b:b + 1], **one)
        else:
            alone = flash_decode(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                 pos[b:b + 1], **one)
        torch.cuda.synchronize()
        assert torch.equal(full[b:b + 1], alone), b


def test_flash_decode_two_streams(dev):
    """Calls enqueued on two streams at once, so their blocks can run
    together, each equal bit for bit the same call made alone: each stream
    merges through counters of its own."""
    g = torch.Generator(dev).manual_seed(13)
    B, Kh, G, hd, Smax, m = 4, 5, 3, 64, 4096, 4
    q, k, v, kw = _decode_case(g, dev, "int8-BK", torch.bfloat16, B, Kh, G,
                               hd, Smax, m)
    pos = torch.tensor([4000, 2047, 4095, 100], dtype=torch.int32,
                       device=dev)
    want = flash_decode(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    outs = []
    for _ in range(16):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(flash_decode(q, k, v, pos, **kw))
    torch.cuda.synchronize()
    for i, o in enumerate(outs):
        assert torch.equal(o, want), i


# ---------------------------------------------------------------------------
# The decode step captured as a CUDA graph (serving/graphs.py)
# ---------------------------------------------------------------------------

# mode -> (quant mode, kv_dtype, prequant, weight_bits)
GRAPH_MODES = {"fp": ("none", None, False, 8),
               "w8a8_int8kv": ("pt_static", "int8", True, 8),
               "w4a8_int8kv": ("pt_static", "int8", True, 4),
               "ptoken_fp": ("ptoken_dynamic", None, False, 8)}


@pytest.fixture(scope="module")
def tiny_card():
    """paper_tiny on the card: seeded weights, a 3-token cushion, pt_static
    scales calibrated on one batch under it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA unavailable)")
    torch.backends.cuda.matmul.allow_tf32 = False
    import numpy as np
    from repro_torch.configs import QuantConfig, get_config
    from repro_torch.core.calibration import calibrate
    from repro_torch.launch.serve import seeded_cushion
    from repro_torch.models.registry import build
    dev = torch.device("cuda")
    api = build(get_config("paper_tiny"), dev)
    params = api.init_params(torch.Generator(dev).manual_seed(0))
    cushion = seeded_cushion(api, params, 3, seed=0)
    rs = np.random.RandomState(5)

    def tokens(b, s):
        return {"tokens": torch.as_tensor(
            rs.randint(0, 512, (b, s)).astype(np.int32), device=dev)}

    scales, _ = calibrate(api, params, [tokens(2, 24)],
                          QuantConfig(mode="pt_static", true_int8=True),
                          cushion=cushion)
    return dict(api=api, params=params, cushion=cushion, scales=scales,
                tokens=tokens, QuantConfig=QuantConfig)


def _graph_engine(s, mode):
    from repro_torch.serving.engine import Engine
    qmode, kv, pre, wb = GRAPH_MODES[mode]
    qcfg = s["QuantConfig"](mode=qmode, true_int8=qmode == "pt_static")
    return Engine(s["api"], s["params"], qcfg, cushion=s["cushion"],
                  scales=s["scales"] if qmode == "pt_static" else None,
                  max_seq=96, kv_dtype=kv, prequant=pre, weight_bits=wb)


def _counters_zero(graphs):
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import w8a8_matmul as W8
    torch.cuda.synchronize()
    bufs = [*FD.TICKETS.values(), *W8.WORKSPACE.values(),
            *(w for g in graphs for w in g.workspaces)]
    assert bufs and all(int(torch.count_nonzero(t)) == 0 for t in bufs)


@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_graph_tokens_and_launches_equal_eager(tiny_card, mode):
    """Engine.generate replays the step captured at the first request of
    B = 3: the tokens and every kernel's launches of generate_py (the eager
    step), one replay per token after the first, and the merge counters
    and workspaces zero afterwards."""
    s = tiny_card
    eng = _graph_engine(s, mode)
    batch = s["tokens"](3, 40)
    eng.generate(batch, 4)                  # captures B = 3's step
    graph = eng.states[3].graph
    assert graph.n_nodes > 0 and graph.capture_s > 0
    _lib.reset_launches()
    eng.generate(batch, 4)
    short = dict(_lib.LAUNCHES)
    _lib.reset_launches()
    got = eng.generate(batch, 20)
    counts = dict(_lib.LAUNCHES)
    assert _lib.COUNTERS["graph_replays"] == 19
    # 16 more replays add 16 times what the capture recorded
    assert {k: n - short[k] for k, n in counts.items() if n != short[k]} \
        == {k: 16 * n for k, n in graph.launches.items()}
    _lib.reset_launches()
    want = eng.generate_py(batch, 20)
    assert (got.tokens == want.tokens).all()
    assert counts == dict(_lib.LAUNCHES)
    assert _lib.COUNTERS["graph_replays"] == 0
    _counters_zero([graph])


def test_paged_continuous_graph_equals_eager_static(tiny_card):
    """A paged int8 W8A8 pool of 3 slots, 7 requests at once (slots
    recycled, two runs): every request's tokens equal the static B = 1
    Engine's eager per-token loop, one replay per step."""
    import dataclasses
    from repro_torch.serving.scheduler import ContinuousEngine, Request
    s = tiny_card
    eng1 = _graph_engine(s, "w8a8_int8kv")
    reqs = [Request(uid=i, batch=s["tokens"](1, 20 + 3 * i),
                    max_new_tokens=4 + i) for i in range(7)]
    ce = ContinuousEngine(s["api"], s["params"], eng1.qcfg, n_slots=3,
                          max_seq=96, cushion=s["cushion"],
                          scales=s["scales"], kv_dtype="int8",
                          prequant=True, paged=True, page_size=16)
    for run in range(2):
        _lib.reset_launches()
        outs = ce.run([dataclasses.replace(r) for r in reqs])
        assert _lib.COUNTERS["graph_replays"] == ce.stats.steps > 0
        for r, o in zip(reqs, outs):
            want = eng1.generate_py(r.batch, r.max_new_tokens).tokens[0]
            assert (o.tokens == want).all(), (run, r.uid)
    _counters_zero([ce.graph])


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("S,m,live", [(1, 4, 1), (65, 4, 0), (65, 4, 2),
                                      (200, 37, 10), (200, 100, 0),
                                      (130, 130, 64), (70, 130, 0)])
def test_flash_attention_live_mask(dev, S, m, live, hd, dt):
    """The live-length mask: rows [live, m) of the prefix seen by no query,
    tiles wholly in them skipped (m = 100 and 130 at live 0: whole dead
    tiles of 64 and of 32 keys), a tile across the edge masked per key;
    within the bars of the plain version; a dead row changes nothing."""
    g = torch.Generator(dev).manual_seed(S * 7 + m + live + hd)
    q, k, v = _attn_inputs(g, dev, 2, 2, 3, S, m, hd, dt)
    got = flash_attention(q, k, v, prefix_len=m, prefix_live=live)
    want = flash_attention_plain(q, k, v, prefix_len=m, prefix_live=live)
    if dt == torch.bfloat16:
        _within_ulp(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # garbage in the dead rows leaves the result as it was
    k2, v2 = k.clone(), v.clone()
    k2[:, :, live:m] = 1e3
    v2[:, :, live:m] = -1e3
    assert torch.equal(flash_attention(q, k2, v2, prefix_len=m,
                                       prefix_live=live), got)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_attention_full_live_and_lse_bit_identical(dev, dt):
    """prefix_live = prefix_len is the serving launch, and the autograd
    forward (which writes the log-sum-exp) gives the same output bits."""
    from repro_torch.kernels.flash_attention import FlashAttentionFn
    g = torch.Generator(dev).manual_seed(11)
    q, k, v = _attn_inputs(g, dev, 2, 5, 3, 256, 4, 64, dt)
    base = flash_attention(q, k, v, prefix_len=4)
    assert torch.equal(flash_attention(q, k, v, prefix_len=4,
                                       prefix_live=4), base)
    qg = q.clone().requires_grad_()
    out = FlashAttentionFn.apply(qg, k, v, 4, 4, True)
    assert torch.equal(out.detach(), base)
    from repro_torch.kernels.flash_attention import _launch
    for live in (4, 2):
        _, lse = _launch(q, k, v, 4, live, with_lse=True)
        _, want = flash_attention_plain(q, k, v, prefix_len=4,
                                        prefix_live=live, return_lse=True)
        assert lse.shape == (2, 15, 256)
        torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


def _bwd_case(dev, B, Kh, G, S, m, live, hd, dt, seed):
    g = torch.Generator(dev).manual_seed(seed)
    q, k, v = _attn_inputs(g, dev, B, Kh, G, S, m, hd, dt)
    do = torch.randn(q.shape, generator=g, device=dev).to(dt)
    from repro_torch.kernels.flash_attention import _launch
    o, lse = _launch(q, k, v, m, live, with_lse=True)
    return q, k, v, o, lse, do


def _bwd_within(got, want, dt):
    """bf16: one bf16 ulp of the plain value plus 1e-5 of the largest
    entry; f32: 1e-5 of the largest entry."""
    for a, b in zip(got, want):
        assert a.dtype == dt
        floor = 1e-5 * float(b.float().abs().max())
        err = (a.float() - b.float()).abs()
        lim = (BF16_ULP * b.float().abs() if dt == torch.bfloat16
               else torch.zeros_like(err)) + floor
        assert bool((err <= lim).all()), float(err.max())


# (S, m, live, B, Kh, G): the tuning shape and the first cases (B = 2,
# 15 / 5 heads), then a query tile's edges (S = 63, 64, 65, 300), T = S + m
# that no 64-key tile divides, live 0 behind 37 dead rows, B = 1, G = 1
BWD_CASES = [(256, 4, 4, 2, 5, 3), (256, 4, 1, 2, 5, 3), (33, 5, 0, 2, 5, 3),
             (100, 70, 20, 2, 5, 3), (1, 3, 3, 2, 5, 3), (63, 4, 4, 1, 2, 1),
             (64, 4, 2, 1, 2, 3), (65, 4, 4, 2, 2, 1), (300, 5, 5, 1, 2, 3),
             (64, 37, 0, 1, 2, 3), (65, 37, 0, 2, 2, 1),
             (300, 37, 10, 2, 2, 3)]


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [16, 32, 64, 80])
@pytest.mark.parametrize("S,m,live,B,Kh,G", BWD_CASES)
def test_flash_attention_bwd_matches_plain(dev, S, m, live, B, Kh, G, hd,
                                           dt):
    """The backward kernel through autograd (FlashAttentionFn) against the
    plain backward on the kernel's own output and log-sum-exp; dead rows
    exactly zero; deterministic; one flash_attention_bwd launch."""
    q, k, v, o, lse, do = _bwd_case(dev, B, Kh, G, S, m, live, hd, dt,
                                    S + m * 3 + live + hd)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, m, live)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    n0 = _lib.LAUNCHES["flash_attention_bwd"]
    out = flash_attention(qg, kg, vg, prefix_len=m, prefix_live=live)
    out.backward(do)
    assert _lib.LAUNCHES["flash_attention_bwd"] == n0 + 1
    got = (qg.grad, kg.grad, vg.grad)
    again = flash_attention_bwd(q, k, v, o, lse, do, m, live)
    torch.cuda.synchronize()
    _bwd_within(got, want, dt)
    for a, c in zip(got, again):
        assert torch.equal(a, c)
    assert not got[1][:, :, live:m].any() and not got[2][:, :, live:m].any()


def test_flash_attention_bwd_two_streams(dev):
    """Backward calls enqueued on two streams at once equal, bit for bit,
    the same call made alone: a call's blocks share nothing with another
    call's (the heads' dK and dV are summed in head order inside each
    call's thread block clusters)."""
    q, k, v, o, lse, do = _bwd_case(dev, 2, 5, 3, 256, 4, 4, 64,
                                    torch.bfloat16, 5)
    want = flash_attention_bwd(q, k, v, o, lse, do, 4, 4)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    outs = []
    for _ in range(8):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(flash_attention_bwd(q, k, v, o, lse, do, 4, 4))
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        for a, b in zip(got, want):
            assert torch.equal(a, b), i


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_attention_bwd_strided_and_unaligned_views(dev, dt):
    """dO and o as a transposed view (rows aligned, not contiguous), as a
    view whose rows start 2 bytes off 16 (copied before the launch) and
    with a strided last axis (copied): each gives the contiguous call's
    result bit for bit."""
    B, Kh, G, S, m, hd = 2, 5, 3, 65, 4, 64
    q, k, v, o, lse, do = _bwd_case(dev, B, Kh, G, S, m, m, hd, dt, 9)
    want = flash_attention_bwd(q, k, v, o, lse, do, m, m)
    H = Kh * G

    def views(x):
        tr = x.transpose(1, 2).contiguous().transpose(1, 2)
        pad = torch.zeros((B, H, S, hd + 9), dtype=dt, device=dev)
        pad[..., 1:hd + 1] = x
        st = x.transpose(2, 3).contiguous().transpose(2, 3)
        return {"transposed": tr, "unaligned": pad[..., 1:hd + 1],
                "strided_last_axis": st}

    for name, dv_ in views(do).items():
        got = flash_attention_bwd(q, k, v, o, lse, dv_, m, m)
        for a, b in zip(got, want):
            assert torch.equal(a, b), ("do", name)
    for name, ov in views(o).items():
        got = flash_attention_bwd(q, k, v, ov, lse, do, m, m)
        for a, b in zip(got, want):
            assert torch.equal(a, b), ("o", name)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_attention_bwd_routes_by_dtype(dev, dt):
    """bf16 runs the tensor-core kernel (attn_bwd_mma: dK and dV, the
    heads' sum and dQ) after attn_bwd_delta, f32 the CUDA-core kernels
    (attn_bwd_delta, attn_bwd_dkdv, attn_bwd_dq); f32 within 1e-5 of the
    largest entry."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    q, k, v, o, lse, do = _bwd_case(dev, 2, 5, 3, 256, 4, 4, 64, dt, 3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = flash_attention_bwd(q, k, v, o, lse, do, 4, 4)
        torch.cuda.synchronize()
    names = " ".join(e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
    cuda_core = ("attn_bwd_dkdv", "attn_bwd_dq<")
    want, other = ((("attn_bwd_delta", "attn_bwd_mma"), cuda_core)
                   if dt == torch.bfloat16
                   else (("attn_bwd_delta",) + cuda_core, ("attn_bwd_mma",)))
    assert all(n in names for n in want), names
    assert not any(n in names for n in other), names
    _bwd_within(got, flash_attention_bwd_plain(q, k, v, o, lse, do, 4, 4),
                dt)


# card vs CPU L_q bars on f32 paper_tiny: without fake quant the sums
# differ by reduction order only; the dynamic modes flip a code (ptoken: in
# one row; pt_dynamic: a tensor's range, so all its codes) on a one-ulp
# difference, and the flip propagates: 1.0e-2 measured under pt_dynamic,
# where the reference's own jitted and eager runs differ by 6.9e-3
# (tests/test_torch_tune.py)
SCORE_RTOL = {"none": 1e-4, "pt_dynamic": 5e-2, "ptoken_dynamic": 5e-2}


@pytest.mark.parametrize("qmode", list(SCORE_RTOL))
def test_search_scores_card_equal_cpu(tiny_card, qmode):
    """prefix_kv, prefix_qerr and score_candidates (groups of candidates,
    a padded prefix at live length 2) on the card against the port's CPU
    version on the same f32 weights, within ``SCORE_RTOL``; the argmin
    agrees without fake quant."""
    import numpy as np
    from repro_torch.models.common import ParamTree
    from repro_torch.models.registry import build
    s = tiny_card
    qcfg = s["QuantConfig"](mode=qmode)
    api, params = s["api"], s["params"]
    cpu_api = build(api.cfg, "cpu")
    tree = params.tree()

    def to_cpu(t):
        return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.detach().cpu()
    cpu_params = ParamTree(to_cpu(tree))
    batch = s["tokens"](1, 40)
    cands = torch.tensor([5, 9, 100, 200, 1, 33, 77, 401], device="cuda")
    pad = torch.tensor([1, 7, 0, 0], device="cuda")
    out = {}
    for name, a, p, dv in (("card", api, params, "cuda"),
                           ("cpu", cpu_api, cpu_params, "cpu")):
        with torch.no_grad():
            pkv = a.prefix_kv(p, pad.to(dv), qcfg)
            b = {"tokens": batch["tokens"].to(dv)}
            out[name] = (a.score_candidates(p, pkv, 2, cands.to(dv), b,
                                            qcfg).cpu().numpy(),
                         float(a.prefix_qerr(p, pkv, 2, b, qcfg)))
    rtol = SCORE_RTOL[qmode]
    np.testing.assert_allclose(out["card"][0], out["cpu"][0], rtol=rtol)
    np.testing.assert_allclose(out["card"][1], out["cpu"][1], rtol=rtol)
    if qmode == "none":
        assert int(np.argmin(out["card"][0])) == \
            int(np.argmin(out["cpu"][0]))


def test_prefix_tune_card_equal_cpu(tiny_card):
    """Three prefix_tune steps (quantization mode none: no rounding edge)
    on the card, through flash_attention and flash_attention_bwd, against
    the port's CPU run from the same cushion and batches: logs within 1e-4
    relative; the cushion within 1e-4 of it per element (a tenth of one
    step's lr: Adam moves an element by ~lr whatever the size of its
    gradient, so an element whose gradient is near zero can part by a
    fraction of lr; 1.8e-5 measured at 1 of 1,536 elements) and 1e-6 on
    the mean; 3 forward and 3 backward attention launches a layer; one
    host transfer for the log."""
    from repro_torch import monitoring as MON
    from repro_torch.configs import CushionConfig
    from repro_torch.core.cushioncache import prefix_tune
    from repro_torch.models.common import ParamTree
    from repro_torch.models.registry import build
    s = tiny_card
    qcfg = s["QuantConfig"](mode="none")
    api, params = s["api"], s["params"]

    def to_cpu(t):
        return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.detach().cpu()
    cpu_api = build(api.cfg, "cpu")
    cpu_params = ParamTree(to_cpu(params.tree()))
    # batches of this test's own seed (the fixture's stream depends on
    # which tests ran before)
    import numpy as np
    rs = np.random.RandomState(7)
    batches = []
    for _ in range(3):
        t = torch.as_tensor(rs.randint(0, 512, (2, 33)).astype(np.int32),
                            device="cuda")
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    ccfg = CushionConfig(tune_steps=3, tune_lr=1e-3, lam=0.1, log_every=3)
    _lib.reset_launches()
    with MON.count_host_syncs() as c:
        card = prefix_tune(api, params, s["cushion"], iter(batches), qcfg,
                           ccfg, verbose=False)
    L = api.cfg.n_layers
    assert c.count == 1
    assert _lib.LAUNCHES["flash_attention"] == 3 * L
    assert _lib.LAUNCHES["flash_attention_bwd"] == 3 * L
    cpu = prefix_tune(cpu_api, cpu_params, to_cpu(s["cushion"]),
                      ({k: v.cpu() for k, v in b.items()} for b in batches),
                      qcfg, ccfg, verbose=False)
    for a, b in zip(card.log, cpu.log):
        for key in ("loss", "ce", "range", "gnorm"):
            assert abs(a[key] - b[key]) <= 1e-4 * abs(b[key]), key
    for k in ("k", "v"):
        diff = (card.cushion["kv"][k].cpu() - cpu.cushion["kv"][k]).abs()
        assert float(diff.max()) <= 1e-4 and float(diff.mean()) <= 1e-6, \
            (float(diff.max()), float(diff.mean()))
        assert not torch.equal(card.cushion["kv"][k], s["cushion"]["kv"][k])


@pytest.fixture(scope="module")
def router_card():
    """The replica router on the card over a reduced smollm (its widths,
    heads and tied head, 2 layers, a 2048-id vocabulary): 3 replicas x 2
    paged int8 slots, W8A8 prequantized, a 4-token cushion, pt_static
    scales; 9 requests queued at once (prompts 24 / 40, budgets 8 / 5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA unavailable)")
    torch.backends.cuda.matmul.allow_tf32 = False
    import numpy as np
    from repro_torch.configs import QuantConfig, get_config
    from repro_torch.configs.base import reduced
    from repro_torch.core.calibration import calibrate
    from repro_torch.launch.serve import seeded_cushion
    from repro_torch.models.registry import build
    from repro_torch.serving.router import ReplicaRouter, RouterConfig
    from repro_torch.serving.scheduler import Request
    dev = torch.device("cuda")
    cfg = reduced(get_config("smollm-360m"), n_layers=2, d_model=960,
                  n_heads=15, n_kv_heads=5, d_head=0, d_ff=2560,
                  vocab_size=2048)
    api = build(cfg, dev)
    params = api.init_params(torch.Generator(dev).manual_seed(0))
    cushion = seeded_cushion(api, params, 4, seed=0)
    qw8 = QuantConfig(mode="pt_static", true_int8=True)
    rs = np.random.RandomState(9)

    def tokens(b, s):
        return {"tokens": torch.as_tensor(
            rs.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
            device=dev)}

    scales, _ = calibrate(api, params, [tokens(2, 48)], qw8, cushion=cushion)
    reqs = [Request(uid=i, batch=tokens(1, (24, 40)[i % 2]),
                    max_new_tokens=(8, 5)[i % 2]) for i in range(9)]
    router = ReplicaRouter(api, params, qw8, n_replicas=3,
                           cfg=RouterConfig(backoff_base_s=0.0),
                           n_slots=2, max_seq=96, cushion=cushion,
                           scales=scales, kv_dtype="int8", prequant=True,
                           paged=True, page_size=16)
    return dict(api=api, params=params, cushion=cushion, scales=scales,
                qw8=qw8, reqs=reqs, router=router,
                graphs=[rep.engine.graph for rep in router.replicas])


def _router_run(s, chaos=None):
    """One run of the card's router: its result, with the graph replays
    held to the replicas' steps, no graph captured again, and every merge
    counter and workspace zero afterwards."""
    from repro_torch.distributed.fault_injection import FaultInjector
    router = s["router"]
    _lib.reset_launches()
    res = router.run(s["reqs"], injector=(FaultInjector.parse(chaos)
                                          if chaos else None))
    torch.cuda.synchronize()
    steps = sum(p["steps"] for p in res.stats.per_replica)
    assert _lib.COUNTERS["graph_replays"] == steps > 0
    assert all(rep.engine.graph is g
               for rep, g in zip(router.replicas, s["graphs"]))
    _counters_zero(s["graphs"])
    # one copy of the weights: every int8 weight leaf at one address
    ptrs = {tuple(t.data_ptr() for t in rep.engine.params.buffers()
                  if t.dtype == torch.int8) for rep in router.replicas}
    assert len(ptrs) == 1 and len(next(iter(ptrs))) > 0
    return res


def test_router_kill_one_of_three_on_card(router_card):
    """Replica 1 crashes at its third step: every request completes with
    the tokens of the no-fault run and of the static B = 1 Engine, per
    uid (replica and slot may differ)."""
    from repro_torch.serving.engine import Engine
    s = router_card
    base = _router_run(s)
    assert len(base.outputs) == 9 and not base.rejected
    assert base.stats.replica_deaths == base.stats.retries == 0
    res = _router_run(s, "crash@replica1.step:2")
    st = res.stats
    assert len(res.outputs) == 9 and not res.rejected
    assert st.replica_deaths == 1 and st.failovers >= 1
    assert st.retries >= st.failovers
    assert [p["state"] for p in st.per_replica] == \
        ["HEALTHY", "DEAD", "HEALTHY"]
    assert sum(p["consecutive_errors"] for p in st.per_replica) == 0
    want = {o.uid: o.tokens for o in base.outputs}
    for o in res.outputs:
        assert (o.tokens == want[o.uid]).all(), o.uid
    eng = Engine(s["api"], s["params"], s["qw8"], cushion=s["cushion"],
                 scales=s["scales"], max_seq=96, kv_dtype="int8",
                 prequant=True)
    for r in s["reqs"]:
        got = eng.generate_py(r.batch, r.max_new_tokens).tokens[0]
        assert (got == want[r.uid]).all(), r.uid


def test_router_drain_on_card(router_card):
    """An interrupt at replica 0's third step drains: the live requests
    finish with the no-fault tokens, the rest are rejected as draining."""
    s = router_card
    base = {o.uid: o.tokens for o in _router_run(s).outputs}
    res = _router_run(s, "interrupt@replica0.step:2")
    assert res.stats.drained and res.stats.replica_deaths == 0
    assert res.outputs and {r.reason for r in res.rejected} == {"draining"}
    assert len(res.outputs) + len(res.rejected) == len(s["reqs"])
    for o in res.outputs:
        assert (o.tokens == base[o.uid]).all(), o.uid


# ---------------------------------------------------------------------------
# the MoE family on the card (reduced olmoe: 4 layers, 8 experts, top-2;
# capacity factor 1.25 and a router planted so that expert 0 overflows)
# ---------------------------------------------------------------------------

# olmoe's head_dim 128: the bf16 attention kernels (f32 stays at 16-64)
# and the decode kernels, at the bars of their head_dim 16-64 tests
HD128_CASES = [(512, 4, 4, 2, 4, 1), (65, 37, 10, 2, 2, 3), (1, 4, 4, 1, 2, 1),
               (300, 5, 2, 1, 16, 1)]
# jamba (8 kv-heads, G = 4), internvl2-26b (8 kv-heads, G = 6: the
# backward's cluster then holds one query chunk) and deepseek-67b (G = 8:
# 8 kv-heads at one rank, 4 at each of two tensor-parallel ranks, the
# backward's cluster of 8 head groups): the tuning's shape, a query tile's
# edges, live 0 behind dead rows, a tensor-parallel rank's prefill
HD128_GQA_CASES = [(260, 4, 4, 2, 8, 4), (65, 37, 10, 2, 2, 4),
                   (64, 4, 0, 1, 2, 4), (260, 4, 4, 2, 8, 6),
                   (65, 37, 10, 2, 2, 6), (63, 4, 2, 1, 1, 6),
                   (300, 5, 5, 1, 2, 6), (260, 4, 4, 2, 8, 8),
                   (65, 37, 10, 2, 2, 8), (512, 4, 4, 1, 4, 8)]


@pytest.mark.parametrize("S,m,live,B,Kh,G", HD128_CASES + HD128_GQA_CASES)
def test_attention_head_dim_128_within_bars(dev, S, m, live, B, Kh, G):
    """flash_attention (bf16) within one bf16 ulp of its plain version and
    its log-sum-exp within 1e-5, a dead row changing nothing; the backward
    through autograd within its bar, deterministic, dead rows zero."""
    bf = torch.bfloat16
    q, k, v, o, lse, do = _bwd_case(dev, B, Kh, G, S, m, live, 128, bf,
                                    S + m + live)
    want, want_lse = flash_attention_plain(q, k, v, prefix_len=m,
                                           prefix_live=live, return_lse=True)
    got = flash_attention(q, k, v, prefix_len=m, prefix_live=live)
    _within_ulp(got, want)
    assert torch.equal(o, got)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    k2 = k.clone()
    k2[:, :, live:m] = 1e3
    assert torch.equal(flash_attention(q, k2, v, prefix_len=m,
                                       prefix_live=live), got)
    want_g = flash_attention_bwd_plain(q, k, v, o, lse, do, m, live)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    flash_attention(qg, kg, vg, prefix_len=m, prefix_live=live).backward(do)
    got_g = (qg.grad, kg.grad, vg.grad)
    _bwd_within(got_g, want_g, bf)
    for a, c in zip(got_g, flash_attention_bwd(q, k, v, o, lse, do, m,
                                               live)):
        assert torch.equal(a, c)
    assert not got_g[1][:, :, live:m].any()
    with pytest.raises(ValueError, match="128"):
        flash_attention(q.float(), k.float(), v.float(), prefix_len=m)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("mode", ["fp", "int8-K", "int8-BK"])
def test_flash_decode_head_dim_128(dev, mode, dt):
    """Contiguous and paged decode at head_dim 128 (olmoe: 16 kv-heads, G =
    1; and G = 3): within one bf16 ulp of the plain version (f32: 1e-5),
    the paged kernel bit-identical to the contiguous one, a row equal to
    the row computed alone."""
    g = torch.Generator(dev).manual_seed(13)
    for Kh, G in ((16, 1), (2, 3)):
        B, hd, Smax, m = 4, 128, 200, 4
        q, k, v, kw = _decode_case(g, dev, mode, dt, B, Kh, G, hd, Smax, m)
        cm = m if mode != "fp" else 0
        pos = torch.tensor([cm - 1 if cm else 0, 64, Smax - 1, -1],
                           dtype=torch.int32, device=dev)
        got = flash_decode(q, k, v, pos, **kw)
        want = flash_decode_plain(q, k, v, pos, **kw)
        if dt == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        else:
            _within_ulp(got, want)
        kp, vp, table = _paginate(g, dev, k, v, 40)
        assert torch.equal(flash_decode_paged(q, kp, vp, table, pos, **kw),
                           got)
        one = {k_: (v_[1:2] if k_.endswith("scale") and v_.dim() == 2
                    else v_) for k_, v_ in kw.items()}
        assert torch.equal(flash_decode(q[1:2], k[1:2], v[1:2], pos[1:2],
                                        **one), got[1:2])


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("mode", ["fp", "int8-K", "int8-BK"])
@pytest.mark.parametrize("G", [4, 6, 8])
def test_flash_decode_head_dim_128_gqa(dev, G, mode, dt):
    """Contiguous and paged decode at head_dim 128 over 8 kv-heads, jamba's
    G = 4, internvl2-26b's G = 6 and deepseek-67b's G = 8 (64 heads at one
    rank): bf16 within one bf16 ulp of the plain
    version plus 1e-5 of its largest entry (the backward's bar: with 24-48
    heads a row holds entries that cancel to ~1e-4, where the f32 sums of
    the split-KV chunks, merged in another order, leave a few 1e-6; one
    such entry measured 1.7e-6 apart, the largest entries up to ~6), f32
    within 1e-5;
    the paged kernel bit-identical to the contiguous one, a row equal to
    the row computed alone."""
    g = torch.Generator(dev).manual_seed(17 + G)
    B, Kh, hd, Smax, m = 4, 8, 128, 200, 4
    q, k, v, kw = _decode_case(g, dev, mode, dt, B, Kh, G, hd, Smax, m)
    cm = m if mode != "fp" else 0
    pos = torch.tensor([cm - 1 if cm else 0, 64, Smax - 1, -1],
                       dtype=torch.int32, device=dev)
    got = flash_decode(q, k, v, pos, **kw)
    want = flash_decode_plain(q, k, v, pos, **kw)
    err = float((got.float() - want.float()).abs().max())
    print(f"G={G} {mode} {dt}: max |kernel - plain| {err:.3g}, of the "
          f"largest entry {err / float(want.float().abs().max()):.3g}")
    if dt == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        _bwd_within((got,), (want,), dt)
    kp, vp, table = _paginate(g, dev, k, v, 40)
    assert torch.equal(flash_decode_paged(q, kp, vp, table, pos, **kw), got)
    one = {k_: (v_[1:2] if k_.endswith("scale") and v_.dim() == 2 else v_)
           for k_, v_ in kw.items()}
    assert torch.equal(flash_decode(q[1:2], k[1:2], v[1:2], pos[1:2], **one),
                       got[1:2])


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("mode", ["fp", "int8-K", "int8-BK"])
def test_flash_decode_head_dim_80(dev, mode, dt):
    """Contiguous and paged decode at head_dim 80 (stablelm-3b: 32
    kv-heads, G = 1; and G = 3): within one bf16 ulp of the plain version
    (f32: 1e-5), the paged kernel bit-identical to the contiguous one, a
    row equal to the row computed alone."""
    g = torch.Generator(dev).manual_seed(19)
    for Kh, G in ((32, 1), (2, 3)):
        B, hd, Smax, m = 4, 80, 200, 4
        q, k, v, kw = _decode_case(g, dev, mode, dt, B, Kh, G, hd, Smax, m)
        cm = m if mode != "fp" else 0
        pos = torch.tensor([cm - 1 if cm else 0, 64, Smax - 1, -1],
                           dtype=torch.int32, device=dev)
        got = flash_decode(q, k, v, pos, **kw)
        want = flash_decode_plain(q, k, v, pos, **kw)
        if dt == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        else:
            _within_ulp(got, want)
        kp, vp, table = _paginate(g, dev, k, v, 40)
        assert torch.equal(flash_decode_paged(q, kp, vp, table, pos, **kw),
                           got)
        one = {k_: (v_[1:2] if k_.endswith("scale") and v_.dim() == 2
                    else v_) for k_, v_ in kw.items()}
        assert torch.equal(flash_decode(q[1:2], k[1:2], v[1:2], pos[1:2],
                                        **one), got[1:2])


def _moe_setup(dev, dtype="float32"):
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build
    cfg = reduced(get_config("olmoe-1b-7b"), dtype=dtype)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25))
    api = build(cfg, dev)
    params = api.init_params(torch.Generator(dev).manual_seed(0)).tree()
    params["layers"]["moe"]["router"][:, :, 0] += 1.0
    return api, params


def test_moe_dispatch_on_card_equals_plain(dev):
    """The arange-comparison slot one-hot on the card against its plain
    version on the CPU and against ``F.one_hot`` of the kept positions,
    with entries dropped: bit-identical."""
    import torch.nn.functional as F
    from repro_torch.models import moe as TM
    g = torch.Generator(dev).manual_seed(1)
    B, S, K, E, cap = 3, 40, 2, 8, 12
    idx = torch.stack([torch.randperm(E, generator=g, device=dev)[:K]
                       for _ in range(B * S)]).reshape(B, S, K)
    idx[0, :, 0] = 3                           # expert 3 overflows in row 0
    onehot = (idx[..., None] == torch.arange(E, device=dev)).float()
    got = TM.dispatch(onehot, cap)
    assert torch.equal(got.cpu(), TM.dispatch(onehot.cpu(), cap))
    flat = onehot.reshape(B, S * K, E)
    pos = (torch.cumsum(flat, 1) - 1).long()
    keep = (pos < cap) & (flat > 0)
    plain = F.one_hot(pos.clamp(0, cap - 1), cap).float() * keep[..., None]
    assert torch.equal(got, plain.reshape(B, S, K, E, cap))
    assert float(got.sum()) < B * S * K       # entries dropped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["none", "pt_dynamic", "pt_static"])
def test_apply_moe_card_equals_cpu(dev, mode, dtype):
    """One MoE layer on the card against the port on the CPU, same input,
    where entries drop: the routing, the kept entries and the lb loss
    identical (the f32 gate logits of one row agree to far below their
    gaps here), y within 1e-5 in f32 (matmuls summed in another order)
    and two bf16 ulp of its scale in bf16, except under pt_dynamic where
    one token row may sit within a down-site code step (2e-2, as against
    JAX on the CPU)."""
    from repro_torch.configs import QuantConfig
    from repro_torch.core.quantization import SiteScale
    from repro_torch.models import moe as TM
    api, params = _moe_setup(dev, dtype)
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    cpu_lp = {k: v.cpu() for k, v in lp.items()}
    dt = lp["w_up"].dtype
    x = torch.randn(2, 24, 64, generator=torch.Generator(dev).manual_seed(2),
                    device=dev).to(dt)
    qcfg = QuantConfig(mode=mode)
    sc = None
    if mode == "pt_static":
        sc = {k: SiteScale(torch.tensor(s_, device=dev),
                           torch.tensor(z_, device=dev))
              for k, (s_, z_) in {"mlp_in": (0.03, 128.0),
                                  "down": (0.01, 120.0)}.items()}
    cpu_sc = None if sc is None else {
        k: SiteScale(v.scale.cpu(), v.zero.cpu()) for k, v in sc.items()}
    _, _, idx = TM.route(x, lp["router"], api.cfg.moe.top_k)
    _, _, cidx = TM.route(x.cpu(), cpu_lp["router"], api.cfg.moe.top_k)
    assert torch.equal(idx.cpu(), cidx)
    y, lb = TM.apply_moe(lp, x, api.cfg, qcfg, sc, None)
    cy, clb = TM.apply_moe(cpu_lp, x.cpu(), api.cfg, qcfg, cpu_sc, None)
    assert abs(float(lb) - float(clb)) <= 1e-6
    err = (y.cpu().float() - cy.float()).abs().amax(-1).flatten()
    bar = 1e-5 if dtype == "float32" else \
        2 * BF16_ULP * float(cy.float().abs().max())
    if mode == "pt_dynamic":
        assert int((err > bar).sum()) <= 1 and float(err.max()) <= 2e-2
    else:
        assert float(err.max()) <= bar, float(err.max())


def test_moe_decode_step_captured_without_sync(dev):
    """olmoe's decode step (the routing's stable sort, the dispatch's
    cumsum and arange comparison, the expert einsums) is captured as a CUDA
    graph with no host sync, in the static Engine (W8A8, int8 KV) and a
    paged ContinuousEngine: graph tokens = the eager per-token loop's, one
    replay per step, and every continuous request = the static B = 1
    Engine's."""
    import numpy as np
    from repro_torch.configs import QuantConfig
    from repro_torch.core.calibration import calibrate
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import ContinuousEngine, Request
    api, params = _moe_setup(dev)
    rs = np.random.RandomState(5)

    def tokens(b, s):
        return {"tokens": torch.as_tensor(
            rs.randint(0, 256, (b, s)).astype(np.int32), device=dev)}

    qw8 = QuantConfig(mode="pt_static", true_int8=True)
    cushion = api.extract_cushion(params, torch.tensor([1, 2, 3]), None,
                                  QuantConfig())
    scales, _ = calibrate(api, params, [tokens(2, 24)], qw8,
                          cushion=cushion)
    eng = Engine(api, params, qw8, cushion=cushion, scales=scales,
                 max_seq=96, kv_dtype="int8", prequant=True)
    batch = tokens(2, 30)
    eng.generate(batch, 4)                  # captures B = 2's step
    assert eng.states[2].graph.n_nodes > 0
    _lib.reset_launches()
    got = eng.generate(batch, 12)
    assert _lib.COUNTERS["graph_replays"] == 11
    assert (got.tokens == eng.generate_py(batch, 12).tokens).all()
    reqs = [Request(uid=i, batch=tokens(1, 20 + 3 * i), max_new_tokens=5)
            for i in range(5)]
    ce = ContinuousEngine(api, params, qw8, n_slots=2, max_seq=96,
                          cushion=cushion, scales=scales, kv_dtype="int8",
                          prequant=True, paged=True, page_size=16)
    _lib.reset_launches()
    outs = ce.run(reqs)
    assert _lib.COUNTERS["graph_replays"] == ce.stats.steps > 0
    for r, o in zip(reqs, outs):
        want = eng.generate_py(r.batch, r.max_new_tokens).tokens[0]
        assert (o.tokens == want).all(), r.uid
    _counters_zero([eng.states[2].graph, ce.graph])


def test_hybrid_decode_step_captured_with_the_mamba_state(dev):
    """The hybrid's decode step (reduced jamba: one period, Mamba, MoE and
    attention) captured as a CUDA graph in the static Engine (W8A8, int8
    KV): graph tokens = the eager loop's, and the Mamba state (h, conv)
    the graph leaves in the cache = the eager loop's, bit for bit (the step
    writes it in place, into the tensors the graph was captured on); a
    contiguous and a paged pool give the static B = 1 Engine's tokens."""
    import numpy as np
    from repro_torch.configs import QuantConfig, get_config, reduced
    from repro_torch.core.calibration import calibrate
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import ContinuousEngine, Request
    cfg = reduced(get_config("jamba-v0.1-52b"), dtype="float32")
    api = build(cfg, "cuda")
    params = api.init_params(torch.Generator(dev).manual_seed(0))
    rs = np.random.RandomState(6)

    def tokens(b, s):
        return {"tokens": torch.as_tensor(
            rs.randint(0, 256, (b, s)).astype(np.int32), device=dev)}

    qw8 = QuantConfig(mode="pt_static", true_int8=True)
    cushion = api.extract_cushion(params, torch.tensor([1, 2, 3]), None,
                                  QuantConfig())
    scales, _ = calibrate(api, params, [tokens(2, 24)], qw8,
                          cushion=cushion)
    eng = Engine(api, params, qw8, cushion=cushion, scales=scales,
                 max_seq=96, kv_dtype="int8", prequant=True)
    batch = tokens(2, 30)
    eng.generate(batch, 4)                  # captures B = 2's step
    st = eng.states[2]
    h_at = st.cache["h"].data_ptr()
    _lib.reset_launches()
    got = eng.generate(batch, 12)
    assert _lib.COUNTERS["graph_replays"] == 11
    state = {k: st.cache[k].clone() for k in ("h", "conv")}
    eager = eng.generate_py(batch, 12)
    assert (got.tokens == eager.tokens).all()
    assert st.cache["h"].data_ptr() == h_at
    for k in ("h", "conv"):
        assert torch.equal(st.cache[k], state[k]), k
    reqs = [Request(uid=i, batch=tokens(1, 20 + 3 * i), max_new_tokens=5)
            for i in range(5)]
    for paged in (False, True):
        ce = ContinuousEngine(api, params, qw8, n_slots=2, max_seq=96,
                              cushion=cushion, scales=scales,
                              kv_dtype="int8", prequant=True, paged=paged,
                              page_size=16)
        _lib.reset_launches()
        outs = ce.run(reqs)
        assert _lib.COUNTERS["graph_replays"] == ce.stats.steps > 0
        for r, o in zip(reqs, outs):
            want = eng.generate_py(r.batch, r.max_new_tokens).tokens[0]
            assert (o.tokens == want).all(), (paged, r.uid)
        _counters_zero([ce.graph])
    _counters_zero([st.graph])


# (S, T) of the non-causal mode: whisper's encoder (S = T = 1500: 23 full
# key tiles and a ragged 28), its cross-attention at prefill (S = 256, T =
# 1500) and at decode (S = 1), and a query or key tile's edges with T != S
NC_CASES = [(1, 1500), (63, 65), (64, 1), (65, 63), (256, 1500),
            (1500, 1500), (64, 130)]


def _nc_inputs(dev, B, Kh, G, S, T, hd, dt, seed):
    g = torch.Generator(dev).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(dt)  # noqa
    return mk(B, Kh * G, S, hd), mk(B, Kh, T, hd), mk(B, Kh, T, hd)


@pytest.mark.parametrize("dt,hd", [(torch.bfloat16, 64),
                                   (torch.bfloat16, 128),
                                   (torch.float32, 64)],
                         ids=["bf16-64", "bf16-128", "f32-64"])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("S,T", NC_CASES)
def test_flash_attention_noncausal_within_bars(dev, S, T, G, hd, dt):
    """Every key j < T visible to every query, T independent of S: within
    one bf16 ulp (bf16) or 1e-5 (f32) of the plain version, two calls
    bit-identical, and a row's result bit-identical to the row computed
    alone."""
    q, k, v = _nc_inputs(dev, 2, 2, G, S, T, hd, dt, S * 7 + T + G + hd)
    n0 = _lib.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=False)
    want = flash_attention_plain(q, k, v, causal=False)
    if dt == torch.bfloat16:
        _within_ulp(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, flash_attention(q, k, v, causal=False))
    for i in sorted({0, S // 2, S - 1}):
        row = flash_attention(q[:, :, i:i + 1], k, v, causal=False)
        assert torch.equal(got[:, :, i:i + 1], row), i
    assert _lib.LAUNCHES["flash_attention"] == n0 + 2 + len({0, S // 2,
                                                            S - 1})


def test_flash_attention_causal_equals_noncausal_where_they_coincide(dev):
    """One query behind T - 1 prefix keys sees every key in both modes: the
    two launches are bit-identical (the causal walk with R = prefix_len and
    the non-causal one with R = T)."""
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = _nc_inputs(dev, 2, 2, 3, 1, 300, 64, dt, 9)
        assert torch.equal(flash_attention(q, k, v, prefix_len=299),
                           flash_attention(q, k, v, causal=False))


def test_noncausal_refuses_a_prefix(dev):
    q, k, v = _nc_inputs(dev, 1, 1, 1, 4, 9, 64, torch.bfloat16, 1)
    with pytest.raises(ValueError, match="no prefix"):
        flash_attention(q, k, v, causal=False, prefix_len=2)


@pytest.mark.parametrize("dt,hd", [(torch.bfloat16, 64),
                                   (torch.bfloat16, 128),
                                   (torch.float32, 64)],
                         ids=["bf16-64", "bf16-128", "f32-64"])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("S,T", [(7, 40), (63, 65), (65, 1), (256, 1500),
                                 (1, 130)])
def test_flash_attention_noncausal_bwd_matches_plain(dev, S, T, G, hd, dt):
    """The backward of the non-causal mode through autograd against the
    plain backward on the kernel's own output and log-sum-exp, within the
    backward's bars; two calls bit-identical; one launch. At T = 1 every p
    is 1 and dS = dO.v - D is zero in exact arithmetic: dQ and dK are
    rounding residue on both sides, held within 1e-5 of dV's largest
    entry."""
    from repro_torch.kernels.flash_attention import _launch
    q, k, v = _nc_inputs(dev, 2, 2, G, S, T, hd, dt, S + 3 * T + G)
    do = torch.randn(q.shape, generator=torch.Generator(dev).manual_seed(T),
                     device=dev).to(dt)
    o, lse = _launch(q, k, v, 0, 0, with_lse=True, causal=False)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    n0 = _lib.LAUNCHES["flash_attention_bwd"]
    flash_attention(qg, kg, vg, causal=False).backward(do)
    assert _lib.LAUNCHES["flash_attention_bwd"] == n0 + 1
    got = (qg.grad, kg.grad, vg.grad)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    torch.cuda.synchronize()
    if T == 1:
        _bwd_within(got[2:], want[2:], dt)
        lim = 1e-5 * float(want[2].float().abs().max())
        for a, b in zip(got[:2], want[:2]):
            assert float(a.float().abs().max()) <= lim
            assert float(b.float().abs().max()) <= lim
    else:
        _bwd_within(got, want, dt)
    for a, c in zip(got, again):
        assert torch.equal(a, c)


def test_encdec_decode_step_captured_reads_cross_kv_in_place(dev):
    """The encoder-decoder's decode step (reduced whisper-base, bf16, fp
    KV) captured in the static Engine: graph tokens = the eager loop's; the
    cross-attention KV the graph reads is the tensor the prefill filled
    (in place, unchanged by the steps), the self-attention KV the graph
    writes equals the eager loop's; a contiguous pool of 2 slots, each
    request with its own frames, gives the static B = 1 Engine's tokens;
    the non-causal attention ran on the card."""
    from repro_torch.configs import QuantConfig, get_config, reduced
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import ContinuousEngine, Request
    cfg = reduced(get_config("whisper-base"), dtype="bfloat16")
    api = build(cfg, "cuda")
    params = api.init_params(torch.Generator(dev).manual_seed(0))
    cushion = api.extract_cushion(params, torch.tensor([1, 2, 3]), None,
                                  QuantConfig())

    def batch(b, s, seed):
        return api.make_batch(torch.Generator(dev).manual_seed(seed), b, s)

    eng = Engine(api, params, QuantConfig(), cushion=cushion, max_seq=96)
    b = {k: v for k, v in batch(2, 30, 1).items() if k != "labels"}
    eng.generate(b, 4)                      # captures B = 2's step
    st = eng.states[2]
    xk_at = st.cache["xk"].data_ptr()
    _lib.reset_launches()
    got = eng.generate(b, 12)
    assert _lib.COUNTERS["graph_replays"] == 11
    assert _lib.LAUNCHES["flash_attention"] > 0
    cache = {k: t.clone() for k, t in st.cache.items()}
    eager = eng.generate_py(b, 12)
    assert (got.tokens == eager.tokens).all()
    assert st.cache["xk"].data_ptr() == xk_at
    for k in cache:
        assert torch.equal(st.cache[k], cache[k]), k
    reqs = [Request(uid=i, batch={k: v for k, v in batch(1, 20 + 3 * i,
                                                         10 + i).items()
                                  if k != "labels"}, max_new_tokens=5)
            for i in range(5)]
    ce = ContinuousEngine(api, params, QuantConfig(), n_slots=2, max_seq=96,
                          cushion=cushion)
    _lib.reset_launches()
    outs = ce.run(reqs)
    assert _lib.COUNTERS["graph_replays"] == ce.stats.steps > 0
    for r, o in zip(reqs, outs):
        want = eng.generate_py(r.batch, r.max_new_tokens).tokens[0]
        assert (o.tokens == want).all(), r.uid
    _counters_zero([ce.graph, st.graph])


def test_xlstm_decode_step_captured_with_its_state_tree(dev):
    """The xLSTM's decode step (reduced xlstm-350m, bf16, W8A8 with
    int8-resident w_proj) captured in the static Engine: graph tokens =
    the eager loop's and every leaf of the state tree the graph leaves =
    the eager loop's, bit for bit, in the tensors it was captured on; a
    pool of 2 slots (the nested axes) gives the static B = 1 Engine's
    tokens."""
    import numpy as np
    from repro_torch.configs import QuantConfig, get_config, reduced
    from repro_torch.core.calibration import calibrate
    from repro_torch.models.registry import build
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import ContinuousEngine, Request
    cfg = reduced(get_config("xlstm-350m"), dtype="bfloat16")
    api = build(cfg, "cuda")
    params = api.init_params(torch.Generator(dev).manual_seed(0))
    rs = np.random.RandomState(6)

    def tokens(b, s):
        return {"tokens": torch.as_tensor(
            rs.randint(0, 256, (b, s)).astype(np.int32), device=dev)}

    qw8 = QuantConfig(mode="pt_static", true_int8=True)
    cushion = api.extract_cushion(params, torch.tensor([1, 2, 3]), None,
                                  QuantConfig())
    scales, _ = calibrate(api, params, [tokens(2, 24)], qw8,
                          cushion=cushion)
    eng = Engine(api, params, qw8, cushion=cushion, scales=scales,
                 max_seq=96, prequant=True)
    b = tokens(2, 30)
    eng.generate(b, 4)
    st = eng.states[2]
    at = [t.data_ptr() for t in tree_leaves(st.cache)]
    _lib.reset_launches()
    got = eng.generate(b, 12)
    assert _lib.COUNTERS["graph_replays"] == 11
    state = [t.clone() for t in tree_leaves(st.cache)]
    eager = eng.generate_py(b, 12)
    assert (got.tokens == eager.tokens).all()
    assert [t.data_ptr() for t in tree_leaves(st.cache)] == at
    for a, c in zip(tree_leaves(st.cache), state):
        assert torch.equal(a, c)
    reqs = [Request(uid=i, batch=tokens(1, 20 + 3 * i), max_new_tokens=5)
            for i in range(5)]
    ce = ContinuousEngine(api, params, qw8, n_slots=2, max_seq=96,
                          cushion=cushion, scales=scales, prequant=True)
    _lib.reset_launches()
    outs = ce.run(reqs)
    assert _lib.COUNTERS["graph_replays"] == ce.stats.steps > 0
    for r, o in zip(reqs, outs):
        want = eng.generate_py(r.batch, r.max_new_tokens).tokens[0]
        assert (o.tokens == want).all(), r.uid
    _counters_zero([ce.graph, st.graph])


# ---------------------------------------------------------------------------
# One-card training (train/trainer.py): smollm-360m's attention at its
# training shapes, and a step at its full width over two layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("S", [256, 2048])
def test_flash_attention_bwd_at_training_shapes(dev, S, dt):
    """The backward at the trainer's shapes: B = 8, 15 heads over 5
    kv-heads (G = 3), head_dim 64, no cushion (m = 0: every key row live),
    S = 256 (the launcher's default) and 2048 (RunConfig's seq_len),
    against its plain version; two calls identical."""
    q, k, v, o, lse, do = _bwd_case(dev, 8, 5, 3, S, 0, 0, 64, dt, S)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, 0, 0)
    got = flash_attention_bwd(q, k, v, o, lse, do, 0, 0)
    again = flash_attention_bwd(q, k, v, o, lse, do, 0, 0)
    torch.cuda.synchronize()
    _bwd_within(got, want, dt)
    for a, c in zip(got, again):
        assert torch.equal(a, c)


def _smollm_two_layers(dev, dtype):
    """smollm-360m at full width over 2 layers (seeded weights made on the
    CPU), a B = 2 x 64 batch, and the train step's pieces on ``dev``."""
    import dataclasses
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.models.registry import build
    from repro_torch.train.trainer import make_optimizer, make_train_step
    cfg = dataclasses.replace(get_config("smollm-360m"), n_layers=2,
                              dtype=dtype)
    cpu = build(cfg, "cpu")
    params = cpu.init_params(torch.Generator().manual_seed(0)).tree()
    batch = cpu.make_batch(torch.Generator().manual_seed(1), 2, 64)
    api = build(cfg, dev)
    run = RunConfig(model=cfg, seq_len=64, global_batch=2, lr=1e-3,
                    train_steps=20, warmup_steps=10)
    opt = make_optimizer(run)
    to = lambda t: {k: to(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.to(api.device)   # noqa: E731
    p = to(params)
    return (api, run, opt, p, to(batch), make_train_step(api, run, opt),
            (cpu, params, batch))


def _first_moments(state):
    from repro_torch.optim.adamw import tree_leaves
    return [t.float().cpu() for t in tree_leaves(state.mu)]


def test_train_step_card_equals_cpu(dev):
    """One step of smollm at full width over 2 layers on the card against
    the port's CPU step: in f32 the loss within 1e-5 relative and each
    first moment (0.1 x the clipped gradient) within 1e-5 of its leaf's
    largest entry; in bf16 the card's first moments no farther from the
    CPU's f32 ones than the CPU's bf16 ones are, within 1.5x in L2 (phase
    4c's bar: the two sides round to bf16 at the same points but reduce in
    other orders)."""
    from repro_torch.train.trainer import make_optimizer, make_train_step
    mus, losses = {}, {}
    for dtype in ("float32", "bfloat16"):
        api, run, opt, p, b, step, (cpu, cp, cb) = _smollm_two_layers(
            dev, dtype)
        _, s, m = step(p, opt.init(p), b)
        _, cs, cm = make_train_step(cpu, run, opt)(cp, opt.init(cp), cb)
        mus[dtype] = (_first_moments(s), _first_moments(cs))
        losses[dtype] = (float(m["loss"]), float(cm["loss"]))
    card, ref = mus["float32"]
    assert abs(losses["float32"][0] / losses["float32"][1] - 1) <= 1e-5
    for a, c in zip(card, ref):
        assert float((a - c).abs().max()) <= 1e-5 * float(c.abs().max())

    def dist(x, y):
        return float(torch.cat([(a - c).reshape(-1) for a, c in zip(x, y)])
                     .norm() / torch.cat([c.reshape(-1) for c in y]).norm())
    card_bf, cpu_bf = mus["bfloat16"]
    assert dist(card_bf, ref) <= 1.5 * dist(cpu_bf, ref)
    assert abs(losses["bfloat16"][0] / losses["bfloat16"][1] - 1) <= 1e-2


def test_train_step_is_deterministic_with_exact_launches(dev):
    """Two identical bf16 steps on the card are bit-identical (the
    attention backward has no atomics; the embedding's backward and every
    other op of the step are deterministic), and a step launches
    flash_attention twice a layer with remat (the recompute) and
    flash_attention_bwd once, once and once without."""
    import dataclasses
    from repro_torch.train.trainer import make_train_step
    api, run, opt, p, b, step, _ = _smollm_two_layers(dev, "bfloat16")
    outs = []
    for _ in range(2):
        _lib.reset_launches()
        outs.append(step(p, opt.init(p), b))
        assert _lib.LAUNCHES["flash_attention"] == 4
        assert _lib.LAUNCHES["flash_attention_bwd"] == 2
    from repro_torch.optim.adamw import tree_leaves

    def leaves(out):
        p_, s_, m_ = out
        return tree_leaves([p_, s_.mu, s_.nu, s_.step, m_])
    for a, c in zip(leaves(outs[0]), leaves(outs[1])):
        assert torch.equal(a, c)
    off = dataclasses.replace(run, parallel=dataclasses.replace(
        run.parallel, remat=False))
    _lib.reset_launches()
    got = make_train_step(api, off, opt)(p, opt.init(p), b)
    assert _lib.LAUNCHES["flash_attention"] == 2
    assert _lib.LAUNCHES["flash_attention_bwd"] == 2
    for a, c in zip(leaves(got), leaves(outs[0])):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_true_int_dot_ptoken_card_equals_plain(dev, dt):
    """``true_int_dot`` under ptoken_dynamic on the card: its route (the
    int product through the w8a8_matmul kernel with unit scales, then the
    per-row epilogue) equal bit for bit to the CPU's plain route on the
    same weight codes and per-row scales, at a decode and a prefill M.
    (The scales themselves are tensor ops, which PyTorch's CUDA kernels
    compute an ulp off the CPU's where they divide by a Python number,
    ROADMAP queue 3.)"""
    from repro_torch.configs import QuantConfig
    from repro_torch.core import quantization as Q
    q = QuantConfig(mode="ptoken_dynamic", true_int8=True)
    g = torch.Generator().manual_seed(0)
    for M in (4, 300):
        x = torch.randn(M, 960, generator=g).to(dt)
        x[1, 7] = 40.0
        w = (torch.randn(960, 2560, generator=g) * 0.05).to(dt)
        xc = x.to(dev)
        wq, s_w = Q.weight_quant_int(w.to(dev), q)
        s_x, z_x = Q.params_from_minmax(*Q.act_minmax(xc, True), 8, False)
        _lib.reset_launches()
        got = Q._ptoken_int_matmul(xc, wq, s_w, s_x, z_x, q)
        assert _lib.LAUNCHES["w8a8_matmul"] == 1
        want = Q._ptoken_int_matmul(x, wq.cpu(), s_w.cpu(), s_x.cpu(),
                                    z_x.cpu(), q)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(Q.true_int_dot(xc, w.to(dev), q, None), got)


def test_capture_with_a_host_sync_raises(dev):
    """A step that syncs with the host cannot be captured: the capture
    raises, nothing runs eagerly in its place, and the card still works
    (this test runs last in the file)."""
    from repro_torch.serving.graphs import CapturedStep
    x = torch.zeros(4, device=dev)

    def step():
        if x.sum().item() >= 0:             # a host sync
            x.add_(1)

    with pytest.raises(RuntimeError):
        CapturedStep(step, dev)
    torch.cuda.synchronize()
    assert x.tolist() == [2.0] * 4          # the two warm-up steps only
    y = torch.arange(4.0, device=dev) * 2
    torch.cuda.synchronize()
    assert y.tolist() == [0.0, 2.0, 4.0, 6.0]


# ---------------------------------------------------------------------------
# Tensor parallelism: the int matmul's int32 mode, the per-rank decode
# attention and two gloo ranks on the card
# ---------------------------------------------------------------------------

# deepseek-67b at tp = 2: the row-parallel sites' shards (wo: K = 4096 of
# 8192 query-head columns; w_down: K = 11008 of 22016) at decode and in
# tensor-core tiles
TP_CASES = [(M, K, 8192) for M in (4, 256, 2048) for K in (4096, 11008)]


@pytest.mark.parametrize("M,K,N", TP_CASES)
def test_w8a8_int32_mode_bit_exact(dev, M, K, N):
    """out_dtype=torch.int32: the accumulator, equal to the plain
    version's, from int8 codes and (M <= 16) from f32 / bf16 activations
    quantized in the staging; and two K-halves' accumulators summed, with
    the epilogue applied once (``w8a8_epilogue``), equal to the whole
    launch in f32 and bf16."""
    from repro_torch.kernels.w8a8_matmul import w8a8_epilogue
    x, w = _w8_case(dev, M, K, N, M + K)
    sx, zx = (torch.tensor(v, device=dev) for v in (0.031, 111.0))
    sw = torch.tensor(0.0042, device=dev).to(torch.bfloat16)
    acc = w8a8_matmul(x, w, sx, zx, sw, out_dtype=torch.int32)
    assert acc.dtype == torch.int32
    assert torch.equal(acc, w8a8_matmul_plain(x, w, sx, zx, sw,
                                              out_dtype=torch.int32))
    if M <= 16:
        xf = _fp_x(dev, M, K, M + K + 1)
        for t in (xf, xf.to(torch.bfloat16)):
            _lib.reset_launches()
            a = quant_w8a8_matmul(t, w, sx, zx, sw, out_dtype=torch.int32)
            assert _lib.LAUNCHES["act_quant_static_fused"] == 1
            assert torch.equal(a, quant_w8a8_matmul_plain(
                t, w, sx, zx, sw, out_dtype=torch.int32)), t.dtype
    h = K // 2
    halves = [w8a8_matmul(x[:, s].contiguous(), w[s].contiguous(), sx, zx,
                          sw, out_dtype=torch.int32)
              for s in (slice(0, h), slice(h, K))]
    colsum = w.sum(0, dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        whole = w8a8_matmul(x, w, sx, zx, sw, colsum, -128.0, dt)
        summed = w8a8_epilogue(halves[0] + halves[1], sx, zx, sw, colsum,
                               -128.0, dt)
        assert torch.equal(whole, summed), dt


def test_decode_attention_tp_slice_equals_whole(dev):
    """Each rank's ``decode_attention_tp`` (its 32 query heads of 64, 4 KV
    heads of 8, head_dim 128, G = 8: deepseek-67b at tp = 2) on an int8
    cache with the cushion block whole is the whole launch's heads, bit
    for bit, and so is the paged entry; the whole launch and each rank's
    are within the bar of ``flash_decode_plain`` on the same inputs (one
    bf16 ulp plus 1e-5 of the largest entry, as at G = 4 and 6)."""
    from repro_torch.kernels.ops import (decode_attention_tp,
                                         decode_attention_tp_paged)
    from repro_torch.launch.mesh import TPMesh
    B, H, K, hd, S, m = 4, 64, 8, 128, 640, 4
    g = torch.Generator(dev).manual_seed(3)
    q = torch.randn((B, H, hd), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randint(-127, 128, (B, S, K, hd), generator=g, device=dev,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (B, S, K, hd), generator=g, device=dev,
                      dtype=torch.int8)
    ks = torch.rand((B, K), generator=g, device=dev) * 0.05 + 0.01
    vs = torch.rand((B, K), generator=g, device=dev) * 0.05 + 0.01
    kc = torch.randn((m, K, hd), generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn((m, K, hd), generator=g, device=dev).to(torch.bfloat16)
    pos = torch.tensor([600, 37, -1, 4], dtype=torch.int32, device=dev)
    whole = flash_decode(q, k, v, pos, k_scale=ks, v_scale=vs, kc=kc, vc=vc)
    _bwd_within((whole,), (flash_decode_plain(q, k, v, pos, k_scale=ks,
                                              v_scale=vs, kc=kc, vc=vc),),
                torch.bfloat16)
    ps = 64
    P = S // ps
    table = (1 + torch.arange(B * P, device=dev, dtype=torch.int32)
             ).reshape(B, P)
    for r in range(2):
        mesh = TPMesh(r, 2, None, dev, None)
        hs, kh = slice(32 * r, 32 * r + 32), slice(4 * r, 4 * r + 4)
        lk, lv = k[:, :, kh].contiguous(), v[:, :, kh].contiguous()
        lq = q[:, hs].contiguous()
        kw = dict(k_scale=ks[:, kh].contiguous(),
                  v_scale=vs[:, kh].contiguous(), kc=kc, vc=vc)
        got = decode_attention_tp(lq, lk, lv, pos, mesh, **kw)
        assert torch.equal(got, whole[:, hs]), r
        _bwd_within((got,), (flash_decode_plain(
            lq, lk, lv, pos, **dict(kw, kc=kc[:, kh], vc=vc[:, kh])),),
            torch.bfloat16)
        pages = [torch.cat([t.new_zeros((1, ps, 4, hd)),
                            t.reshape(B * P, ps, 4, hd)]) for t in (lk, lv)]
        got = decode_attention_tp_paged(lq, pages[0], pages[1], table, pos,
                                        mesh, **kw)
        assert torch.equal(got, whole[:, hs]), r


def test_tp2_gloo_ranks_on_the_card(dev):
    """Two ranks of deepseek-67b at full width and 2 layers (int8-resident
    W8A8, int8 KV, a 4-token cushion) over gloo on the card: their prefill
    logits and tokens are the unsharded engine's, bit for bit (the
    row-parallel sites sum int32 accumulators), and each rank launches
    every kernel as often as the unsharded engine."""
    import dataclasses

    from repro_torch.configs import QuantConfig, get_config
    from repro_torch.core.calibration import calibrate, scales_to_plain
    from repro_torch.launch.mesh import TPMesh, spawn_tp
    from repro_torch.models.registry import build
    import _tp_probe as tp_probe
    cfg = dataclasses.replace(get_config("deepseek-67b"), n_layers=2)
    qw8 = QuantConfig(mode="pt_static", true_int8=True)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    case = dict(cfg=cfg, seed=0, kind="static", qcfg=qw8, prequant=True,
                kv_dtype="int8", tokens=toks.numpy(), n_tokens=4,
                logits=True, max_seq=128, warmup=True)
    api = build(cfg, dev)
    params = tp_probe._params(api, case)
    cushion = api.extract_cushion(
        params, torch.tensor([5, 6, 7, 8], dtype=torch.int32), None,
        QuantConfig())
    scales, _ = calibrate(api, params, [{"tokens": toks.to(dev)}], qw8,
                          cushion=cushion)

    def cpu(t):
        if isinstance(t, dict):
            return {k: cpu(v) for k, v in t.items()}
        return t.cpu()
    case.update(cushion=cpu(cushion), scales=cpu(scales_to_plain(scales)))
    one = tp_probe.run_case(TPMesh(0, 1, None, dev, None),
                            dict(case, mesh=False))
    del params, cushion, scales
    tp_probe._TREES.clear()
    torch.cuda.empty_cache()
    ranks = spawn_tp(tp_probe.run_cases, 2, [case], device="cuda",
                     every_rank=True, backend="gloo")
    for rank, (rep,) in enumerate(ranks):
        assert rep["backend"] == "gloo"
        assert (rep["logits"] == one["logits"]).all(), rank
        assert (rep["tokens"] == one["tokens"]).all(), rank
        assert rep["launches"] == one["launches"], rank
        assert rep["launches"]["w8a8_matmul"] > 0


def _dp_cases():
    """smollm-360m at full width and 2 layers (bf16): three pt_dynamic
    tuning steps (B = 2 x 64, one row a rank) and three FSDP train steps
    (B = 4 x 64), on two gloo ranks of the card and on one rank."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import CushionConfig, QuantConfig, get_config
    cfg = dataclasses.replace(get_config("smollm-360m"), n_layers=2)
    rs = np.random.RandomState(26)

    def batch(b, s):
        t = rs.randint(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}
    tune = dict(kind="tune", name="tune", cfg=cfg, seed=0,
                cushion_ids=[1, 198, 400], qcfg=QuantConfig(mode="pt_dynamic"),
                ccfg=CushionConfig(tune_steps=3, tune_lr=1e-3, lam=0.05,
                                   log_every=3),
                batches=[batch(2, 64) for _ in range(3)])
    train = dict(kind="train", name="train", cfg=cfg, seed=0,
                 batches=[batch(4, 64) for _ in range(3)], batch_rows=4,
                 seq=64, steps=3, lr=1e-3, warmup=10, one_rank=True)
    return cfg, tune, train


def test_dp2_gloo_ranks_tune_and_train_on_the_card(dev):
    """Two gloo ranks of the card against one rank: prefix tuning with the
    cushion replicated (every rank's cushion equal after every step, the
    launches a rank equal to one rank's, the logs within phase 4l's bars:
    CE 1e-3, loss / range / L_q 0.1, the tuned cushions' mean difference
    below a quarter of their move) and shard_train_step with FSDP shards
    (launches 2 L / L a step with remat, half of every "D" leaf and f32
    moments of it a rank, the losses within 1e-2 and the first moments
    within 0.1 in L2, cosine 0.99, of one rank's make_train_step)."""
    import numpy as np

    from repro_torch.launch.mesh import make_tp_mesh, spawn_mesh
    import _dp_probe as dp_probe
    cfg, tune, train = _dp_cases()
    L = cfg.n_layers
    one = dp_probe.run_case(make_tp_mesh(1, device="cuda"), tune)
    torch.cuda.empty_cache()
    (t0, r0), (t1, r1) = spawn_mesh(dp_probe.run_cases, 2, 1, [tune, train],
                                    device="cuda", every_rank=True,
                                    backend="gloo")
    assert t0["backend"] == "gloo" and t0["fingerprint"] == t1["fingerprint"]
    for t in (t0, t1):
        assert all(x["ranks_equal"] == 1.0 for x in t["log"])
        assert t["launches"] == one["launches"]
        assert t["launches"]["flash_attention"] == 3 * L
        assert t["launches"]["flash_attention_bwd"] == 3 * L
    for a, b in zip(t0["log"], one["log"]):
        assert abs(a["ce"] / b["ce"] - 1) <= 1e-3
        for k in ("loss", "range", "qerr"):
            assert abs(a[k] / b[k] - 1) <= 0.1, (k, a[k], b[k])
    for k in ("k", "v"):
        move = np.abs(one["cushion"]["kv"][k] - one["start"]["kv"][k]).mean()
        diff = np.abs(t0["cushion"]["kv"][k] - one["cushion"]["kv"][k])
        assert diff.mean() < 0.25 * move, (k, diff.mean(), move)
    assert r0["metrics"] == r1["metrics"]
    for r in (r0, r1):
        assert all(x["flash_attention"] == 2 * L and
                   x["flash_attention_bwd"] == L for x in r["launches"])
        for lf in r["leaves"].values():
            share = 2 if "data" in lf["spec"] else 1
            assert lf["shard"] * share == lf["full"]
            assert lf["moments"] == 2 * lf["shard"]
            assert lf["moment_dtype"] == "torch.float32"
    # the last data rank runs the one-rank comparison (tests/_dp_probe.py)
    o = r1["one"]
    rel = [abs(a["loss"] / b["loss"] - 1)
           for a, b in zip(r1["metrics"], o["metrics"])]
    assert rel[0] <= 1e-2 and max(rel) <= 5e-2, rel
    assert o["moments"]["rel_l2"] <= 0.1, o["moments"]
    assert o["moments"]["cosine"] >= 0.99, o["moments"]


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "fp"])
def test_kv_head_window_into_a_whole_cache(dev, quantized):
    """A rank's KV-head window into a whole cache (the query heads cut,
    the KV heads whole: the reduced VLM and hybrid at tp = 4, one query
    head a rank over 2 KV heads; here 2 query heads a rank of 8 over 4 KV
    heads, head_dim 64, bf16): the decode and paged decode kernels with
    ``kv_heads`` equal, bit for bit, the kernel on the window copied
    contiguous (int8 with (B, K) scales and the cushion block, and fp), and
    lie within the bar of the plain version; the prefill kernel on the
    window's strided view equals it on a contiguous copy, bit for bit."""
    B, H, K, hd, S, m, tp = 3, 8, 4, 64, 320, 4, 4
    Hl = H // tp
    G = H // K
    g = torch.Generator(dev).manual_seed(17)
    bf = torch.bfloat16
    pos = torch.tensor([300, 5, -1], dtype=torch.int32, device=dev)
    if quantized:
        k = torch.randint(-127, 128, (B, S, K, hd), generator=g, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (B, S, K, hd), generator=g, device=dev,
                          dtype=torch.int8)
        kw = dict(k_scale=torch.rand((B, K), generator=g, device=dev) * 0.05
                  + 0.01,
                  v_scale=torch.rand((B, K), generator=g, device=dev) * 0.05
                  + 0.01,
                  kc=torch.randn((m, K, hd), generator=g, device=dev).to(bf),
                  vc=torch.randn((m, K, hd), generator=g, device=dev).to(bf))
    else:
        k = torch.randn((B, S, K, hd), generator=g, device=dev).to(bf)
        v = torch.randn((B, S, K, hd), generator=g, device=dev).to(bf)
        kw = {}
    ps = 64
    P = S // ps
    table = (1 + torch.randperm(B * P, generator=g, device=dev)
             ).to(torch.int32).reshape(B, P)
    pages = []
    for t in (k, v):
        pg = t.new_zeros((1 + B * P, ps, K, hd))
        pg[table.reshape(-1).long()] = t.reshape(B * P, ps, K, hd)
        pages.append(pg)
    for r in range(tp):
        kv0 = r * Hl // G
        q = torch.randn((B, Hl, hd), generator=g, device=dev).to(bf)
        win = dict(kw)
        if quantized:
            win.update(k_scale=kw["k_scale"][:, kv0:kv0 + 1].contiguous(),
                       v_scale=kw["v_scale"][:, kv0:kv0 + 1].contiguous(),
                       kc=kw["kc"][:, kv0:kv0 + 1].contiguous(),
                       vc=kw["vc"][:, kv0:kv0 + 1].contiguous())
        lk = k[:, :, kv0:kv0 + 1].contiguous()
        lv = v[:, :, kv0:kv0 + 1].contiguous()
        want = flash_decode(q, lk, lv, pos, **win)
        got = flash_decode(q, k, v, pos, kv_heads=(kv0, 1), **kw)
        assert torch.equal(got, want), r
        _bwd_within((got,), (flash_decode_plain(
            q, k, v, pos, kv_heads=(kv0, 1), **kw),), bf)
        paged = flash_decode_paged(q, pages[0], pages[1], table, pos,
                                   kv_heads=(kv0, 1), **kw)
        assert torch.equal(paged, got), r
        # the prefill: the window of the fresh KV as a strided view
        Sp = 80
        qp = torch.randn((B, Sp, Hl, hd), generator=g, device=dev).to(bf)
        kp = torch.randn((B, Sp + m, K, hd), generator=g, device=dev).to(bf)
        vp = torch.randn((B, Sp + m, K, hd), generator=g, device=dev).to(bf)
        view = [t.narrow(2, kv0, 1).transpose(1, 2) for t in (kp, vp)]
        copy = [t.narrow(2, kv0, 1).contiguous().transpose(1, 2)
                for t in (kp, vp)]
        a = flash_attention(qp.transpose(1, 2), *view, prefix_len=m)
        assert torch.equal(a, flash_attention(qp.transpose(1, 2), *copy,
                                              prefix_len=m)), r
        _within_ulp(a, flash_attention_plain(qp.transpose(1, 2), *copy,
                                             prefix_len=m))


def _int32_halves_equal_whole(dev, M, K, N, seed):
    """``w8a8_matmul``'s int32 mode at a row-parallel shard of tp = 2 (a
    rank's K / 2 rows of a (K, N) weight): decode (M <= 16, bf16 x
    quantized in the staging) and prefill (int8 codes) equal their plain
    versions, and the two ranks' int32 partials summed, with the epilogue
    once, equal the whole weight's launch, bit for bit."""
    from repro_torch.kernels.w8a8_matmul import w8a8_epilogue
    g = torch.Generator(dev).manual_seed(seed)
    bf = torch.bfloat16
    sx, zx = (torch.tensor(v_, device=dev) for v_ in (0.027, 119.0))
    sw = torch.tensor(0.0039, device=dev).to(bf)
    w = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    colsum = w.sum(0, dtype=torch.int32)
    h = K // 2
    if M <= 16:
        x = (torch.randn((M, K), generator=g, device=dev) * 3).to(bf)
        parts = [quant_w8a8_matmul(x[:, s].contiguous(), w[s].contiguous(),
                                   sx, zx, sw, out_dtype=torch.int32)
                 for s in (slice(0, h), slice(h, K))]
        for i, s in enumerate((slice(0, h), slice(h, K))):
            assert torch.equal(parts[i], quant_w8a8_matmul_plain(
                x[:, s].contiguous(), w[s].contiguous(), sx, zx, sw,
                out_dtype=torch.int32))
        whole = quant_w8a8_matmul(x, w, sx, zx, sw, colsum, out_dtype=bf)
    else:
        x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                          dtype=torch.int8)
        parts = [w8a8_matmul(x[:, s].contiguous(), w[s].contiguous(), sx,
                             zx, sw, out_dtype=torch.int32)
                 for s in (slice(0, h), slice(h, K))]
        for i, s in enumerate((slice(0, h), slice(h, K))):
            assert torch.equal(parts[i], w8a8_matmul_plain(
                x[:, s].contiguous(), w[s].contiguous(), sx, zx, sw,
                out_dtype=torch.int32))
        whole = w8a8_matmul(x, w, sx, zx, sw, colsum, -128.0, bf)
    assert torch.equal(whole, w8a8_epilogue(parts[0] + parts[1], sx, zx, sw,
                                            colsum, -128.0, bf))


@pytest.mark.parametrize("M", [4, 2048])
def test_int32_mode_at_mamba_out_shard(dev, M):
    """The int32 mode at jamba-v0.1-52b's ``mamba_out`` shard of tp = 2
    (K = 4096 of the 8192 channels, N = 4096)
    (``_int32_halves_equal_whole``)."""
    _int32_halves_equal_whole(dev, M, 8192, 4096, 29)


# whisper-base at a rank of tp = 2: 4 of its 8 heads of 64, d_ff 1,024 of
# 2,048, 1,500 frames, B = 4, the decoder's prompt 256 (+ a 4-row cushion)
WH_B, WH_T, WH_PROMPT = 4, 1500, 256


@pytest.mark.parametrize("M", [WH_B, WH_B * WH_PROMPT])
@pytest.mark.parametrize("K", [512, 2048], ids=["xattn_wo", "w_down"])
def test_int32_mode_at_whisper_shards(dev, M, K):
    """The int32 mode at whisper-base's row-parallel shards of tp = 2: the
    attention's and the cross-attention's ``wo`` (K = 512, 4 heads of 64 a
    rank) and ``w_down`` (K = 2,048, 1,024 a rank), N = 512
    (``_int32_halves_equal_whole``)."""
    _int32_halves_equal_whole(dev, M, K, 512, 31 + K + M)


@pytest.mark.parametrize("S,T", [(WH_T, WH_T), (WH_PROMPT, WH_T),
                                 (1, WH_T)],
                         ids=["encoder", "cross-prefill", "cross-decode"])
def test_noncausal_attention_at_a_whisper_rank(dev, S, T):
    """The non-causal ``flash_attention`` on a rank's 4 heads of whisper's 8
    (the encoder, S = T = 1,500; the cross-attention's prefill over the
    frames, S = 256, and its decode, S = 1), through ``ops.attention`` as
    the model calls it on the rank's (B, S, 4, 64) q and cross KV: each
    rank's launch equals the whole launch's heads bit for bit (a head's
    result depends on that head alone), within one bf16 ulp of the plain
    version."""
    from repro_torch.kernels import ops
    g = torch.Generator(dev).manual_seed(S + T)
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(  # noqa
        torch.bfloat16)
    q, k, v = mk(WH_B, S, 8, 64), mk(WH_B, T, 8, 64), mk(WH_B, T, 8, 64)
    whole = ops.attention(q, k, v, causal=False)
    n0 = _lib.LAUNCHES["flash_attention"]
    for r in range(2):
        hs = slice(4 * r, 4 * r + 4)
        lq, lk, lv = (t[:, :, hs].contiguous() for t in (q, k, v))
        got = ops.attention(lq, lk, lv, causal=False)
        assert torch.equal(got, whole[:, :, hs]), r
        _within_ulp(got.transpose(1, 2), flash_attention_plain(
            lq.transpose(1, 2), lk.transpose(1, 2), lv.transpose(1, 2),
            causal=False))
    assert _lib.LAUNCHES["flash_attention"] == n0 + 2


# the attention of a rank's tensor-parallel training step (tp = 2, bf16,
# chip_smoke.py phase 4l (f)): whisper-base's 4 heads of 64, B = 4, over
# its 1,500 frames (the encoder, non-causal, S = T = 1,500; the
# cross-attention, non-causal, S = 256 over T = 1,500) and its decoder's
# causal self-attention (S = 256); internvl2-26b's 24 query heads over 4 KV
# heads (G = 6) of head_dim 128, causal, B = 2 x (1,024 patches + 256 text
# tokens)
TP_TRAIN_ATTN = [("whisper-encoder", 4, 4, 1, WH_T, WH_T, 64, False),
                 ("whisper-cross", 4, 4, 1, WH_PROMPT, WH_T, 64, False),
                 ("whisper-self", 4, 4, 1, WH_PROMPT, WH_PROMPT, 64, True),
                 ("internvl2", 2, 4, 6, 1280, 1280, 128, True)]


@pytest.mark.parametrize("name,B,Kh,G,S,T,hd,causal", TP_TRAIN_ATTN,
                         ids=[c[0] for c in TP_TRAIN_ATTN])
def test_attention_at_a_tp_training_rank(dev, name, B, Kh, G, S, T, hd,
                                         causal):
    """``flash_attention`` and, through autograd, ``flash_attention_bwd`` at
    a tensor-parallel training rank's shapes against their plain versions:
    the forward within one bf16 ulp, the backward within the backward's
    bars (one bf16 ulp plus 1e-5 of the largest entry) on the kernel's own
    output and log-sum-exp; one launch of each."""
    from repro_torch.kernels.flash_attention import _launch
    q, k, v = _nc_inputs(dev, B, Kh, G, S, T, hd, torch.bfloat16,
                         S + T + G + hd)
    do = torch.randn(q.shape, generator=torch.Generator(dev).manual_seed(S),
                     device=dev).to(torch.bfloat16)
    n_f = _lib.LAUNCHES["flash_attention"]
    n_b = _lib.LAUNCHES["flash_attention_bwd"]
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = flash_attention(qg, kg, vg, causal=causal)
    out.backward(do)
    assert _lib.LAUNCHES["flash_attention"] == n_f + 1
    assert _lib.LAUNCHES["flash_attention_bwd"] == n_b + 1
    _within_ulp(out.detach(), flash_attention_plain(q, k, v, causal=causal))
    o, lse = _launch(q, k, v, 0, 0, with_lse=True, causal=causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    _bwd_within((qg.grad, kg.grad, vg.grad), want, torch.bfloat16)


def test_flash_decode_at_a_whisper_rank(dev):
    """The decoder's self-attention decode on a rank's 4 heads (G = 1, the
    fp cache with the cushion's rows in it, per-row positions) through
    ``ops.decode_attention_tp``: each rank's launch equals the whole
    launch's heads bit for bit, within the bar of ``flash_decode_plain``
    (one bf16 ulp plus 1e-5 of the largest entry)."""
    from repro_torch.kernels.ops import decode_attention_tp
    from repro_torch.launch.mesh import TPMesh
    g = torch.Generator(dev).manual_seed(7)
    smax = 384
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(  # noqa
        torch.bfloat16)
    q, k, v = mk(WH_B, 8, 64), mk(WH_B, smax, 8, 64), mk(WH_B, smax, 8, 64)
    pos = torch.tensor([4 + WH_PROMPT + 16, 37, 300, 4], dtype=torch.int32,
                       device=dev)
    whole = flash_decode(q, k, v, pos)
    for r in range(2):
        hs = slice(4 * r, 4 * r + 4)
        lq, lk, lv = q[:, hs].contiguous(), k[:, :, hs].contiguous(), \
            v[:, :, hs].contiguous()
        got = decode_attention_tp(lq, lk, lv, pos, TPMesh(r, 2, None, dev,
                                                          None))
        assert torch.equal(got, whole[:, hs]), r
        _bwd_within((got,), (flash_decode_plain(lq, lk, lv, pos),),
                    torch.bfloat16)


@pytest.mark.parametrize("M,K,N,group", W4_CASES + [(4, 4096, 8192, 128),
                                                    (2048, 4096, 8192, 128)])
def test_w4a8_accumulator_mode_bit_exact(dev, M, K, N, group):
    """W4A8's f32 accumulator mode (``accumulate=True``: sum_g s_w[g] acc_g,
    no epilogue), both regimes, s_w in f32 and bf16, and at M <= 16 the
    fused staging of an f32 / bf16 activation: equal to the plain version
    bit for bit (deepseek-67b's ``wo`` shard at tp = 2: K 4,096, N 8,192);
    its launches count under ``w4a8_matmul_acc``."""
    x, wp, s_w, _ = _w4_case(dev, M, K, N, group, M + K + N + 1)
    sx, zx = (torch.tensor(v, device=dev) for v in (0.031, 111.0))
    for sw in (s_w, s_w.to(torch.bfloat16)):
        _lib.reset_launches()
        a = w4a8_matmul(x, wp, sx, zx, sw, None, group, accumulate=True)
        assert _lib.LAUNCHES["w4a8_matmul_acc"] == 1
        assert _lib.LAUNCHES["w4a8_matmul"] == 0
        b = w4a8_matmul_plain(x, wp, sx, zx, sw, None, group,
                              accumulate=True)
        torch.cuda.synchronize()
        assert a.dtype == torch.float32 and torch.equal(a, b)
        if M <= 16:
            for xf in (_fp_x(dev, M, K, M + 3),
                       _fp_x(dev, M, K, M + 3).to(torch.bfloat16)):
                a = quant_w4a8_matmul(xf, wp, sx, zx, sw, None, group,
                                      accumulate=True)
                b = quant_w4a8_matmul_plain(xf, wp, sx, zx, sw, None, group,
                                            accumulate=True)
                torch.cuda.synchronize()
                assert torch.equal(a, b), xf.dtype


@pytest.mark.parametrize("M,D", [(1, 7), (4, 4096), (5, 100), (2048, 4096),
                                 (4, 11008), (300, 8192)])
def test_act_quant_ptoken_range_and_given_modes(dev, M, D):
    """The per-token kernel's range-only mode and its given-range mode,
    f32 and bf16 input, equal to their plain versions bit for bit; the
    given range of the two halves of every row (their min and max) gives
    each half the whole row's codes, scale and zero (deepseek-67b's
    row-parallel shards at tp = 2: D 4,096 and 11,008)."""
    g = torch.Generator(dev).manual_seed(M * D)
    x = torch.randn((M, D), generator=g, device=dev) * 3 + 0.2
    x[1 % M] = 0.0
    x[2 % M] = x[2 % M].abs() + 0.1
    for t in (x, x.to(torch.bfloat16)):
        _lib.reset_launches()
        rng = act_quant_ptoken_range(t)
        assert _lib.LAUNCHES["act_quant_ptoken_range"] == 1
        for u, v in zip(rng, act_quant_ptoken_range_plain(t)):
            assert torch.equal(u, v), t.dtype
        whole = act_quant_ptoken(t)
        if D < 2:
            continue
        h = D // 2
        halves = (t[:, :h].contiguous(), t[:, h:].contiguous())
        rs = [act_quant_ptoken_range(p) for p in halves]
        mn = torch.minimum(rs[0][0], rs[1][0])
        mx = torch.maximum(rs[0][1], rs[1][1])
        parts = []
        for p in halves:
            _lib.reset_launches()
            got = act_quant_ptoken(p, rng=(mn, mx))
            assert _lib.LAUNCHES["act_quant_ptoken_given"] == 1
            assert _lib.LAUNCHES["act_quant_ptoken"] == 0
            for u, v in zip(got, act_quant_ptoken_plain(p, rng=(mn, mx))):
                assert torch.equal(u, v), t.dtype
            parts.append(got)
        assert torch.equal(torch.cat([p[0] for p in parts], 1), whole[0])
        for p in parts:
            assert torch.equal(p[1], whole[1]) and torch.equal(p[2], whole[2])
