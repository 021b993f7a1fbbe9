"""The arithmetic the port's attention kernels follow on the card, pinned
down on the CPU by plain emulations kept here (the package has none: on a
CPU tensor the wrappers run their plain versions).

* Split-KV decode (``csrc/flash_decode.cu``): each row's positions are cut
  into fixed 64-position chunks; a chunk yields (max, sum, p V) and the
  chunks are merged in chunk order (in f32; the kernel takes the scores'
  dot products in f64). It must equal the plain version and the JAX Pallas
  kernel (interpret mode) within 1e-6 of the largest |v| it averages (f32:
  only the order of the sums differs, and each rounding is relative to the
  dequantized values summed; the plain version and the Pallas kernel
  differ from each other by up to 6e-7 of it), with pos on chunk edges, a
  cache length that is no multiple of 64, retired rows with and without a
  cushion, and (K,) and (B, K) int8 scales; and a row's result must not
  depend on the batch.
* Tiled prefill attention (``csrc/flash_attention.cu``): 64-key tiles from
  key 0, f32 scores and online softmax (the kernel takes e^x as
  2^(x log2 e)), P split in three bf16 terms before P V (the tensor cores
  take bf16). It must stay within one bf16 ulp of the plain version on
  bf16 inputs: the check the card holds the kernel to.
* The tensor-core backward (``csrc/flash_attention_bwd.cu``, bf16): dK/dV
  by 64-key tiles of one head, its query tiles cut in ``BWD_CHUNKS``
  chunks, each chunk's P^T dO and dS^T Q summed in 16-query steps with P
  and dS split in ``BWD_TERMS`` bf16 terms; the chunks and heads of a
  kv-head summed in rank order (head, then chunk); dQ by 64-query tiles
  over the key tiles they see (dead tiles skipped), dS K in 16-key steps,
  S and dP recomputed. It must stay within the card's bar of
  ``flash_attention_bwd_plain`` (one bf16 ulp plus 1e-5 of the largest
  entry) and, before the bf16 rounding, within 2e-5 of the largest entry
  of ``jax.grad`` of the reference's ``flash_attention_jnp``; one bf16
  term must miss the bar where the kernel keeps two.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_decode import flash_decode as j_flash_decode  # noqa: E402
from repro.kernels.flash_decode import \
    flash_decode_paged as j_flash_decode_paged  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_plain, flash_attention_plain)
from repro_torch.kernels.flash_decode import (  # noqa: E402
    flash_decode_paged_plain, flash_decode_plain, gather_pages)

NEG_INF = -1e30
BF16_ULP = 2.0 ** -7
TILE = 64                    # keys per tile of csrc/flash_attention.cu
CHUNK = 64                   # positions per chunk (CH) of csrc/flash_decode.cu


def split_kv_decode(q, k, v, pos, k_scale=None, v_scale=None, kc=None,
                    vc=None, chunk=CHUNK):
    """The split-KV kernel's function: fixed chunks of ``chunk`` positions
    per row, each reduced to (m, l, acc), merged in chunk order."""
    B, H, hd = q.shape
    Smax, K = k.shape[1], k.shape[2]
    G = H // K
    m = 0 if kc is None else kc.shape[0]
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        ksc = k_scale.float() if k_scale.dim() == 2 else \
            k_scale.float()[None].expand(B, K)
        vsc = v_scale.float() if v_scale.dim() == 2 else \
            v_scale.float()[None].expand(B, K)
        kf = kf * ksc[:, None, :, None]
        vf = vf * vsc[:, None, :, None]
    if m:
        kf[:, :m] = kc.float()[None]
        vf[:, :m] = vc.float()[None]
    posv = torch.as_tensor(pos, dtype=torch.int64).reshape(-1).expand(B)
    scale = 1.0 / math.sqrt(hd)
    out = torch.zeros((B, H, hd), dtype=torch.float32)
    for b in range(B):
        last = max(min(int(posv[b]), Smax - 1), m - 1)
        n_live = 0 if last < 0 else last // chunk + 1
        for kh in range(K):
            qg = q[b, kh * G:(kh + 1) * G].float()
            parts = []
            for c in range(n_live):
                t0, t1 = c * chunk, min(c * chunk + chunk, last + 1)
                s = (qg @ kf[b, t0:t1, kh].T) * scale
                mc = s.max(dim=-1).values
                p = torch.exp(s - mc[:, None])
                parts.append((mc, p.sum(-1), p @ vf[b, t0:t1, kh]))
            M = torch.full((G,), NEG_INF)
            for mc, _, _ in parts:
                M = torch.maximum(M, mc)
            L, A = torch.zeros(G), torch.zeros(G, hd)
            for mc, l, acc in parts:
                w = torch.exp(mc - M)
                L = L + l * w
                A = A + acc * w[:, None]
            out[b, kh * G:(kh + 1) * G] = A / torch.clamp(L, min=1e-30)[:, None]
    return out.to(q.dtype)


def split3(p):
    """p as three bf16 terms: p1 = bf16(p), p2 = bf16(p - p1),
    p3 = bf16(p - p1 - p2)."""
    p1 = p.to(torch.bfloat16).float()
    r1 = p - p1
    p2 = r1.to(torch.bfloat16).float()
    p3 = (r1 - p2).to(torch.bfloat16).float()
    return p1, p2, p3


def tiled_attention(q, k, v, prefix_len, tile=TILE):
    """The tensor-core prefill kernel's function: 64-query blocks, 64-key
    tiles from key 0 up to the block's last visible key, f32 scores and
    online softmax, P V with P in three bf16 terms (one f32 accumulator,
    16-key steps), output acc / max(l, 1e-30) in q's dtype."""
    B, H, S, hd = q.shape
    Kh, T = k.shape[1], k.shape[2]
    G = H // Kh
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty((B, H, S, hd), dtype=torch.float32)
    for q0 in range(0, S, tile):
        rows = torch.arange(q0, min(q0 + tile, S))
        t_end = min(q0 + tile + prefix_len, T)
        m = torch.full((B, H, len(rows)), NEG_INF)
        l = torch.zeros((B, H, len(rows)))
        acc = torch.zeros((B, H, len(rows), hd))
        for t0 in range(0, t_end, tile):
            keys = torch.arange(t0, t0 + tile)
            kt = torch.zeros((B, H, tile, hd))
            vt = torch.zeros((B, H, tile, hd))
            n = min(tile, T - t0)
            kt[:, :, :n], vt[:, :, :n] = kf[:, :, t0:t0 + n], \
                vf[:, :, t0:t0 + n]
            valid = (keys[None] < T) & ((keys[None] < prefix_len)
                                        | (keys[None] <= rows[:, None]
                                           + prefix_len))
            s = torch.where(valid, (qf[:, :, rows] @ kt.transpose(-1, -2))
                            * scale, torch.tensor(NEG_INF))
            mx = torch.maximum(m, s.max(dim=-1).values)
            alpha = torch.exp(m - mx)
            p = torch.where(valid, torch.exp(s - mx[..., None]),
                            torch.tensor(0.0))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None]
            terms = split3(p)
            for kk in range(0, tile, 16):
                for term in terms:
                    acc = acc + term[..., kk:kk + 16] @ vt[:, :, kk:kk + 16]
            m = mx
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def _case(mode, B, K, G, hd, Smax, m, seed):
    rs = np.random.RandomState(seed)
    q = torch.from_numpy(rs.randn(B, K * G, hd).astype(np.float32))
    kw = {}
    if mode == "fp":
        k = torch.from_numpy(rs.randn(B, Smax, K, hd).astype(np.float32))
        v = torch.from_numpy(rs.randn(B, Smax, K, hd).astype(np.float32))
    else:
        k = torch.from_numpy(rs.randint(-127, 128, (B, Smax, K, hd))
                             .astype(np.int8))
        v = torch.from_numpy(rs.randint(-127, 128, (B, Smax, K, hd))
                             .astype(np.int8))
        shape = (B, K) if mode == "int8-BK" else (K,)
        kw = dict(k_scale=torch.from_numpy(
                      (rs.rand(*shape) * 0.05 + 0.01).astype(np.float32)),
                  v_scale=torch.from_numpy(
                      (rs.rand(*shape) * 0.05 + 0.01).astype(np.float32)),
                  kc=torch.from_numpy(rs.randn(m, K, hd).astype(np.float32)),
                  vc=torch.from_numpy(rs.randn(m, K, hd).astype(np.float32)))
    return q, k, v, kw


def _close(ours, other, v, kw):
    """Within 1e-6 of the largest dequantized |v| (absolute), and 1e-6
    relative."""
    vmax = float((v.float() * (kw["v_scale"].max() if "v_scale" in kw
                               else 1.0)).abs().max())
    np.testing.assert_allclose(ours, other, rtol=1e-6, atol=1e-6 * vmax)


def _jax(kw):
    return {n: jnp.asarray(x.numpy()) for n, x in kw.items()}


# a cache of 136 positions (two full chunks and 8 more); pos at m - 1 (the
# cushion only), on both sides of the first chunk edge, the last position,
# and retired
SMAX, M_CUSHION = 136, 4
POS = [M_CUSHION - 1, 63, 64, 65, SMAX - 1, -1]


@pytest.mark.parametrize("mode", ["fp", "int8-K", "int8-BK"])
def test_split_kv_decode_matches_plain_and_pallas(mode):
    """fp: the retired row is zeros; int8 with a cushion: the retired row
    attends the cushion only."""
    B, K, G, hd = len(POS), 2, 3, 16
    m = 0 if mode == "fp" else M_CUSHION
    q, k, v, kw = _case(mode, B, K, G, hd, SMAX, m, seed=len(mode))
    pos = torch.tensor(POS, dtype=torch.int32)
    ours = split_kv_decode(q, k, v, pos, **kw)
    plain = flash_decode_plain(q, k, v, pos, **kw)
    pallas = j_flash_decode(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                            jnp.asarray(v.numpy()), jnp.asarray(POS),
                            bkv=8, interpret=True, **_jax(kw))
    for other in (plain.numpy(), np.asarray(pallas)):
        _close(ours.numpy(), other, v, kw)
    if mode == "fp":
        assert not ours[-1].any()


@pytest.mark.parametrize("mode", ["fp-cushion", "int8-BK"])
def test_split_kv_decode_paged_matches_plain_and_pallas(mode):
    """The paged pool (page size 32, a shuffled table, junk in scratch page
    0): the same chunks over the gathered rows."""
    B, K, G, hd, ps, P = len(POS), 2, 3, 16, 32, 5
    Smax = P * ps
    pos = [p if p < Smax else Smax - 1 for p in POS]
    q, k, v, kw = _case("fp" if mode.startswith("fp") else mode, B, K, G, hd,
                        Smax, M_CUSHION, seed=7)
    if mode == "fp-cushion":
        rs = np.random.RandomState(8)
        kw = dict(kc=torch.from_numpy(rs.randn(M_CUSHION, K, hd)
                                      .astype(np.float32)),
                  vc=torch.from_numpy(rs.randn(M_CUSHION, K, hd)
                                      .astype(np.float32)))
    n_pages = B * P + 1
    perm = np.random.RandomState(9).permutation(n_pages - 1) + 1
    table = torch.from_numpy(perm.astype(np.int32).reshape(B, P))

    def paginate(dense):
        pages = torch.full((n_pages, ps, K, hd), 99, dtype=dense.dtype)
        pages[table.reshape(-1).long()] = dense.reshape(B * P, ps, K, hd)
        return pages

    kp, vp = paginate(k), paginate(v)
    ptens = torch.tensor(pos, dtype=torch.int32)
    ours = split_kv_decode(q, gather_pages(kp, table),
                           gather_pages(vp, table), ptens, **kw)
    plain = flash_decode_paged_plain(q, kp, vp, table, ptens, **kw)
    pallas = j_flash_decode_paged(
        jnp.asarray(q.numpy()), jnp.asarray(kp.numpy()),
        jnp.asarray(vp.numpy()), jnp.asarray(table.numpy()),
        jnp.asarray(pos), interpret=True, **_jax(kw))
    for other in (plain.numpy(), np.asarray(pallas)):
        _close(ours.numpy(), other, vp, kw)


def test_split_kv_decode_row_independent_of_batch():
    """Row b of a batch is the row computed alone, bit for bit (the chunks
    and the merge order depend on the row's positions only), and the
    plain version agrees within the tolerance above."""
    q, k, v, kw = _case("int8-BK", 4, 2, 3, 16, SMAX, M_CUSHION, seed=3)
    pos = torch.tensor([64, 100, -1, SMAX - 1], dtype=torch.int32)
    full = split_kv_decode(q, k, v, pos, **kw)
    for b in range(4):
        one = {n: (x[b:b + 1] if n.endswith("scale") else x)
               for n, x in kw.items()}
        alone = split_kv_decode(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                pos[b:b + 1], **one)
        assert torch.equal(full[b:b + 1], alone)
        _close(alone.numpy(), flash_decode_plain(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], pos[b:b + 1],
            **one).numpy(), v, kw)


def test_split3_is_exact():
    """p1 + p2 + p3 carries p's 24 bits: the sum equals p in f32."""
    p = torch.from_numpy(np.random.RandomState(0).rand(4096)
                         .astype(np.float32))
    p = torch.cat([p, p * 1e-20, torch.zeros(1), torch.ones(1)])
    p1, p2, p3 = split3(p)
    assert torch.equal((p3 + p2) + p1, p)


@pytest.mark.parametrize("seed", [0, 1])
def test_tiled_attention_split3_within_one_bf16_ulp(seed):
    """B = 1, 6 query heads over 2 kv-heads, S = 200 behind a 4-key
    cushion, hd = 64, bf16 inputs: the three-term split keeps the plain
    version's one-ulp check (|err| <= 2^-7 |want| + 1e-6)."""
    rs = np.random.RandomState(seed)
    B, H, Kh, S, hd, m = 1, 6, 2, 200, 64, 4
    bf = torch.bfloat16
    q = torch.from_numpy(rs.randn(B, H, S, hd).astype(np.float32)).to(bf)
    k = torch.from_numpy(rs.randn(B, Kh, S + m, hd).astype(np.float32)).to(bf)
    v = torch.from_numpy(rs.randn(B, Kh, S + m, hd).astype(np.float32)).to(bf)
    got = tiled_attention(q, k, v, m).float()
    want = flash_attention_plain(q, k, v, prefix_len=m).float()
    err = (got - want).abs()
    assert bool((err <= BF16_ULP * want.abs() + 1e-6).all()), \
        float(err.max())


# ---------------------------------------------------------------------------
# the tensor-core backward
# ---------------------------------------------------------------------------

BWD_TERMS = 2                # P_TERMS = DS_TERMS in csrc/flash_attention_bwd.cu
BWD_CHUNKS = 2               # QCHUNKS: query chunks a (head, key tile)
LOG2E = np.float32(1.4426950408889634)


def split_terms(x, n):
    """x as n bf16 terms: term t is the nearest bf16 of what terms 0..t-1
    leave (``split_terms`` in csrc/attention_mma.cuh)."""
    terms, r = [], x
    for _ in range(n):
        t_ = r.to(torch.bfloat16).float()
        terms.append(t_)
        r = r - t_
    return terms


def tc_product(x, y, n):
    """x (..., M, K) f32 in n bf16 terms times y (..., K, N) bf16 values,
    one f32 accumulator, K in 16-deep steps, every term of a step before
    the next step (``mma_xt2``)."""
    acc = torch.zeros(x.shape[:-1] + (y.shape[-1],))
    terms = split_terms(x, n)
    for kk in range(0, x.shape[-1], 16):
        for term in terms:
            acc = acc + term[..., kk:kk + 16] @ y[..., kk:kk + 16, :]
    return acc


def _rows(x, r0, n_rows, tile=TILE):
    """Rows [r0, r0 + tile) of x (..., R, d) with rows past n_rows zero."""
    out = torch.zeros(x.shape[:-2] + (tile, x.shape[-1]))
    n = max(0, min(tile, n_rows - r0))
    out[..., :n, :] = x[..., r0:r0 + n, :]
    return out


def tiled_attention_bwd(q, k, v, o, lse, do, prefix_len, prefix_live,
                        terms=BWD_TERMS, chunks=BWD_CHUNKS, tile=TILE):
    """The bf16 backward kernel's function in f32 (outputs not rounded):
    (dq, dk, dv) of (B, H, S, hd) q and (B, Kh, T, hd) k, v, given the
    forward's o and log-sum-exp."""
    B, H, S, hd = q.shape
    Kh, T = k.shape[1], k.shape[2]
    G, P, LV = H // Kh, prefix_len, prefix_live
    scale = np.float32(1.0 / math.sqrt(hd))
    c2 = np.float32(1.4426950408889634 / math.sqrt(hd))
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    D = (dof * o.float()).sum(-1)
    nl = -(lse.float() * LOG2E)                     # -(lse log2 e)
    n_qt = -(-S // tile)

    def vis(i, j):
        return (j < T) & (i < S) & ((j < LV) | ((j >= P) & (j <= i + P)))

    def p_ds(s, dp, rows_nl, rows_d, m):
        p = torch.where(m, torch.exp2(s * c2 + rows_nl), torch.zeros(()))
        return p, torch.where(m, p * (dp - rows_d), torch.zeros(()))

    # dK, dV: a block per (head, key tile, query chunk); its dK scaled; the
    # blocks of a kv-head summed in rank order (head, then chunk)
    dk = torch.zeros((B, Kh, T, hd))
    dv = torch.zeros((B, Kh, T, hd))
    for t0 in range(0, T, tile):
        keys = torch.arange(t0, t0 + tile)
        kt, vt = _rows(kf, t0, T), _rows(vf, t0, T)
        qt0 = (0 if t0 < LV else max(0, t0 - P)) // tile
        nq = n_qt - qt0
        cs = -(-nq // chunks)
        dead = t0 >= LV and t0 + tile <= P
        parts = []
        for c in range(chunks):
            pk, pv = torch.zeros((B, H, tile, hd)), torch.zeros((B, H, tile, hd))
            for qt in range(qt0 + c * cs, qt0 + min(nq, (c + 1) * cs)):
                if dead:
                    break
                i0 = qt * tile
                rows = torch.arange(i0, i0 + tile)
                qt_, dt_ = _rows(qf, i0, S), _rows(dof, i0, S)
                m = vis(rows[None, :], keys[:, None])
                p, ds = p_ds(kt @ qt_.transpose(-1, -2),
                             vt @ dt_.transpose(-1, -2),
                             _rows(nl[..., None], i0, S)[..., 0][..., None, :],
                             _rows(D[..., None], i0, S)[..., 0][..., None, :],
                             m)
                pv = pv + tc_product(p, dt_, terms)
                pk = pk + tc_product(ds, qt_, terms)
            parts.append((pk * scale, pv))
        n = min(tile, T - t0)
        for kh in range(Kh):
            sk = sv = None
            for g in range(G):
                for pk, pv in parts:
                    h = kh * G + g
                    sk = pk[:, h] if sk is None else sk + pk[:, h]
                    sv = pv[:, h] if sv is None else sv + pv[:, h]
            dk[:, kh, t0:t0 + n] = sk[:, :n]
            dv[:, kh, t0:t0 + n] = sv[:, :n]

    # dQ: a block per (head, query tile) over the key tiles its rows see
    dq = torch.zeros((B, H, S, hd))
    lo = -(-LV // tile)
    n_dead = max(0, P // tile - lo)
    for i0 in range(0, S, tile):
        rows = torch.arange(i0, i0 + tile)
        qt_, dt_ = _rows(qf, i0, S), _rows(dof, i0, S)
        rnl = _rows(nl[..., None], i0, S)
        rd = _rows(D[..., None], i0, S)
        acc = torch.zeros((B, H, tile, hd))
        n_tiles = -(-min(T, i0 + tile + P) // tile) - n_dead
        for j in range(n_tiles):
            t0 = (j if j < lo else j + n_dead) * tile
            keys = torch.arange(t0, t0 + tile)
            kt, vt = _rows(kf, t0, T), _rows(vf, t0, T)
            m = vis(rows[:, None], keys[None, :])
            _, ds = p_ds(qt_ @ kt.transpose(-1, -2),
                         dt_ @ vt.transpose(-1, -2), rnl, rd, m)
            acc = acc + tc_product(ds, kt, terms)
        n = min(tile, S - i0)
        dq[:, :, i0:i0 + n] = (acc * scale)[:, :, :n]
    return dq, dk, dv


def _bwd_inputs(B, Kh, G, S, m, live, hd, seed, dtype=torch.bfloat16):
    rs = np.random.RandomState(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rs.randn(*s).astype(np.float32)).to(dtype)
    q, k, v = mk(B, Kh * G, S, hd), mk(B, Kh, S + m, hd), mk(B, Kh, S + m, hd)
    do = mk(B, Kh * G, S, hd)
    o, lse = flash_attention_plain(q, k, v, prefix_len=m, prefix_live=live,
                                   return_lse=True)
    return q, k, v, o, lse, do


def _outside_bar(got, want):
    """Entries outside the card's bar: one bf16 ulp of the plain value plus
    1e-5 of its largest entry (got rounded to bf16 first)."""
    n = 0
    for a, b in zip(got, want):
        a, b = a.to(torch.bfloat16).float(), b.float()
        lim = BF16_ULP * b.abs() + 1e-5 * float(b.abs().max())
        n += int(((a - b).abs() > lim).sum())
    return n


# (S, m, live, G): S a multiple of the 64-row tile, one less, one more; the
# prefix all live, one live row, none; T = S + m ragged; dead whole key
# tiles (m = 130, live 0) and a key tile across the dead rows' edge
BWD_CASES = [(64, 4, 4, 3), (63, 4, 1, 1), (65, 4, 0, 3), (128, 5, 5, 1),
             (127, 37, 0, 3), (65, 70, 20, 1), (64, 130, 0, 3)]


@pytest.mark.parametrize("S,m,live,G", BWD_CASES)
def test_tiled_attention_bwd_matches_plain_and_jax(S, m, live, G):
    """The emulated kernel against ``flash_attention_bwd_plain`` on bf16
    inputs (the card's bar) and, in f32 before any bf16 rounding, against
    ``jax.grad`` of the reference's ``flash_attention_jnp`` on the same
    values (2e-5 of the largest entry: the two-term split leaves ~2^-17 of
    each product and the sums run in another order; up to 5.2e-6
    measured); dead rows exactly zero."""
    B, Kh, hd = 2, 2, 32
    q, k, v, o, lse, do = _bwd_inputs(B, Kh, G, S, m, live, hd,
                                      seed=S + m + live + G)
    got = tiled_attention_bwd(q, k, v, o, lse, do, m, live)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, m, live)
    assert _outside_bar(got, want) == 0
    assert not got[1][:, :, live:m].any() and not got[2][:, :, live:m].any()

    # f32 against the reference's gradient: the same bf16-valued inputs,
    # the f32 forward's o and log-sum-exp
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    of, lsef = flash_attention_plain(qf, kf, vf, prefix_len=m,
                                     prefix_live=live, return_lse=True)
    got32 = tiled_attention_bwd(qf, kf, vf, of, lsef, dof, m, live)

    def jf(q_, k_, v_):
        out = JC.flash_attention_jnp(q_, k_, v_, None, causal=True,
                                     prefix_len=m,
                                     prefix_valid=jnp.arange(m) < live)
        return jnp.sum(out * jnp.asarray(dof.numpy().transpose(0, 2, 1, 3)))

    jq, jk, jv = (jnp.asarray(x.numpy().transpose(0, 2, 1, 3))
                  for x in (qf, kf, vf))
    jg = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(jq, jk, jv)
    for a, b in zip(got32, jg):
        b = np.asarray(b).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-5 * np.abs(b).max())


def test_tiled_attention_bwd_one_term_misses_the_bar():
    """The tuning shape's heads (15 over 5, hd 64), S = 256 behind a 4-row
    cushion: P and dS rounded once to bf16 put outputs outside the card's
    bar; the two terms the kernel keeps put none there."""
    q, k, v, o, lse, do = _bwd_inputs(1, 5, 3, 256, 4, 4, 64, seed=11)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, 4, 4)
    one = tiled_attention_bwd(q, k, v, o, lse, do, 4, 4, terms=1)
    two = tiled_attention_bwd(q, k, v, o, lse, do, 4, 4, terms=2)
    assert _outside_bar(one, want) > 0
    assert _outside_bar(two, want) == 0
