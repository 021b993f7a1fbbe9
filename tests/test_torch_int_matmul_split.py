"""The arithmetic the port's int matmul kernels follow on the card
(``csrc/int_matmul.cuh``), pinned down on the CPU by plain emulations kept
here (the package has none: on a CPU tensor the wrappers run their plain
versions).

* Decode (M <= 16): K is cut into the kernel's slices (32-deep k-steps
  inside one group, a step masked at the group's end, ``cs`` steps a slice,
  ``cs`` chosen from the shape as ``int_matmul_launch`` chooses it), each
  slice an int32 partial of its group; the slices of a group add exactly
  (the workspace's atomics); the groups' partials are merged in group order
  and the epilogue applied.
* Prefill (M > 16): 32-deep tiles inside each group, int32 partials added
  per group, each group folded into the f32 sum at its end (a single W4A8
  group scaled at the end), then the epilogue.

Both must equal ``w8a8_matmul_plain`` / ``w4a8_matmul_plain`` bit for bit
(``torch.equal``) with s_w in f32 and in bf16 (the weight's dtype, read as
stored) and in both output dtypes: int32 sums are exact in any order, and
every f32 step is one separately rounded tensor op, as the kernel rounds
each step on its own. The column maps of the two regimes (n8 tile j of a
lane group holds columns {16 g + j} at decode, {4 g + j} at prefill) are
checked to be permutations that the stores undo. Last, the plain versions
with bf16 s_w agree with JAX's oracles and Pallas kernels (interpret mode)
to the bars of ``test_torch_kernels.py`` and ``test_torch_w4a8.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import quantization as JQ  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.kernels.w4a8_matmul import w4a8_matmul as j_w4a8  # noqa: E402
from repro.kernels.w8a8_matmul import w8a8_matmul as j_w8a8  # noqa: E402
from repro_torch.kernels.w4a8_matmul import (unpack_int4,  # noqa: E402
                                             w4a8_matmul_plain)
from repro_torch.kernels.w8a8_matmul import w8a8_matmul_plain  # noqa: E402

# csrc/int_matmul.cuh
STEP = 32                    # k per mma.sync m16n8k32 step
D_NW, D_BN, D_MAXCS, D_TARGET_BLOCKS = 4, 128, 32, 264
P_BK = 32
Z_SHIFT = -128.0


def decode_slices(N, K, group):
    """The decode launch's slices: for every group, [k0, k1) ranges of at
    most ``cs`` steps (``int_matmul_launch``)."""
    tiles, G = -(-N // D_BN), K // group
    spg = -(-group // STEP)
    cs = -(-tiles * G * spg // D_TARGET_BLOCKS)
    cs = -(-cs // D_NW) * D_NW
    cs = min(max(cs, D_NW), D_MAXCS)
    cs = min(cs, spg)
    cpg = -(-spg // cs)
    out = []
    for g in range(G):
        gk0, gk1 = g * group, (g + 1) * group
        out.append([(gk0 + STEP * c * cs,
                     min(gk0 + STEP * min((c + 1) * cs, spg), gk1))
                    for c in range(cpg)])
    return out


def prefill_tiles(K, group):
    """The prefill loop's 32-deep tiles, per group (a tile never crosses
    the group's end)."""
    return [[(k0, min(k0 + P_BK, (g + 1) * group))
             for k0 in range(g * group, (g + 1) * group, P_BK)]
            for g in range(K // group)]


def int_part(x, w, k0, k1):
    """Exact int32 partial over k in [k0, k1) (f64 holds it exactly)."""
    p = x[:, k0:k1].double() @ w[k0:k1].double()
    return p.to(torch.int64).to(torch.int32)


def group_partials(x, w, ranges):
    """Each group's int32 partial: its pieces added, exact in any order
    (added here last piece first, as atomics may)."""
    parts = []
    for pieces in ranges:
        acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int64)
        for k0, k1 in reversed(pieces):
            acc += int_part(x, w, k0, k1)
        parts.append(acc.to(torch.int32))
    return parts


def epilogue_w8(P, s_x, z_x, s_w, colsum, out_dtype):
    z = z_x.float() + Z_SHIFT
    scale = s_x.float() * s_w.float()
    return ((P.float() - z * colsum.float()) * scale).to(out_dtype)


def epilogue_w4(parts, s_x, z_x, s_w, colsum, out_dtype):
    f = torch.zeros(parts[0].shape, dtype=torch.float32)
    for g, P in enumerate(parts):                 # group order
        f = f + P.float() * s_w[g].float()
    z = z_x.float() + Z_SHIFT
    return ((f - z * colsum.float()) * s_x.float()).to(out_dtype)


def emulate(x, w, M, K, group, N):
    ranges = decode_slices(N, K, group) if M <= 16 \
        else prefill_tiles(K, group)
    return group_partials(x, w, ranges)


# (M, K, N, group): smollm's (K, N) pairs (qkv 960 x 1600, o 960 x 960,
# up/gate 960 x 2560, down 2560 x 960) in both regimes, groups of 64, 128
# and 960, a ragged N, K and groups that are no multiples of 32
CASES = [(1, 960, 1600, 960), (4, 960, 1600, 960), (16, 960, 960, 960),
         (4, 960, 2560, 960), (4, 2560, 960, 128), (4, 2560, 960, 2560),
         (17, 2560, 960, 128), (37, 960, 1600, 960), (256, 960, 960, 960),
         (4, 2560, 960, 64), (37, 2560, 960, 64), (16, 960, 102, 960),
         (4, 200, 102, 100), (37, 200, 102, 100), (1, 36, 7, 12),
         (256, 100, 40, 100)]


@pytest.mark.parametrize("M,K,N,group", CASES)
def test_split_emulation_equals_plain(M, K, N, group):
    rs = np.random.RandomState(M * 7 + K + N)
    x = torch.from_numpy(rs.randint(-128, 128, (M, K)).astype(np.int8))
    w = torch.from_numpy(rs.randint(-127, 128, (K, N)).astype(np.int8))
    wq = torch.from_numpy(rs.randint(-7, 8, (K, N)).astype(np.int8))
    packed = JQ.pack_int4(jnp.asarray(wq.numpy()))
    packed = torch.from_numpy(np.array(packed))
    s_x, z_x = torch.tensor(0.031), torch.tensor(111.0)
    s_w8 = torch.tensor(0.0042)
    s_w4 = torch.from_numpy((rs.rand(K // group, N) * 0.02 + 1e-3)
                            .astype(np.float32))
    colsum8 = w.to(torch.int32).sum(0)
    colsum4 = torch.from_numpy(rs.randn(N).astype(np.float32))
    assert torch.equal(unpack_int4(packed, K), wq)
    # W8A8 is one group of K
    p8 = emulate(x, w, M, K, K, N)
    p4 = emulate(x, wq, M, K, group, N)
    assert len(p8) == 1 and len(p4) == K // group
    for cast in (torch.float32, torch.bfloat16):
        sw8, sw4 = s_w8.to(cast), s_w4.to(cast)
        for out_dtype in (torch.float32, torch.bfloat16):
            got8 = epilogue_w8(p8[0], s_x, z_x, sw8, colsum8, out_dtype)
            want8 = w8a8_matmul_plain(x, w, s_x, z_x, sw8, colsum8,
                                      Z_SHIFT, out_dtype)
            assert torch.equal(got8, want8), (cast, out_dtype)
            got4 = epilogue_w4(p4, s_x, z_x, sw4, colsum4, out_dtype)
            want4 = w4a8_matmul_plain(x, packed, s_x, z_x, sw4, colsum4,
                                      group, Z_SHIFT, out_dtype)
            assert torch.equal(got4, want4), (cast, out_dtype)


def test_slices_cover_k_once():
    """Every k of every group lies in exactly one slice (decode) or tile
    (prefill); the decode launch gives every smollm layer site at least 64
    blocks and the tied head one slice per column tile (384 blocks)."""
    for K, N, group in ((960, 1600, 960), (960, 960, 960), (960, 2560, 960),
                        (2560, 960, 2560), (2560, 960, 128), (960, 49152, 960),
                        (200, 102, 100), (36, 7, 12)):
        for ranges in (decode_slices(N, K, group), prefill_tiles(K, group)):
            seen = torch.zeros(K, dtype=torch.int64)
            for g, pieces in enumerate(ranges):
                for k0, k1 in pieces:
                    assert g * group <= k0 < k1 <= (g + 1) * group
                    seen[k0:k1] += 1
            assert bool((seen == 1).all()), (K, N, group)
        blocks = -(-N // D_BN) * sum(len(p) for p in decode_slices(N, K,
                                                                   group))
        if N == 49152:
            assert blocks == 384
        elif K >= 960:
            assert blocks >= 64, (K, N, group, blocks)


def test_fragment_column_maps_are_permutations():
    """Decode: lane group g loads columns 16 g .. 16 g + 15 of a 128-column
    tile and n8 tile j of the MMA holds columns {16 g + j}; the fragment's
    column n' = 2 q + e of tile j is stored at 16 n' + j. Prefill: a warp's
    32 columns, n8 tile j holding {4 g + j}, stored at 4 (2 q + e) + j.
    Both cover each column once and agree with the load map."""
    for width, per in ((128, 16), (32, 4)):
        loaded = {(g, j): per * g + j for g in range(8) for j in range(per)}
        stored = {}
        for j in range(per):
            for q in range(4):
                for e in range(2):
                    n_frag = 2 * q + e         # B column of the MMA = g
                    stored[(n_frag, j)] = per * n_frag + j
        assert stored == loaded
        assert sorted(stored.values()) == list(range(width))


def test_plain_with_bf16_scales_matches_jax():
    """The plain versions with bf16 s_w (the weight's dtype, as
    ``prequantize`` now keeps it) against JAX's oracles and Pallas kernels
    in interpret mode: W8A8 within 1 ulp (XLA may contract the zero-point
    subtract into an FMA), W4A8 within rtol 1e-4, atol 1e-3 (the
    reference's own bar between its routes)."""
    rs = np.random.RandomState(3)
    M, K, N = 37, 256, 256
    x = rs.randint(-128, 128, (M, K)).astype(np.int8)
    w = rs.randint(-127, 128, (K, N)).astype(np.int8)
    s_x, z_x = np.float32(0.031), np.float32(-17.0)
    s_w = jnp.asarray(0.0042, jnp.bfloat16)
    ours = w8a8_matmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                             torch.tensor(s_x), torch.tensor(z_x),
                             torch.tensor(float(s_w)).to(torch.bfloat16))
    ref = R.w8a8_matmul_ref(jnp.asarray(x), jnp.asarray(w), s_x, z_x, s_w)
    pallas = j_w8a8(jnp.asarray(x), jnp.asarray(w), s_x, z_x, s_w, bn=128,
                    bk=128, interpret=True)
    for want in (ref, pallas):
        np.testing.assert_array_max_ulp(ours.numpy(),
                                        np.asarray(want, np.float32), 1)
    group = 64
    wq = rs.randint(-7, 8, (K, N)).astype(np.int8)
    packed = np.array(JQ.pack_int4(jnp.asarray(wq)))
    s_w4 = jnp.asarray(rs.rand(K // group, N) * 0.02 + 1e-3, jnp.bfloat16)
    colsum = np.asarray(
        (jnp.asarray(wq.astype(np.int32).reshape(K // group, group, N)
                     .sum(1), jnp.float32) * s_w4).sum(0))
    ref4 = R.w4a8_matmul_ref(jnp.asarray(x), jnp.asarray(packed),
                             jnp.float32(s_x), jnp.float32(z_x), s_w4,
                             group_size=group)
    pal4 = j_w4a8(jnp.asarray(x), jnp.asarray(packed), s_x, z_x, s_w4,
                  jnp.asarray(colsum), group_size=group, interpret=True)
    got4 = w4a8_matmul_plain(
        torch.from_numpy(x), torch.from_numpy(packed), torch.tensor(s_x),
        torch.tensor(z_x),
        torch.from_numpy(np.asarray(s_w4, np.float32)).to(torch.bfloat16),
        torch.from_numpy(colsum), group)
    for want in (ref4, pal4):
        np.testing.assert_allclose(got4.numpy(), np.asarray(want, np.float32),
                                   rtol=1e-4, atol=1e-3)
