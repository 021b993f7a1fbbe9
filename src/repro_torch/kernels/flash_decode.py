"""Single-query decode attention over a contiguous KV cache or a paged KV
pool (kernels + plain versions).

``flash_decode``: q (B, H, hd); k/v (B, Smax, K, hd), fp, or int8 with
dequant scales k_scale/v_scale, (K,) shared by the batch or (B, K) per row
(the continuous pool's per-slot scales); kc/vc (m, K, hd) fp cushion
covering positions [0, m) (int8 caches only: an fp cache holds the cushion
in-cache); pos () or (B,) int32. Row b attends positions <= pos[b] (and the
whole cushion); pos < 0 retires a row.

``flash_decode_paged``: the same function through a page table. k/v are a
flat (n_pages, ps, K, hd) page store and page_table (B, P) int32 maps row
b's logical page j (positions [j*ps, (j+1)*ps)) to a physical page; page 0
is scratch. kc/vc are allowed for fp and int8 pools alike (the paged pool
keeps the cushion once, batch-free, never in pages).

``kv_heads = (kv0, n)`` (both functions): the cache, its scales and the
cushion hold K heads, and the H query heads read heads [kv0, kv0 + n) of
them, in place (G = H / n). A tensor-parallel rank whose query heads are
cut while the KV heads are whole on every rank reads its group's head so
(``models/common.py`` ``kv_window``). None reads all K.

A CUDA tensor launches ``csrc/flash_decode.cu``; a CPU tensor takes the
plain version (``flash_decode_plain``, ``flash_decode_paged_plain``); a
meta tensor (the dry-run) returns an empty output and records one launch in
the dry-run's tally (``launch/cost.kernel``): 4 B H Smax hd FLOPs over the
whole cache length, as the reference's HLO counts its jnp oracle, and the
bytes of the operands read (the KV heads of the window) and the output.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _lib
from repro_torch.launch import cost

NEG_INF = -1e30


def _posv(pos, B: int, device) -> torch.Tensor:
    p = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1)
    return p.expand(B)


def _window(kv_heads, k, v, k_scale, v_scale, kc, vc):
    """The operands cut to the KV heads ``kv_heads`` reads (plain
    versions): the heads axis of k / v, the scales' last axis, kc / vc's
    heads axis."""
    if kv_heads is None:
        return k, v, k_scale, v_scale, kc, vc
    a, n = kv_heads

    def cut(t, axis):
        return None if t is None else t.narrow(axis, a, n)
    return (cut(k, 2), cut(v, 2), cut(k_scale, -1), cut(v_scale, -1),
            cut(kc, 1), cut(vc, 1))


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pos, k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None,
                       kc: Optional[torch.Tensor] = None,
                       vc: Optional[torch.Tensor] = None,
                       kv_heads: Optional[Tuple[int, int]] = None
                       ) -> torch.Tensor:
    """Plain PyTorch version (``ref.flash_decode_ref``): dense f32 scores
    over the whole cache with the cushion spliced over [0, m)."""
    k, v, k_scale, v_scale, kc, vc = _window(kv_heads, k, v, k_scale,
                                             v_scale, kc, vc)
    B, H, hd = q.shape
    Smax, K = k.shape[1], k.shape[2]
    G = H // K
    m = 0 if kc is None else kc.shape[0]
    kf = k.float()
    vf = v.float()
    if k_scale is not None:
        if k_scale.dim() == 2:
            kf = kf * k_scale.float()[:, None, :, None]
            vf = vf * v_scale.float()[:, None, :, None]
        else:
            kf = kf * k_scale.float()[None, None, :, None]
            vf = vf * v_scale.float()[None, None, :, None]
    if m:
        kcb = kc.float()[None].expand(B, *kc.shape)
        vcb = vc.float()[None].expand(B, *vc.shape)
        kf = torch.cat([kcb, kf[:, m:]], dim=1)
        vf = torch.cat([vcb, vf[:, m:]], dim=1)
    qg = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgh,btkh->bkgt", qg, kf) / math.sqrt(hd)
    posv = _posv(pos, B, q.device)
    idx = torch.arange(Smax, device=q.device)
    valid = idx[None, :] <= posv[:, None]
    if m:
        valid = valid | (idx < m)[None, :]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", w, vf)
    out = torch.where(valid.any(dim=1)[:, None, None, None], out,
                      torch.zeros((), device=q.device))
    return out.reshape(B, H, hd).to(q.dtype)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """The paged pool in the dense per-row layout (``ref.gather_pages``):
    pages (n_pages, ps, K, hd) + page_table (B, P) -> (B, P*ps, K, hd). Row
    b's positions [j*ps, (j+1)*ps) come from page page_table[b, j];
    unmapped entries read the scratch page 0, masked downstream."""
    B, P = page_table.shape
    g = pages[page_table.long()]                # (B, P, ps, K, hd)
    return g.reshape(B, P * pages.shape[1], *pages.shape[2:])


def flash_decode_paged_plain(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, page_table: torch.Tensor,
                             pos, k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None,
                             kc: Optional[torch.Tensor] = None,
                             vc: Optional[torch.Tensor] = None,
                             kv_heads: Optional[Tuple[int, int]] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version (``ref.flash_decode_paged_ref``): gather the
    pages into the dense layout and score it with ``flash_decode_plain``,
    which splices an fp pool's cushion over [0, m) as well."""
    return flash_decode_plain(q, gather_pages(k_pages, page_table),
                              gather_pages(v_pages, page_table), pos,
                              k_scale, v_scale, kc, vc, kv_heads)


def _operands(q, k, v, pos, k_scale, v_scale, kc, vc, K: int, kv_heads):
    """Checks what both kernels take alike. Returns (tensors, pos vector,
    quantized, m, scale_per_row, kv0, n): the window of the K heads in
    memory that the query heads read."""
    B, H, hd = q.shape
    quantized = k_scale is not None
    m = 0 if kc is None else kc.shape[0]
    kv0, n = (0, K) if kv_heads is None else (int(kv_heads[0]),
                                             int(kv_heads[1]))
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be f32 or bf16, got {q.dtype}")
    if v.shape != k.shape or k.shape[2:] != (K, hd) or n < 1 or H % n \
            or kv0 < 0 or kv0 + n > K:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}, KV heads [{kv0}, {kv0 + n})")
    if hd not in (16, 32, 64, 80, 128) or H // n > 8:
        raise ValueError(f"head_dim {hd} / group {H // n} not built")
    cache_dt = torch.int8 if quantized else q.dtype
    if k.dtype != cache_dt or v.dtype != cache_dt:
        raise ValueError(f"cache dtype must be {cache_dt}, got {k.dtype}")
    tensors = [q, k, v]
    per_row = False
    if quantized:
        per_row = k_scale.dim() == 2
        want = (B, K) if per_row else (K,)
        for s in (k_scale, v_scale):
            if s is None or s.dtype != torch.float32 or s.shape != want:
                raise ValueError("KV scales must be f32 (K,) or (B, K)")
        tensors += [k_scale, v_scale]
    if m:
        for c in (kc, vc):
            if c.shape != (m, K, hd) or c.dtype != q.dtype:
                raise ValueError("kc/vc must be (m, K, hd) in q's dtype")
        tensors += [kc, vc]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode takes contiguous operands")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the kernel reads K/V rows as 16-byte vectors: "
                         "k and v must start 16-byte aligned")
    posv = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    if posv.numel() not in (1, B) or not posv.is_contiguous():
        raise ValueError(f"pos must be () or ({B},) int32")
    return tensors, posv, quantized, m, per_row, kv0, n


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# merge counters of the split-KV kernel, one buffer per (device, stream); a
# CUDA graph (serving/graphs.py) captures on a stream of its own, after a
# warm-up there made its buffer, and keeps the buffer it captured alive
TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _scratch(q: torch.Tensor, K: int, Smax: int):
    """The split-KV kernel's f32 partials (m, l, acc) of every chunk of
    every (row, kv-head), sized by the kernel's own chunking, and its
    per-(row, kv-head) merge counters: int32 zeros kept per device and
    stream (the last block of a row resets its counter; a second stream
    gets buffers of its own) and grown on demand."""
    B, H, hd = q.shape
    n = _lib.lib().flash_decode_workspace_elems(B, H, K, Smax, hd)
    ws = torch.empty(n, dtype=torch.float32, device=q.device)
    key = (q.device, _lib.stream_ptr(q))
    t = TICKETS.get(key)
    if t is None or t.numel() < B * K:
        t = torch.zeros(B * K, dtype=torch.int32, device=q.device)
        TICKETS[key] = t
    return ws, t


# positions a chunk of the split-KV kernel (``CH`` of csrc/flash_decode.cu)
CHUNK = 64


def _meta(name: str, q: torch.Tensor, k: torch.Tensor, Smax: int, kv_heads,
          extra) -> torch.Tensor:
    """The meta route of either decode kernel, its operands checked as for
    the card: the (B, H, hd) output, the split-KV workspace the card
    allocates (``flash_decode_workspace_elems``) and one launch. k / v
    count the window's heads at Smax positions a row."""
    B, H, hd = q.shape
    K = k.shape[2]
    n = K if kv_heads is None else int(kv_heads[1])
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    ws = torch.empty(B * n * -(-Smax // CHUNK) * (H // n) * (hd + 2),
                     dtype=torch.float32, device=q.device)
    cost.kernel(name, 4.0 * B * H * Smax * hd, (q, *extra), (out,),
                extra_bytes=2 * B * Smax * n * hd * k.element_size())
    del ws
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None,
                 kc: Optional[torch.Tensor] = None,
                 vc: Optional[torch.Tensor] = None,
                 kv_heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Returns (B, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, pos, k_scale, v_scale, kc, vc,
                                  kv_heads)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    B, H, hd = q.shape
    Smax, K = k.shape[1], k.shape[2]
    if k.shape[0] != B:
        raise ValueError(f"cache batch {k.shape[0]} != q batch {B}")
    tensors, posv, quantized, m, per_row, kv0, n = _operands(
        q, k, v, pos, k_scale, v_scale, kc, vc, K, kv_heads)
    if m and not quantized:
        raise ValueError("fp caches hold the cushion in-cache (kc/vc are "
                         "for int8 caches)")
    if q.device.type == "meta":
        return _meta("flash_decode", q, k, Smax, kv_heads,
                     (*tensors[3:], posv))
    _lib.require_cuda(*tensors, posv)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    ws, tickets = _scratch(q, n, Smax)
    code = _lib.lib().flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), int(per_row), _ptr(kc), _ptr(vc), posv.data_ptr(),
        int(posv.numel() == B and posv.dim() == 1), out.data_ptr(),
        int(q.dtype == torch.bfloat16), int(quantized), B, H, n, Smax, hd, m,
        kv0, K, ws.data_ptr(), tickets.data_ptr(), _lib.stream_ptr(q))
    _lib.check(code, "flash_decode")
    _lib.count("flash_decode")
    return out


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor, pos,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None,
                       kc: Optional[torch.Tensor] = None,
                       vc: Optional[torch.Tensor] = None,
                       kv_heads: Optional[Tuple[int, int]] = None
                       ) -> torch.Tensor:
    """Returns (B, H, hd) in q's dtype; on the card bit-identical to
    ``flash_decode`` over ``gather_pages`` of the pool."""
    if q.device.type == "cpu":
        return flash_decode_paged_plain(q, k_pages, v_pages, page_table, pos,
                                        k_scale, v_scale, kc, vc, kv_heads)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_decode_paged: unsupported device "
                         f"{q.device}")
    B, H, hd = q.shape
    ps, K = k_pages.shape[1], k_pages.shape[2]
    if (page_table.dim() != 2 or page_table.shape[0] != B
            or page_table.dtype != torch.int32
            or not page_table.is_contiguous()):
        raise ValueError(f"page_table must be contiguous ({B}, P) int32")
    P = page_table.shape[1]
    tensors, posv, quantized, m, per_row, kv0, n = _operands(
        q, k_pages, v_pages, pos, k_scale, v_scale, kc, vc, K, kv_heads)
    if q.device.type == "meta":
        return _meta("flash_decode_paged", q, k_pages, P * ps, kv_heads,
                     (*tensors[3:], posv, page_table))
    _lib.require_cuda(*tensors, posv, page_table)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    ws, tickets = _scratch(q, n, P * ps)
    code = _lib.lib().flash_decode_paged_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), _ptr(k_scale), _ptr(v_scale), int(per_row),
        _ptr(kc), _ptr(vc), posv.data_ptr(),
        int(posv.numel() == B and posv.dim() == 1), out.data_ptr(),
        int(q.dtype == torch.bfloat16), int(quantized), B, H, n, P, ps, hd,
        m, kv0, K, ws.data_ptr(), tickets.data_ptr(), _lib.stream_ptr(q))
    _lib.check(code, "flash_decode_paged")
    _lib.count("flash_decode_paged")
    return out
