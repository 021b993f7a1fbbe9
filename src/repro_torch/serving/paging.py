"""Host-side page allocator for the paged continuous-batching KV pool (a
copy of ``repro/serving/paging.py``, which is numpy-only but sits behind the
JAX package's ``serving/__init__``).

The vLLM-style layout (serving/scheduler.py ``ContinuousEngine(paged=True)``)
replaces the dense per-slot rows ``(L, n_slots, max_seq, K, hd)`` with a flat
page store ``(L, n_pages, page_size, K, hd)`` plus a per-slot page table
``(n_slots, P)`` (``P = max_seq // page_size``) mapping *logical* page ``j``
of a slot — cache positions ``[j*ps, (j+1)*ps)`` — to a *physical* page.
Memory then scales with live tokens instead of ``n_slots * max_seq``.

This module is the bookkeeping half: pure numpy/host state. The device half
(the page store itself, the scatter of admission rows into pages, the
page-table reads inside the decode kernel) lives in the scheduler and
``kernels/flash_decode.flash_decode_paged``.

Contract
--------
* Physical page 0 is a reserved scratch page: it is never handed out by the
  allocator and every unmapped table entry points at it. Dead rows with a
  frozen decode position keep writing there after their real pages are
  freed, and the kernel/oracle never *use* what they read from it (masked
  by ``pos`` / the cushion boundary), so its content is don't-care.
* The fp cushion block (positions ``[0:m)``) never occupies pages at all:
  it lives once, batch-free, in the pool-level ``kc``/``vc`` refs — the
  "one refcounted, read-only cushion page mapped into every slot". Logical
  pages entirely below the cushion stay mapped to scratch forever; the
  kernel masks ``kj >= m`` out of the page reads. ``cushion_refcount``
  counts the pool's own pinned reference plus one per live slot.
* Admission *reserves* every page the request can possibly need
  (``ceil((m + prompt + budget) / ps)`` worth), maps the prompt pages
  immediately (the admission scatter writes them), and leaves decode pages
  to be mapped on demand from the free list as the slot's position crosses
  page boundaries (``ensure_mapped``). Reservation makes mid-decode
  exhaustion impossible: ``available()`` subtracts outstanding
  reservations, so ``admit`` fails up front (backpressure) instead of the
  pool underflowing at step time.
* Prefix caching (fp pools only): full pages of cushion+prompt content are
  content-addressed by ``(logical page, prompt-stem bytes)``. A later
  request whose prompt shares the stem maps the donor's pages read-only
  (refcount++), and only its tail is prefilled. Pages are never written
  after their owner's admission (decode appends go to fresh pages), so
  "copy-on-write" degenerates to copy-never: divergence simply allocates a
  fresh page at the first non-matching logical index. The registry holds
  its own reference on each cached page; when the free list runs short the
  oldest unshared entries are evicted back to it.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import numpy as np


class PagePool:
    """Free-list page allocator with refcounts, reservations and an optional
    prefix-cache registry. All state is host-side; the scheduler mirrors
    ``table`` to the device after any mutation (``dirty`` tracks that)."""

    def __init__(self, n_slots: int, max_seq: int, page_size: int,
                 n_pages: int, cushion_m: int = 0,
                 prefix_cache: bool = False):
        if max_seq % page_size:
            raise ValueError(
                f"page_size {page_size} must divide max_seq {max_seq}")
        if n_pages < 2:
            raise ValueError("need at least one scratch + one content page")
        self.ps = page_size
        self.P = max_seq // page_size
        self.n_pages = n_pages
        self.m = cushion_m
        # first logical page holding content: pages fully below the cushion
        # are never allocated (their positions live in the kc/vc refs)
        self.c0 = cushion_m // page_size
        self.table = np.zeros((n_slots, self.P), np.int32)
        self.free: List[int] = list(range(n_pages - 1, 0, -1))  # LIFO stack
        self.refs = np.zeros((n_pages,), np.int32)
        self.refs[0] = 1                    # scratch page: pinned forever
        self.reserved = 0                   # promised to live slots, unmapped
        self._slot_reserved = np.zeros((n_slots,), np.int64)
        self._slot_next = np.zeros((n_slots,), np.int64)   # next lazy page
        self._slot_limit = np.zeros((n_slots,), np.int64)  # exclusive bound
        self.cushion_slots = 0              # live slots mapping the cushion
        self.prefix_cache = bool(prefix_cache)
        # (logical page, stem bytes) -> physical page, insertion-ordered so
        # eviction is oldest-first
        self._stems: "collections.OrderedDict[Tuple[int, bytes], int]" = \
            collections.OrderedDict()
        self._page_stem: Dict[int, Tuple[int, bytes]] = {}
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.dirty = True                   # host table ahead of the device

    # ------------------------------------------------------------------
    # Capacity
    # ------------------------------------------------------------------

    def available(self) -> int:
        """Pages an admission may claim right now: the free list minus the
        outstanding lazy-decode reservations of live slots."""
        return len(self.free) - self.reserved

    def pages_for(self, lo: int, hi: int) -> Tuple[int, int]:
        """Logical page range [first, last) covering positions [lo, hi),
        clipped below to the first content page (pure-cushion pages are
        never materialized)."""
        first = max(self.c0, lo // self.ps)
        last = -(-hi // self.ps)
        return first, max(first, last)

    # ------------------------------------------------------------------
    # Admission / lazy growth / release
    # ------------------------------------------------------------------

    def admit(self, slot: int, prefill_end: int, need: int,
              shared: Optional[List[int]] = None) -> Optional[np.ndarray]:
        """Claim pages for a request occupying positions [0, need) whose
        admission prefill writes content up to ``prefill_end`` (= m + S).
        ``shared`` maps the first len(shared) content pages to existing
        (prefix-cache donor) physical pages instead of fresh ones.

        Returns the (P,) int32 scatter index vector for the admission-row
        page scatter — owned prompt pages at their logical index, everything
        else (cushion, shared, not-yet-mapped, beyond) pointing at the
        scratch page 0 — or None when the pool cannot host the request right
        now (caller backpressures exactly like a full slot pool)."""
        shared = shared or []
        first, prompt_last = self.pages_for(0, prefill_end)
        _, limit = self.pages_for(0, need)
        own_now = max(0, (prompt_last - first) - len(shared))
        reserve = limit - prompt_last
        if self.available() < own_now + reserve:
            self._evict_stems(own_now + reserve - self.available())
            if self.available() < own_now + reserve:
                return None
        assert not self.table[slot].any(), "slot released before re-admit"
        scatter = np.zeros((self.P,), np.int32)
        for i, page in enumerate(shared):
            self.table[slot, first + i] = page
            self.refs[page] += 1
            self.dirty = True
        for c in range(first + len(shared), prompt_last):
            page = self.free.pop()
            self.refs[page] = 1
            self.table[slot, c] = page
            scatter[c] = page
            self.dirty = True
        self.reserved += reserve
        self._slot_reserved[slot] = reserve
        self._slot_next[slot] = prompt_last
        self._slot_limit[slot] = limit
        if self.m:
            self.cushion_slots += 1
        return scatter

    def ensure_mapped(self, slot: int, pos: int) -> None:
        """Map the page holding ``pos`` (the next decode write position)
        from the slot's reservation, if it isn't yet. Called before every
        decode step for each live slot — the on-demand half of the
        allocate-on-append contract."""
        c = pos // self.ps
        while self._slot_next[slot] <= c:
            assert self._slot_next[slot] < self._slot_limit[slot], \
                "write position beyond the admission reservation"
            page = self.free.pop()
            self.refs[page] = 1
            self.table[slot, self._slot_next[slot]] = page
            self._slot_next[slot] += 1
            self._slot_reserved[slot] -= 1
            self.reserved -= 1
            self.dirty = True

    def release(self, slot: int) -> None:
        """Return the slot's pages: refcount-decrement every mapped page
        (shared donors survive until their last reader and any cache
        reference go), drop the unused reservation, zero the table row so
        the slot's frozen-pos dead writes land on scratch."""
        mapped = np.flatnonzero(self.table[slot])
        if not mapped.size:
            # never admitted (or already released): a true no-op — no
            # mutation, so no device-mirror dirtying, no gauge movement
            assert not self._slot_reserved[slot], \
                "reservation outstanding on a slot with no mapped pages"
            return
        for c in mapped:
            self._unref(int(self.table[slot, c]))
        self.table[slot] = 0
        self.dirty = True
        self.reserved -= int(self._slot_reserved[slot])
        self._slot_reserved[slot] = 0
        self._slot_next[slot] = 0
        self._slot_limit[slot] = 0
        if self.m:
            self.cushion_slots -= 1

    def _unref(self, page: int) -> None:
        self.refs[page] -= 1
        if self.refs[page] == 0:
            self.free.append(page)
            self._page_stem.pop(page, None)

    # ------------------------------------------------------------------
    # Prefix cache
    # ------------------------------------------------------------------

    def _stem_key(self, c: int, tokens: np.ndarray) -> Tuple[int, bytes]:
        # page c covers positions [c*ps, (c+1)*ps); its content is the
        # cushion tail (identical for everyone) plus the first
        # (c+1)*ps - m prompt tokens
        n = (c + 1) * self.ps - self.m
        return (c, np.ascontiguousarray(tokens[:n]).tobytes())

    def lookup_stem(self, tokens: np.ndarray) -> List[int]:
        """Longest run of cached pages matching this prompt's stem, capped
        so at least one prompt token remains for the tail prefill (the
        admission still needs last-token logits). Returns donor physical
        page ids for logical pages [c0, c0+h)."""
        if not self.prefix_cache:
            return []
        S = int(tokens.shape[0])
        pages: List[int] = []
        c = self.c0
        # full pages only, and leave >= 1 prompt token uncovered
        while (c + 1) * self.ps <= self.m + S - 1:
            page = self._stems.get(self._stem_key(c, tokens))
            if page is None:
                break
            pages.append(page)
            c += 1
        if pages:
            self.prefix_hits += 1
        else:
            self.prefix_misses += 1
        return pages

    def register_stem(self, slot: int, tokens: np.ndarray,
                      prefill_end: int) -> None:
        """After admission, publish the slot's fully-written prompt pages
        (positions < prefill_end) into the content-addressed registry. Each
        entry holds its own reference so donors outlive their writer."""
        if not self.prefix_cache:
            return
        c = self.c0
        while (c + 1) * self.ps <= prefill_end:
            key = self._stem_key(c, tokens)
            if key not in self._stems:
                page = int(self.table[slot, c])
                if page:
                    self._stems[key] = page
                    self._page_stem[page] = key
                    self.refs[page] += 1
            c += 1

    def _evict_stems(self, n: int) -> None:
        """Free up to ``n`` pages by dropping the oldest cache entries whose
        only remaining holder is the registry itself."""
        freed = 0
        for key in list(self._stems):
            if freed >= n:
                break
            page = self._stems[key]
            if self.refs[page] == 1:
                del self._stems[key]
                freed += 1
                self._unref(page)

    # ------------------------------------------------------------------
    # Gauges
    # ------------------------------------------------------------------

    def gauges(self) -> Dict[str, int]:
        return {
            "pages_total": self.n_pages,
            "pages_free": len(self.free),
            "pages_shared": int((self.refs > 1).sum()),
            "cushion_page_refs": (1 + self.cushion_slots) if self.m else 0,
        }
