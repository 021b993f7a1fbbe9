"""Continuous-batching serving scheduler, ported from
``repro/serving/scheduler.py``: a fixed pool of cache slots that requests
flow through independently (admit -> prefill -> lock-step decode -> retire
-> recycle), instead of the static Engine's all-start-together batch.

Design
------
* The pool is one device cache of ``n_slots`` rows plus per-row vectors:
  ``pos`` ((B,) int32 decode positions), ``tok`` ((B,) int32 last sampled
  tokens) and a host-side ``live`` mask. Decode runs one step over the whole
  pool however many slots are live: dead rows are compute-masked (pos
  frozen, sampled token forced to 0, output discarded).
* Admission prefills the request alone (B=1, cushion attached) and copies
  the whole prefilled row into its slot along the family's
  ``CACHE_BATCH_AXES``, which rewrites the fp cushion block [0:m) of the
  slot bit-identically on every recycle (an int8 pool rewrites its
  batch-free kc/vc). Per-row positions reach the kernels, so slots
  prefilled at different times decode together.
* int8 KV pools keep per-slot dequant scales ((L, n_slots, K) leaves): each
  admission calibrates them from its own prompt and they travel with the
  row.
* Paged pool (``paged=True``): the per-slot rows become a flat page store
  ``(L, n_pages, page_size, K, hd)`` plus a page table ``(L, n_slots, P)``
  (identical over L, because ``decode_step`` unstacks every leaf over L).
  The host allocator (``serving/paging.PagePool``) reserves every page a
  request can need at admission, maps prompt pages at once and decode
  pages as positions cross page boundaries; the host table is copied to
  the device only when it changed (``page_table_syncs``). The fp cushion
  lives once in batch-free ``kc``/``vc`` (``cushion_block``), written at
  pool reset and passed beside the cache on every step, never copied
  again. ``prefix_cache=True`` (fp pools only) maps a repeated prompt
  stem's pages read-only and prefills only the tail.
* Chunked prefill (``chunk_tokens``): a prompt longer than one chunk budget
  becomes a PREFILLING stream, replayed one chunk per ``step()`` into a B=1
  fp staging row between decode steps; its final chunk goes through the
  same admission copy as a blocking admission (int8 pools requantize the
  whole staged prompt), so chunked and blocking admission decode the same
  tokens.

One departure from the reference: a paged slot that holds a PREFILLING
stream decodes as a dead row at pos -1, which writes to the scratch page.
The reference keeps the slot's previous frozen pos, and that write goes
through the stream's new table row, into a shared prefix-cache page when
the stem covers it (chunked prefill with the prefix cache on a recycled
slot); the port then still decodes the static Engine's tokens where the
reference does not.

Incremental API (the replica router's contract, ``serving/router.py``):
``start()``, ``try_admit(req)``, ``step()``, ``cancel(uid)``,
``pop_finished()``, ``pop_expired()``, ``live_requests()``; ``run(trace)``
replays a trace on top of them and drains gracefully on
``KeyboardInterrupt``. Admission order,
slot choice and page reservation arithmetic are the reference's, so the two
assign the same slots to the same requests.

Caches are updated in place where the reference donates buffers to jitted
functions. The pool's device tensors (the cache, the paged pool's cushion
block, ``pos``, ``tok`` and the device copy of ``live``) are made once and
refilled in place at every ``start()``. The lock-step decode (the model's
step, the argmax and the ``live``-masked updates of ``tok`` and ``pos``)
reads and writes only those; on the card it is captured as a CUDA graph
once per engine, whose pool shape is fixed, and replayed every step
(``serving/graphs.py``), where the reference jits its ``step`` once per
pool shape. Admission, the chunked-prefill stream, the page table's copy
to the device, the copy of a changed ``live`` mask and the one host sync
per step stay outside the graph.

Tensor parallelism (``mesh``, the reference's; every family): every rank
runs a ``ContinuousEngine`` on its shard, as ``Engine`` does
(``serving/engine.py``); the pool holds the rank's KV heads (all of them
where they do not divide; an encoder-decoder's cross-attention KV too),
the per-slot scales its heads' columns, a hybrid's state rows its Mamba
channels, an xLSTM's state its slice of the mLSTM memory's value axis
(the rest of its state whole), and an int8 or paged pool's cushion block
is whole on every rank beside the rank's slice (``kc_tp`` / ``vc_tp``).
An admission's B = 1 row is made at the rank's shapes, so it scatters
into the rank's part of the slot as it is. The
page table and the host allocator are the same on every rank. Under
tp > 1 the decode step runs eagerly, by design (a collective over gloo
synchronizes with the host, which a CUDA graph cannot hold). The ranks
must take the same host decisions: rank 0 takes every decision that reads
the clock (how many queued requests have arrived, whether a stream's
deadline passed) and broadcasts it as a small int tensor
(``collectives.broadcast_ints``); an interrupt on any rank drains every
rank (a max over the ranks' flags, ``collectives.max_ints``, taken at the
top of ``run``'s loop, where no collective is open); everything else
follows from those.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import signal
import threading
import time
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core.cushioncache import cushion_fingerprint
from repro_torch.distributed import collectives as DC
from repro_torch.models import common as C
from repro_torch.monitoring import ServeStats, resident_weight_bytes
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serving.engine import (bucket_steps, cache_seq_len,
                                        check_tp_serving, cushion_prefix_len,
                                        plan_quantization,
                                        shard_params_for_serving, tp_cache,
                                        tp_config)
from repro_torch.serving.graphs import CapturedStep
from repro_torch.serving.paging import PagePool


@dataclasses.dataclass
class Request:
    """One generation request. batch: B=1 model inputs ({"tokens": (1, S)}).
    arrival_s is the trace-relative arrival time (0.0 = available at once);
    deadline_s, when set, is the trace-relative instant after which the
    request is worthless: a PREFILLING stream is dropped between chunks,
    and the router rejects it from its queue or cancels it mid-decode."""
    uid: int
    batch: Dict[str, Any]
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival_s: float = 0.0
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class RequestOutput:
    uid: int
    tokens: np.ndarray          # (n_gen,) int32, includes EOS if emitted
    ttft_ms: float              # admission -> first token (prefill wall)
    tpot_ms: float              # mean wall per subsequent token (0.0 if <2)
    slot: int
    admitted_s: float           # trace-relative admission completion
    finished_s: float           # trace-relative retirement
    latency_s: float            # arrival -> retirement


class _Slot:
    __slots__ = ("req", "tokens", "t_first", "t_admit", "used")

    def __init__(self) -> None:
        self.req: Optional[Request] = None
        self.tokens: List[int] = []
        self.t_first = 0.0
        self.t_admit = 0.0
        self.used = False       # has ever held a request (recycle counter)


class _PrefillStream:
    """A partially admitted request (a PREFILLING slot): its prompt is
    replayed chunk by chunk into a B=1 fp staging row between decode steps.
    The slot (and, paged, the page reservation) is claimed at stream start;
    the pool is touched once, at finalize."""
    __slots__ = ("req", "slot", "row", "toks", "base", "shared", "scatter",
                 "stem_tokens", "prefill_end", "tpf", "done", "logits",
                 "rpos")

    def __init__(self, req: Request, slot: int, row, toks, base: int,
                 shared, scatter, stem_tokens, prefill_end: int,
                 tpf: float) -> None:
        self.req = req
        self.slot = slot
        self.row = row              # B=1 fp staging cache
        self.toks = toks            # (1, total) prompt tokens (stem-trimmed)
        self.base = base            # chunk 0 position origin (prefix / stem)
        self.shared = shared        # prefix-cache donor pages (chunk 0)
        self.scatter = scatter      # paged admission page vector
        self.stem_tokens = stem_tokens
        self.prefill_end = prefill_end
        self.tpf = tpf              # when admission began (for TTFT)
        self.done = 0               # prompt tokens prefilled so far
        self.logits = None          # last chunk's logits (first token)
        self.rpos = None

    @property
    def total(self) -> int:
        return int(self.toks.shape[1])


# adaptive chunked-prefill budget bounds (chunk_tokens="auto"): both ends
# of the power-of-two bucket family a fixed budget uses
_AUTO_CHUNK_MAX = 256
_AUTO_CHUNK_MIN = 8


def _has_extras(req: Request) -> bool:
    """A request with inputs beside its tokens (a VLM's patches) admits
    blocking and is never looked up in the prefix cache, as in the
    reference: its positions are not its token ids."""
    return bool({"patches", "frames"} & set(req.batch))


def _scatter_row(dst, src, spec, slot: int) -> None:
    """Copy a B=1 admission row into pool slot ``slot``, in place. ``spec``
    is the family's batch-axis entry: an int (a flat cache leaf) or a dict
    of per-leaf axes (a state tree: the xLSTM's mLSTM / sLSTM states)."""
    if isinstance(spec, dict):
        for k, sub in spec.items():
            _scatter_row(dst[k], src[k], sub, slot)
        return
    dst.select(spec, slot).copy_(src.select(spec, 0))


def _host_clock() -> float:
    """The host's clock, read through the module's ``time`` at each call."""
    return time.perf_counter()


def _host_tokens(req: Request) -> np.ndarray:
    return req.batch["tokens"][0].detach().cpu().numpy()


def _on_mesh(fn):
    """Run an engine method with its mesh active (the model calls inside
    see the rank's collectives)."""
    @functools.wraps(fn)
    def run(self, *args, **kw):
        with DC.use_tp(self.mesh):
            return fn(self, *args, **kw)
    return run


# the cushion block and, under tensor parallelism, this rank's slice of it
_CUSHION_KEYS = ("kc", "vc", "kc_tp", "vc_tp")


class ContinuousEngine:
    """Continuous-batching counterpart of ``Engine`` (see the module
    docstring). The parameters live in ``self.params``, a ``ParamTree``;
    ``mesh`` is this rank's ``launch/mesh.TPMesh``; ``clock`` is read for
    every arrival, deadline and latency (seconds; the host's
    ``time.perf_counter`` when None)."""

    def __init__(self, api, params, qcfg: QuantConfig, n_slots: int = 4,
                 max_seq: int = 2048, cushion=None, scales=None,
                 stats: Optional[ServeStats] = None, kv_dtype=None,
                 calib_batches=None, prequant: bool = False,
                 weight_bits: int = 8, paged: bool = False,
                 page_size: int = 64, n_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 chunk_tokens: Optional[Union[int, str]] = None, mesh=None,
                 clock: Optional[Callable[[], float]] = None,
                 defer_tree_check: bool = False):
        self.mesh = mesh
        self._clock = clock if clock is not None else _host_clock
        self.tp = 1 if mesh is None else mesh.size
        check_tp_serving(api.cfg, qcfg, self.tp, weight_bits,
                         1 if mesh is None else mesh.data_size, paged)
        self.full_cfg = api.cfg
        self.device = api.device
        tree, scales = plan_quantization(
            api, params, qcfg, cushion=cushion, scales=scales,
            calib_batches=calib_batches, prequant=prequant,
            weight_bits=weight_bits)
        self.tree_sum = None
        if mesh is not None:
            if defer_tree_check:
                # ranks that build in turn: Engine's defer_tree_check
                tree, self.tree_sum = shard_params_for_serving(
                    tree, api.cfg, mesh, defer_check=True)
            else:
                tree = shard_params_for_serving(tree, api.cfg, mesh)
            api = dataclasses.replace(api, cfg=tp_config(api.cfg, self.tp))
        self.api = api
        self.params = C.ParamTree(tree)
        self.qcfg = qcfg
        self.n_slots = n_slots
        self.max_seq = cache_seq_len(max_seq)
        self.cushion = cushion
        self.scales = scales
        self.kv_dtype = kv_dtype
        self.prefix_len = cushion_prefix_len(cushion)
        self.cushion_fp = cushion_fingerprint(cushion)
        axes = dict(api.cache_batch_axes)
        self._seq_cache = any(k in axes for k in ("k", "v"))
        if kv_dtype is not None:
            # per-slot dequant scales travel with their KV rows
            axes.update({"k_scale": 1, "v_scale": 1})
        self._axes = axes

        self.paged = bool(paged)
        self.page_size = page_size
        self._paged_leaves = api.paged_kv_leaves
        if self.paged:
            if not self._paged_leaves:
                raise ValueError(
                    "paged=True needs a pageable sequence cache "
                    "(PAGED_KV_LEAVES); this family's cache is per-request "
                    "state with nothing to page")
            if page_size % 8:
                raise ValueError(f"page_size {page_size} must be a "
                                 f"multiple of 8")
            if self.max_seq % page_size:
                raise ValueError(f"page_size {page_size} must divide the "
                                 f"pool max_seq {self.max_seq}")
            if prefix_cache and kv_dtype is not None:
                raise ValueError(
                    "prefix_cache shares fp pages only: int8 donor pages "
                    "are quantized with the donor slot's dequant scales "
                    "and cannot be read under another slot's")
            state = sorted(set(axes) - set(self._paged_leaves))
            if prefix_cache and state:
                # the reference admits the pool and fails at the first
                # stem hit (its stem cushion carries no recurrent state)
                raise ValueError(
                    f"prefix_cache shares KV pages only: this family's "
                    f"per-request state {state} has no stem to share")
        self._P = self.max_seq // page_size
        c0 = self.prefix_len // page_size
        if n_pages is None:
            # worst case, every slot owns all its content pages: paging then
            # never backpressures where the contiguous pool would not
            n_pages = n_slots * (self._P - c0) + 1
        self.n_pages = n_pages
        self._prefix_cache = bool(prefix_cache)
        # leaves that keep dense per-slot rows in a paged pool (int8 scales)
        self._paged_axes = {k: v for k, v in axes.items()
                            if k not in self._paged_leaves}

        self.stats = stats if stats is not None else ServeStats(n_slots=n_slots)
        self.stats.n_slots = n_slots
        (self.stats.weight_bytes_fp, self.stats.weight_bytes_int8,
         self.stats.weight_bytes_int4) = resident_weight_bytes(tree)

        self.chunk_tokens: Optional[int] = None
        self.chunk_auto = False
        if chunk_tokens == "auto":
            # the per-chunk budget tracks decode pressure (_chunk_budget)
            self.chunk_auto = True
            self.chunk_tokens = _AUTO_CHUNK_MAX
        elif chunk_tokens is not None:
            if isinstance(chunk_tokens, str) or chunk_tokens < 1:
                raise ValueError(f"chunk_tokens {chunk_tokens!r} must be "
                                 f">= 1 or the string 'auto'")
            # bucketed to powers of two (min 8); prompts at or under one
            # budget admit blocking
            self.chunk_tokens = bucket_steps(int(chunk_tokens))
        self.cache: Optional[Dict[str, torch.Tensor]] = None
        self.graph: Optional[CapturedStep] = None
        self.start()

    # ------------------------------------------------------------------
    # Model calls
    # ------------------------------------------------------------------

    def _prefill(self, batch, row, cushion=None, pos_offset=None):
        batch = {k: v.to(self.device) for k, v in batch.items()}
        kw = ({"pos_offset": pos_offset} if pos_offset is not None
              else {"cushion": cushion})
        logits, row, rpos = self.api.prefill(self.params.tree(), batch, row,
                                             self.qcfg, scales=self.scales,
                                             **kw)
        logits = logits[:, -1] if logits.dim() == 3 else logits
        return logits, row, rpos

    def _init_cache(self, batch: int):
        return tp_cache(self.api.init_cache(
            batch, self.max_seq, kv_dtype=self.kv_dtype,
            prefix_len=self.prefix_len,
            per_slot_scales=self.kv_dtype is not None), self.full_cfg,
            self.api.cfg)

    def _staging_row(self):
        """B=1 fp staging row for chunked admission. int8 pools stage fp
        too: finalize_staged_kv requantizes the finished row at once, so the
        per-slot scales calibrate over the whole prompt."""
        if self.kv_dtype is None:
            return self._init_cache(1)
        return self.api.init_cache(1, self.max_seq)

    # ------------------------------------------------------------------
    # Pool state
    # ------------------------------------------------------------------

    def _reset_pool(self) -> None:
        """An empty pool. Its device tensors are made at the first reset;
        every later one refills the same tensors in place with what a fresh
        pool holds, because the captured step reads the addresses it was
        captured on."""
        if self.paged:
            cache, cushion = self._reset_pool_paged()
        else:
            cache, cushion = self._init_cache(self.n_slots), {}
        if self.cache is None:
            self.cache, self.cushion_block = cache, cushion
            self.stats.pool_bytes = sum(
                t.numel() * t.element_size()
                for t in tree_leaves(cache) + tree_leaves(cushion))
            z = (self.n_slots,)
            self.pos = torch.zeros(z, dtype=torch.int32, device=self.device)
            self.tok = torch.zeros(z, dtype=torch.int32, device=self.device)
            self._live_dev = torch.zeros(z, dtype=torch.bool,
                                         device=self.device)
        else:
            for old, new in zip(
                    tree_leaves({"c": self.cache, "b": self.cushion_block}),
                    tree_leaves({"c": cache, "b": cushion})):
                old.copy_(new)
            for t in (self.pos, self.tok, self._live_dev):
                t.zero_()
        self.live = np.zeros((self.n_slots,), bool)
        self._live_sent = self.live.copy()      # what _live_dev holds
        self._slots = [_Slot() for _ in range(self.n_slots)]

    def _reset_pool_paged(self):
        """The paged pool: the (L, n_slots, max_seq, K, hd) KV leaves
        become a flat (L, n_pages, ps, K, hd) page store plus an
        (L, n_slots, P) page table; the int8 scales keep their per-slot
        rows. The fp cushion goes once into batch-free kc/vc, outside the
        cache. Resets the host allocator; returns (cache, cushion
        block)."""
        row = self._init_cache(1)          # the leaves' shapes and types
        ps = self.page_size
        pool = {}
        for key, t in row.items():
            if key in self._paged_leaves:
                L, _, _, *rest = t.shape
                pool[key] = torch.zeros((L, self.n_pages, ps, *rest),
                                        dtype=t.dtype, device=self.device)
            elif key not in _CUSHION_KEYS:
                shape = list(t.shape)
                shape[self._axes[key]] = self.n_slots
                pool[key] = torch.zeros(shape, dtype=t.dtype,
                                        device=self.device)
        cu = {}
        if self.prefix_len:
            kvc = self.cushion["kv"]
            dt = (row["kc"].dtype if "kc" in row
                  else pool[self._paged_leaves[0]].dtype)
            cu = {"kc": kvc["k"].to(self.device, dt).contiguous(),
                  "vc": kvc["v"].to(self.device, dt).contiguous()}
            if self.tp > 1:
                n = pool[self._paged_leaves[0]].shape[-2]
                cu["kc_tp"] = C.local_heads(cu["kc"], n)
                cu["vc_tp"] = C.local_heads(cu["vc"], n)
        self._pt_layers = int(pool[self._paged_leaves[0]].shape[0])
        self._pool = PagePool(self.n_slots, self.max_seq, ps, self.n_pages,
                              cushion_m=self.prefix_len,
                              prefix_cache=self._prefix_cache)
        pool["page_table"] = torch.zeros(
            (self._pt_layers, self.n_slots, self._P), dtype=torch.int32,
            device=self.device)
        self._pool.dirty = False            # device table == host (all 0)
        self._hpos = np.zeros((self.n_slots,), np.int64)
        # the shared cushion block lives outside the cache: the same two
        # device tensors serve every step of the engine
        return pool, cu

    def _sync_page_table(self) -> None:
        """Copy the allocator's host table into the device table (one
        host-to-device copy, the same rows for every layer)."""
        host = torch.from_numpy(self._pool.table)
        self.cache["page_table"].copy_(host.expand(self._pt_layers, -1, -1))
        self._pool.dirty = False
        self.stats.page_table_syncs += 1

    def _publish_gauges(self) -> None:
        g = self._pool.gauges()
        st = self.stats
        st.pages_total = g["pages_total"]
        st.pages_free = g["pages_free"]
        st.pages_shared = g["pages_shared"]
        st.cushion_page_refs = g["cushion_page_refs"]
        st.prefix_hits = self._pool.prefix_hits
        st.prefix_misses = self._pool.prefix_misses

    def _positions_needed(self, req: Request) -> int:
        S = int(req.batch["tokens"].shape[1])
        if "patches" in req.batch:
            S += int(req.batch["patches"].shape[1])
        return self.prefix_len + S + req.max_new_tokens

    # ------------------------------------------------------------------
    # Incremental serving API
    # ------------------------------------------------------------------

    @torch.inference_mode()
    @_on_mesh
    def start(self) -> None:
        """Open a serving session: reset the pool, the occupancy stats and
        the result buffers. On the card the first session captures the
        decode step (tp = 1), on the empty pool, which it then resets
        again."""
        self._reset_pool()
        if (self.device.type == "cuda" and self.tp == 1
                and self.graph is None):
            self.graph = CapturedStep(self._decode_pool, self.device)
            self._reset_pool()
        self.stats.reset()
        if self.paged:
            self._publish_gauges()
        self._results: Dict[int, RequestOutput] = {}
        self._ttft: Dict[int, float] = {}
        self._streams: collections.deque = collections.deque()
        self._expired: List[int] = []
        self._t0 = self._clock()

    def now(self) -> float:
        """Seconds since ``start()``."""
        return self._clock() - self._t0

    def free_slots(self) -> List[int]:
        return [int(i) for i in np.flatnonzero(~self.live)
                if self._slots[i].req is None]

    @property
    def live_count(self) -> int:
        return int(self.live.sum())

    @property
    def prefilling(self) -> int:
        """Admission streams currently mid-prefill (PREFILLING slots). The
        router must keep stepping an engine whose only work is a stream."""
        return len(self._streams)

    def is_prefilling(self, uid: int) -> bool:
        """True while ``uid`` is a PREFILLING slot. The engine enforces
        these deadlines between chunks itself (``pop_expired``); the router
        leaves them out of its mid-decode deadline sweep, so the rejection
        reason stays ``deadline-prefill``."""
        return any(st.req.uid == uid for st in self._streams)

    def pop_expired(self) -> List[int]:
        """Drain the uids of streams retired between chunks for missing
        their deadline (no result was produced; the router maps them to
        ``deadline-prefill`` rejections and clears its inflight entry)."""
        out, self._expired = self._expired, []
        return out

    def live_requests(self) -> List[Request]:
        """Requests holding a slot: live decoders and PREFILLING streams
        (the router fails them over to surviving replicas when this engine
        dies)."""
        return [s.req for s in self._slots if s.req is not None]

    @torch.inference_mode()
    @_on_mesh
    def try_admit(self, req: Request) -> bool:
        """Admit ``req`` into the first free slot (B=1 prefill + the row
        copy, or the page scatter on a paged pool). False when no slot is
        free, or, paged, when the pages cannot host the request now: the
        caller queues. Raises ValueError (counted in
        ``stats.positions_exhausted``) for a request that can never fit.
        With ``chunk_tokens`` set, a prompt longer than one budget starts a
        PREFILLING stream instead."""
        free = self.free_slots()
        if not free:
            return False
        if (self.chunk_tokens is not None
                and self.api.supports_chunked_prefill
                and not _has_extras(req)
                and req.batch["tokens"].shape[1] > self._chunk_budget()):
            return self._start_stream(req, free[0])
        return self._admit_request(req, free[0])

    def _chunk_budget(self) -> int:
        """Per-step prefill token budget: fixed, or (auto) linear in the
        share of free slots from ``_AUTO_CHUNK_MAX`` down to
        ``_AUTO_CHUNK_MIN``, on the same power-of-two buckets."""
        if not self.chunk_auto:
            return self.chunk_tokens
        pressure = float(self.live.sum()) / max(1, self.n_slots)
        want = int(round(_AUTO_CHUNK_MAX * (1.0 - pressure)))
        return bucket_steps(max(_AUTO_CHUNK_MIN, want))

    @torch.inference_mode()
    @_on_mesh
    def step(self) -> List[int]:
        """One prefill chunk of the oldest pending stream (if any), then one
        lock-step decode over the whole pool, retiring slots that hit EOS or
        their budget. Returns the uids retired by the decode."""
        if self._streams:
            self._advance_stream()
        if not self.live.any():
            return []
        live_idx = np.flatnonzero(self.live)
        if self.paged:
            # map this step's write page of every live slot, then mirror a
            # changed table to the device before the kernel reads it
            for slot in live_idx:
                self._pool.ensure_mapped(int(slot), int(self._hpos[slot]))
            if self._pool.dirty:
                self._sync_page_table()
        if not np.array_equal(self.live, self._live_sent):
            self._live_dev.copy_(torch.from_numpy(self.live))
            self._live_sent = self.live.copy()
        if self.graph is not None:
            self.graph.replay()
        else:
            self._decode_pool()
        if self.paged:
            self._hpos[live_idx] += 1   # mirror the device pos advance
        toks = self.tok.cpu().numpy()   # the one host sync per step
        self.stats.steps += 1
        self.stats.live_slot_steps += int(self.live.sum())
        retired: List[int] = []
        for slot in live_idx:
            s = self._slots[slot]
            req = s.req
            s.tokens.append(int(toks[slot]))
            if (len(s.tokens) >= req.max_new_tokens
                    or (req.eos_id is not None
                        and s.tokens[-1] == req.eos_id)):
                retired.append(req.uid)
                self._retire(int(slot))
        return retired

    def _decode_pool(self) -> None:
        """The lock-step decode over the whole pool, in place: dead rows
        feed token 0 and keep their pos. The step the card captures."""
        full = dict(self.cache)
        full.update(self.cushion_block)
        logits, _ = self.api.decode_step(self.params.tree(), self.tok,
                                         self.pos, full, self.qcfg,
                                         scales=self.scales)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        self.tok.copy_(torch.where(self._live_dev, nxt, torch.zeros_like(nxt)))
        self.pos.copy_(torch.where(self._live_dev, self.pos + 1, self.pos))

    def cancel(self, uid: int) -> bool:
        """Free the slot holding ``uid`` without a result (a PREFILLING
        stream is dropped the same way). False if ``uid`` is not here."""
        for st in self._streams:
            if st.req.uid == uid:
                self._streams.remove(st)
                self.stats.canceled += 1
                self._abort_stream(st, expired=False)
                return True
        for slot, s in enumerate(self._slots):
            if s.req is not None and s.req.uid == uid:
                self.live[slot] = False
                s.req = None
                self._ttft.pop(uid, None)
                self.stats.canceled += 1
                if self.paged:
                    # the zeroed table row sends the slot's frozen-pos
                    # writes to the scratch page
                    self._pool.release(slot)
                    self._publish_gauges()
                return True
        return False

    def pop_finished(self) -> List[RequestOutput]:
        """Drain completed outputs (uid-sorted) since the last call."""
        out = [self._results[u] for u in sorted(self._results)]
        self._results = {}
        return out

    # ------------------------------------------------------------------
    # Admission / retirement internals
    # ------------------------------------------------------------------

    def _check_capacity(self, req: Request) -> int:
        need = self._positions_needed(req)
        if self._seq_cache and need > self.max_seq:
            self.stats.positions_exhausted += 1
            raise ValueError(
                f"request {req.uid} needs {need} positions "
                f"(prefix {self.prefix_len} + prompt + budget) "
                f"> pool max_seq {self.max_seq}")
        return need

    def _admit_row(self, row, slot: int, rpos, tok0) -> None:
        """Copy a B=1 admission row into slot ``slot`` (every batch-axis
        leaf, nested ones too; an int8 pool's batch-free kc/vc
        wholesale)."""
        for key, ax in self._axes.items():
            _scatter_row(self.cache[key], row[key], ax, slot)
        for key in _CUSHION_KEYS:
            if key in self.cache:
                self.cache[key].copy_(row[key])
        self.pos[slot] = rpos
        self.tok[slot] = tok0

    def _admit_row_paged(self, row, slot: int, rpos, tok0,
                         scatter: np.ndarray) -> None:
        """Copy each owned prompt page of a B=1 admission row to its
        physical page (``scatter[j]`` for logical page j; 0 = not owned:
        cushion, shared donor or beyond the prompt, never written). The
        shared kc/vc are left alone."""
        own = np.flatnonzero(scatter)
        if own.size:
            src = torch.as_tensor(own, device=self.device)
            dst = torch.as_tensor(scatter[own].astype(np.int64),
                                  device=self.device)
            for key in self._paged_leaves:
                rp = row[key][:, 0]                     # (L, max_seq, K, hd)
                rp = rp.reshape(rp.shape[0], self._P, self.page_size,
                                *rp.shape[2:])
                self.cache[key][:, dst] = rp[:, src].to(self.cache[key].dtype)
        for key, ax in self._paged_axes.items():
            self.cache[key].select(ax, slot).copy_(row[key].select(ax, 0))
        self.pos[slot] = rpos
        self.tok[slot] = tok0

    def _admit_request(self, req: Request, slot: int) -> bool:
        need = self._check_capacity(req)
        if self.paged:
            return self._admit_request_paged(req, slot, need)
        tpf = self._clock()
        logits, row, rpos = self._prefill(req.batch, self._init_cache(1),
                                          cushion=self.cushion)
        tok0 = torch.argmax(logits, dim=-1).to(torch.int32)[0]
        self._admit_row(row, slot, rpos, tok0)
        self._book_admission(req, slot, int(tok0), tpf)
        return True

    def _admit_request_paged(self, req: Request, slot: int,
                             need: int) -> bool:
        """Paged admission: claim pages (the full reservation), prefill the
        B=1 row contiguously, copy each owned prompt page. On a prefix-cache
        hit the donor's stem pages are mapped read-only and only the tail
        is prefilled, against the cushion extended by the stem. False
        (backpressure) when the pages cannot host the request now."""
        prefill_end = need - req.max_new_tokens     # prefix + prompt
        tokens = None
        shared: List[int] = []
        if self._prefix_cache and not _has_extras(req):
            tokens = _host_tokens(req)
            shared = self._pool.lookup_stem(tokens)
        scatter = self._pool.admit(slot, prefill_end, need, shared=shared)
        if scatter is None:
            return False
        tpf = self._clock()
        row = self._init_cache(1)
        if shared:
            stem_end = (self._pool.c0 + len(shared)) * self.page_size
            b2 = dict(req.batch)
            b2["tokens"] = req.batch["tokens"][:, stem_end - self.prefix_len:]
            logits, row, rpos = self._prefill(
                b2, row, cushion=self._stem_cushion(shared))
        else:
            logits, row, rpos = self._prefill(req.batch, row,
                                              cushion=self.cushion)
        tok0 = torch.argmax(logits, dim=-1).to(torch.int32)[0]
        self._admit_row_paged(row, slot, rpos, tok0, scatter)
        first = int(tok0)
        if tokens is not None:
            self._pool.register_stem(slot, tokens, prefill_end)
        self._hpos[slot] = prefill_end
        self._book_admission(req, slot, first, tpf)
        self._publish_gauges()
        return True

    def _stem_cushion(self, shared: List[int]):
        """Extended cushion for a prefix-cache hit: the cushion KV followed
        by the donor stem pages gathered from the page store (skipping the
        cushion rows that share the stem's first page)."""
        ps = self.page_size
        donors = torch.as_tensor(shared, device=self.device)
        kp = self.cache["k"][:, donors]             # (L, h, ps, K, hd)
        vp = self.cache["v"][:, donors]
        kp = kp.reshape(kp.shape[0], -1, *kp.shape[3:])
        vp = vp.reshape(vp.shape[0], -1, *vp.shape[3:])
        skip = self.prefix_len - self._pool.c0 * ps
        if self.prefix_len:
            # the pages hold this rank's heads: so does the stem cushion
            n = kp.shape[-2]
            kvc = self.cushion["kv"]
            return {"kv": {
                "k": torch.cat([C.local_heads(kvc["k"], n).to(
                    self.device, kp.dtype), kp[:, skip:]], dim=1),
                "v": torch.cat([C.local_heads(kvc["v"], n).to(
                    self.device, vp.dtype), vp[:, skip:]], dim=1)}}
        return {"kv": {"k": kp, "v": vp}}

    # ------------------------------------------------------------------
    # Chunked admission (PREFILLING streams)
    # ------------------------------------------------------------------

    def _start_stream(self, req: Request, slot: int) -> bool:
        """Claim a slot (and, paged, the full page reservation: backpressure
        is decided up front, as when blocking) and queue the prompt for
        chunk-by-chunk prefill."""
        need = self._check_capacity(req)
        prefill_end = need - req.max_new_tokens     # prefix + prompt
        scatter = None
        shared: List[int] = []
        stem_tokens = None
        if self.paged:
            if self._prefix_cache and not _has_extras(req):
                stem_tokens = _host_tokens(req)
                shared = self._pool.lookup_stem(stem_tokens)
            scatter = self._pool.admit(slot, prefill_end, need, shared=shared)
            if scatter is None:
                return False
        toks = req.batch["tokens"]
        base = self.prefix_len
        if shared:
            # donor pages cover the stem; only the tail is chunked
            base = (self._pool.c0 + len(shared)) * self.page_size
            toks = toks[:, base - self.prefix_len:]
        if self.paged:
            # the slot's table row maps the stream's pages (and shared donor
            # pages) from now on while the slot still decodes as a dead row:
            # pos -1 sends its writes to the scratch page. The reference keeps
            # the previous request's frozen pos here, which writes through
            # the new row, into a donor page when the stem covers it.
            self.pos[slot] = -1
        self._slots[slot].req = req     # PREFILLING: slot held, not live
        self._streams.append(_PrefillStream(req, slot, self._staging_row(),
                                            toks, base, shared, scatter,
                                            stem_tokens, prefill_end,
                                            self._clock()))
        return True

    def _advance_stream(self) -> None:
        """Run one chunk of the oldest pending stream (round-robin across
        streams); finalize when the prompt is done. An expired stream frees
        its slot and pages without a result."""
        st = self._streams.popleft()
        req = st.req
        if req.deadline_s is not None and self._agree(
                self.now() > req.deadline_s)[0]:
            self._abort_stream(st, expired=True)
            return
        c = min(self._chunk_budget(), st.total - st.done)
        chunk = {"tokens": st.toks[:, st.done:st.done + c]}
        if st.done == 0:
            cu = self._stem_cushion(st.shared) if st.shared else self.cushion
            st.logits, st.row, st.rpos = self._prefill(chunk, st.row,
                                                       cushion=cu)
        else:
            st.logits, st.row, st.rpos = self._prefill(
                chunk, st.row, pos_offset=st.base + st.done)
        st.done += c
        self.stats.prefill_chunks += 1
        if st.done < st.total:
            self._streams.append(st)
        else:
            self._finalize_stream(st)

    def _finalize_stream(self, st: _PrefillStream) -> None:
        """Admit the finished staging row through the same copy (and, int8,
        the same whole-prompt scale calibration) as a blocking admission."""
        req, slot = st.req, st.slot
        tok0 = torch.argmax(st.logits, dim=-1).to(torch.int32)[0]
        row = st.row
        if self.kv_dtype is not None:
            row = self.api.finalize_staged_kv(row, self._init_cache(1),
                                              self.cushion, st.total)
        if self.paged:
            self._admit_row_paged(row, slot, st.rpos, tok0, st.scatter)
        else:
            self._admit_row(row, slot, st.rpos, tok0)
        first = int(tok0)
        if st.stem_tokens is not None:
            self._pool.register_stem(slot, st.stem_tokens, st.prefill_end)
        if self.paged:
            self._hpos[slot] = st.prefill_end
        self._book_admission(req, slot, first, st.tpf)
        if self.paged:
            self._publish_gauges()

    def _abort_stream(self, st: _PrefillStream, expired: bool) -> None:
        """Drop a PREFILLING stream without a result: free the slot, return
        the page reservation, discard the staged row."""
        self._slots[st.slot].req = None
        if self.paged:
            self._pool.release(st.slot)
            self._publish_gauges()
        if expired:
            self.stats.deadline_prefill += 1
            self._expired.append(st.req.uid)

    def _book_admission(self, req: Request, slot: int, first: int,
                        tpf: float) -> None:
        now = self._clock()
        s = self._slots[slot]
        if s.used:
            self.stats.recycles += 1
        s.used = True
        s.req = req
        s.tokens = [first]
        s.t_admit = now - self._t0
        s.t_first = now
        self.stats.admitted += 1
        self._ttft[req.uid] = (now - tpf) * 1e3
        done = (req.max_new_tokens <= 1
                or (req.eos_id is not None and first == req.eos_id))
        self.live[slot] = not done
        if done:
            self._retire(slot)

    def _retire(self, slot: int) -> None:
        s = self._slots[slot]
        req = s.req
        assert req is not None
        now = self._clock()
        n = len(s.tokens)
        tpot = 0.0 if n <= 1 else (now - s.t_first) * 1e3 / (n - 1)
        self._results[req.uid] = RequestOutput(
            uid=req.uid, tokens=np.asarray(s.tokens, np.int32),
            ttft_ms=self._ttft[req.uid], tpot_ms=tpot, slot=slot,
            admitted_s=s.t_admit, finished_s=now - self._t0,
            latency_s=(now - self._t0) - req.arrival_s)
        self.live[slot] = False
        s.req = None
        self.stats.finished += 1
        if self.paged:
            # return the pages; the zeroed table row sends the dead row's
            # frozen-pos writes to the scratch page
            self._pool.release(slot)
            self._publish_gauges()

    # ------------------------------------------------------------------
    # Trace replay
    # ------------------------------------------------------------------

    def _agree(self, *values) -> List[int]:
        """Rank 0's values on every rank (a host decision read from the
        clock); the values themselves on one rank."""
        return DC.broadcast_ints(values, self.mesh)

    def _agree_loop(self, arrived: int, drain: bool) -> Tuple[int, bool]:
        """Rank 0's count of arrived requests, and whether any rank drains
        (an interrupt on one rank drains them all), in one collective."""
        if self.tp == 1:
            return arrived, drain
        mine = arrived if self.mesh.rank == 0 else -1
        arrived, drain = DC.max_ints((mine, drain), self.mesh)
        return arrived, bool(drain)

    @_on_mesh
    def run(self, requests: Sequence[Request]) -> List[RequestOutput]:
        """Replay a trace: admit each request once it has arrived and a slot
        is free (FIFO), decode the pool in lock-step, return outputs sorted
        by uid. The pool and the stats are reset per run.

        ``KeyboardInterrupt`` drains gracefully: admission stops, live slots
        decode to completion, streams and the queued remainder are dropped,
        and ``stats.interrupted`` is set. A second interrupt aborts.

        Under tensor parallelism ctrl-C and SIGTERM are counted, not
        raised, while the trace runs (``_DeferredInterrupts``), and read at
        the top of each loop, where no collective is open: an interrupt on
        any rank drains every rank."""
        self.start()
        queue = collections.deque(
            sorted(requests, key=lambda r: (r.arrival_s, r.uid)))
        done: Dict[int, RequestOutput] = {}
        draining = False
        with _DeferredInterrupts(self.tp > 1) as interrupts:
            while queue or self.live.any() or self._streams:
                try:
                    if interrupts.count > 1:
                        raise KeyboardInterrupt("second interrupt")
                    # rank 0's clock decides, for every rank, how many
                    # queued requests have arrived; any rank's interrupt
                    # drains
                    now = self.now()
                    arrived = 0
                    for r in queue:
                        if r.arrival_s > now:
                            break
                        arrived += 1
                    arrived, draining = self._agree_loop(
                        arrived, draining or interrupts.count > 0)
                    if draining:
                        self.stats.interrupted = True
                    if self._loop_once(queue, done, arrived, draining):
                        break
                except KeyboardInterrupt:
                    # raised inside a step: under tp > 1 this rank may be
                    # part-way through its collectives, so it cannot drain
                    if draining or self.tp > 1:
                        raise
                    draining = True
                    self.stats.interrupted = True

        for o in self.pop_finished():
            done[o.uid] = o
        return [done[u] for u in sorted(done)]

    def _loop_once(self, queue, done, arrived: int, draining: bool) -> bool:
        """One pass of ``run``'s loop on the agreed decisions; True when a
        drain has nothing left to decode."""
        if draining:
            while self._streams:
                self._abort_stream(self._streams.popleft(), expired=False)
            if not self.live.any():
                return True
        else:
            # admit every arrived request that fits; one that can never
            # fit is dropped (stats.positions_exhausted)
            while queue and arrived > 0:
                try:
                    if not self.try_admit(queue[0]):
                        break
                except ValueError:
                    queue.popleft()
                    arrived -= 1
                    continue
                queue.popleft()
                arrived -= 1
            if not self.live.any() and not self._streams:
                if queue:   # pool idle, next arrival in the future
                    time.sleep(min(1e-3, max(
                        0.0, queue[0].arrival_s - self.now())))
                for o in self.pop_finished():
                    done[o.uid] = o
                return False
        self.step()
        for o in self.pop_finished():
            done[o.uid] = o
        return False


class _DeferredInterrupts:
    """While ``on`` (and in the main thread, where signal handlers live),
    ctrl-C and SIGTERM add one to ``count`` instead of raising; the
    previous handlers come back on exit. ``run`` reads the count at the top
    of its loop, between collectives."""

    def __init__(self, on: bool):
        self.on = on
        self.count = 0
        self._old: Dict[int, Any] = {}

    def _note(self, signum, frame) -> None:
        self.count += 1

    def __enter__(self) -> "_DeferredInterrupts":
        if self.on and threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGINT, signal.SIGTERM):
                self._old[sig] = signal.signal(sig, self._note)
        return self

    def __exit__(self, *exc) -> None:
        for sig, handler in self._old.items():
            signal.signal(sig, handler)
