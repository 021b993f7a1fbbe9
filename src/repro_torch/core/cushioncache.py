"""CushionCache (paper §4), ported from ``repro/core/cushioncache.py``:
find a prefix KV cache that mitigates activation outliers in the tokens
after it.

Two stages:
  1. ``greedy_search``: Algorithm 1. Grow a hard-token prompt one token at
     a time, each chosen over a candidate subset of the embedding table by
     batched inference to minimize L_q(t | p, p'), and stop early at the
     improvement ratio tau (eq. 10).
  2. ``prefix_tune``: quantization-aware prefix tuning. The model is
     frozen; the cushion KV block is trained on L = L_pred + λ·L_range
     (eq. 11, with ``core.outliers``' differentiable activation-range
     penalty) through a straight-through quantized forward whose quantizer
     scales and zero points carry no gradient.

``ModelAPI.extract_cushion`` turns the searched prefix into the artifact.

The reference's batched inference is ``jax.vmap`` over candidates: each
candidate's forward has its own per-tensor dynamic ranges and its own L_q.
The port stacks the candidates along the batch and runs one forward with
``groups=N`` (``models/common.py``): every range and L_q reduces per
candidate, the same function in one launch per kernel.

Search fast path: ``greedy_search`` pads the prefix to
``ccfg.max_prefix_len`` and passes its live length to attention, prefills
the shared prefix into a KV block once per iteration
(``ModelAPI.prefix_kv``), scores every candidate chunk against it
(``ModelAPI.score_candidates``) and takes the argmin on the device: one
host transfer per iteration. ``greedy_search_ref`` keeps the full forward
per candidate: it is the parity oracle of the fast path.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple)

import numpy as np
import torch

from repro_torch.configs.base import CushionConfig, QuantConfig
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import tree_leaves, tree_map

Params = Dict[str, Any]


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """Leaves in JAX's flatten order (dict keys sorted) with their
    ``jax.tree_util.keystr`` path, e.g. ``['kv']['k']``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def _numpy_bytes(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.view(torch.int16).numpy()
    a = t.numpy()
    return str(a.dtype), a


def cushion_fingerprint(cushion: Optional[Params]) -> str:
    """sha256 over every leaf's path, dtype, shape and exact bytes
    (``"none"`` for no cushion) — the same hex digest as the reference's
    ``cushion_fingerprint`` for the same artifact, so scales calibrated by
    either side pass the other's stale-scale check."""
    if cushion is None:
        return "none"
    h = hashlib.sha256()
    for path, leaf in _leaves(cushion):
        dtype, a = _numpy_bytes(leaf)
        h.update(path.encode())
        h.update(dtype.encode())
        h.update(str(tuple(a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# L_q evaluation
# ---------------------------------------------------------------------------

def make_qerr_fn(api, qcfg: QuantConfig, scales: Optional[Params] = None
                 ) -> Callable:
    """fn(params, prefix_ids (m,), batch) -> L_q of the token part (the
    dynamic ranges come from the token part only, as at deployment, where
    prefix tokens never re-enter the linears)."""
    @torch.no_grad()
    def f(params, prefix_ids, batch):
        m = int(prefix_ids.shape[0])
        _, taps = api.forward_with_token_prefix(
            params, prefix_ids, batch, qcfg, scales=scales, collect=True,
            n_skip=m, remat=False)
        return T.total_qerr(taps)
    return f


def make_batched_qerr_fn(api, qcfg: QuantConfig,
                         scales: Optional[Params] = None) -> Callable:
    """fn(params, prefixes (N, m), batch) -> (N,) L_q per candidate prefix:
    the paper's batched inference for the argmin over the embedding table,
    one forward with ``groups=N``."""
    @torch.no_grad()
    def f(params, prefixes, batch):
        N, m = (int(d) for d in prefixes.shape)
        _, taps = api.forward_with_token_prefix(
            params, prefixes, batch, qcfg, scales=scales, collect=True,
            n_skip=m, remat=False)
        return T.total_qerr(taps, groups=N).reshape(N)
    return f


# ---------------------------------------------------------------------------
# Stage 1: greedy prefix search (Algorithm 1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SearchResult:
    prefix_ids: np.ndarray
    history: List[Dict[str, float]]
    wall_time_s: float


# always-included nonsemantic candidates (<bos>-like low ids); also the
# sizing basis of the fast path's fixed candidate-pool shape
SPECIAL_TOKENS = (0, 1, 2, 3, 10, 13, 32, 198)


def _specials(vocab_size: int, seed_tokens: Tuple[int, ...]) -> np.ndarray:
    s = np.unique(np.array(list(seed_tokens) + list(SPECIAL_TOKENS)))
    return s[s < vocab_size]


def candidate_pool(gen: torch.Generator, vocab_size: int, n: int,
                   seed_tokens: Tuple[int, ...] = ()) -> np.ndarray:
    """A random subset of the embedding table plus the always-included
    nonsemantic candidates, sorted and unique, standing in for the
    full-table argmin (eq. 9). The subset is the first ``n - 8`` ids of a
    ``torch.randperm`` drawn from ``gen`` (a CPU generator): the port
    cannot reproduce ``jax.random.choice``'s stream, so the same seed gives
    other pools than the reference."""
    n_rand = max(0, n - len(SPECIAL_TOKENS))
    cands = torch.randperm(vocab_size, generator=gen)[:n_rand].numpy()
    specials = _specials(vocab_size, seed_tokens)
    return np.unique(np.concatenate([cands, specials]))


def _history(it, m, base_err, best_err, best_tok, verbose):
    rec = {"iter": it, "len": m, "base_err": base_err, "best_err": best_err,
           "best_tok": best_tok, "ratio": best_err / max(base_err, 1e-30)}
    if verbose:
        print(f"[greedy] it={it} len={m} L_q={base_err:.4g} "
              f"-> {best_err:.4g} (tok={best_tok}, ratio={rec['ratio']:.3f})")
    return rec


def greedy_search_ref(api, params, sample_fn: Callable[[int], Dict[str, Any]],
                      qcfg: QuantConfig, ccfg: CushionConfig,
                      gen: torch.Generator, chunk: int = 16,
                      verbose: bool = True) -> SearchResult:
    """Algorithm 1, reference implementation (full forward per candidate).

    sample_fn(i) -> calibration batch (batch 1, length n). Each iteration
    draws a fresh sample, scores every candidate p' by batched inference
    in chunks, and appends the argmin if it improves L_q by the factor tau
    (eq. 10); it stops otherwise or at the maximum length. One host read
    per chunk; the parity oracle of ``greedy_search``."""
    t0 = time.time()
    dev = api.device
    qerr_fn = make_qerr_fn(api, qcfg)
    batched_fn = make_batched_qerr_fn(api, qcfg)
    prefix: List[int] = list(ccfg.seed_tokens)
    history: List[Dict[str, float]] = []

    it = 0
    while len(prefix) < ccfg.max_prefix_len:
        batch = sample_fn(it)
        base_ids = torch.as_tensor(prefix, dtype=torch.int32, device=dev)
        base_err = float(qerr_fn(params, base_ids, batch))
        cands = candidate_pool(gen, api.cfg.vocab_size, ccfg.n_candidates,
                               ccfg.seed_tokens)
        best_err, best_tok = np.inf, -1
        for s in range(0, len(cands), chunk):
            cs = cands[s:s + chunk]
            if len(cs) < chunk:   # pad to one shape, as the reference
                cs = np.concatenate([cs, np.repeat(cs[-1:], chunk - len(cs))])
            pref = np.concatenate(
                [np.broadcast_to(np.asarray(prefix, np.int32)[None],
                                 (chunk, len(prefix))),
                 cs.astype(np.int32)[:, None]], axis=1)
            errs = batched_fn(params, torch.as_tensor(pref, device=dev),
                              batch).cpu().numpy()
            j = int(np.argmin(errs))
            if errs[j] < best_err:
                best_err, best_tok = float(errs[j]), int(cs[j])

        history.append(_history(it, len(prefix), base_err, best_err,
                                best_tok, verbose))
        if best_err > ccfg.tau * base_err:
            break                      # eq. (10) early stop
        prefix.append(best_tok)
        it += 1

    return SearchResult(prefix_ids=np.asarray(prefix, np.int32),
                        history=history, wall_time_s=time.time() - t0)


def _pool_pad_len(vocab_size: int, ccfg: CushionConfig, chunk: int) -> int:
    """Upper bound on ``candidate_pool``'s length, rounded up to a chunk
    multiple: the fixed candidate shape of the search step."""
    cap = max(0, ccfg.n_candidates - len(SPECIAL_TOKENS)) \
        + len(_specials(vocab_size, ccfg.seed_tokens))
    return max(chunk, -(-cap // chunk) * chunk)


def make_search_step_fn(api, qcfg: QuantConfig,
                        scales: Optional[Params] = None) -> Callable:
    """One greedy-search iteration, the same shapes every iteration:

        step(params, padded_prefix (max_m,), live_len (int), cands
             (n_chunks, chunk), batch) -> (base_err, best_err, best_tok)

    as three device tensors: prefills the padded prefix into a KV block,
    computes the base L_q, scores every candidate chunk against the block
    and takes the argmin on the device (``torch.argmin`` keeps the first
    of equal values, so a duplicated padding candidate never wins over its
    first occurrence)."""
    @torch.no_grad()
    def step(params, padded_prefix, live_len, cands, batch):
        pkv = api.prefix_kv(params, padded_prefix, qcfg, scales=scales)
        base = api.prefix_qerr(params, pkv, live_len, batch, qcfg,
                               scales=scales)
        errs = torch.cat([api.score_candidates(params, pkv, live_len, cs,
                                               batch, qcfg, scales=scales)
                          for cs in cands])
        j = torch.argmin(errs)
        return base, errs[j], cands.reshape(-1)[j]
    return step


def greedy_search(api, params, sample_fn: Callable[[int], Dict[str, Any]],
                  qcfg: QuantConfig, ccfg: CushionConfig,
                  gen: torch.Generator, chunk: int = 16,
                  verbose: bool = True) -> SearchResult:
    """Algorithm 1, KV-reuse fast path (see the module docstring). The same
    candidate pools in the same order as ``greedy_search_ref`` (one
    ``candidate_pool`` draw an iteration); one host transfer an
    iteration."""
    if not api.supports_kv_scoring:
        if verbose:
            print(f"[greedy] {api.cfg.family}: no KV-reuse scoring; "
                  "falling back to greedy_search_ref")
        return greedy_search_ref(api, params, sample_fn, qcfg, ccfg, gen,
                                 chunk=chunk, verbose=verbose)
    t0 = time.time()
    dev = api.device
    max_m = ccfg.max_prefix_len
    step_fn = make_search_step_fn(api, qcfg)
    n_pool = _pool_pad_len(api.cfg.vocab_size, ccfg, chunk)
    prefix: List[int] = list(ccfg.seed_tokens)
    padded = np.zeros((max_m,), np.int32)
    padded[:len(prefix)] = prefix
    history: List[Dict[str, float]] = []

    it = 0
    while len(prefix) < max_m:
        batch = sample_fn(it)
        cands = candidate_pool(gen, api.cfg.vocab_size, ccfg.n_candidates,
                               ccfg.seed_tokens).astype(np.int32)
        # pad to the fixed pool size by repeating the tail candidate:
        # duplicates tie in L_q and argmin keeps the first occurrence, so
        # the winner matches the reference's strict-improvement scan
        cands = np.concatenate(
            [cands, np.repeat(cands[-1:], n_pool - len(cands))])
        base, best, tok = step_fn(
            params, torch.as_tensor(padded, device=dev), len(prefix),
            torch.as_tensor(cands.reshape(-1, chunk), device=dev), batch)
        vals = torch.stack([base.double(), best.double(),
                            tok.double()]).cpu().tolist()
        base_err, best_err, best_tok = vals[0], vals[1], int(vals[2])

        history.append(_history(it, len(prefix), base_err, best_err,
                                best_tok, verbose))
        if best_err > ccfg.tau * base_err:
            break                      # eq. (10) early stop
        padded[len(prefix)] = best_tok
        prefix.append(best_tok)
        it += 1

    return SearchResult(prefix_ids=np.asarray(prefix, np.int32),
                        history=history, wall_time_s=time.time() - t0)


# ---------------------------------------------------------------------------
# Stage 2: quantization-aware prefix tuning (paper §4.2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TuneResult:
    cushion: Params
    log: List[Dict[str, float]]
    wall_time_s: float


def _or_zeros(g: Optional[torch.Tensor], t: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(t) if g is None else g


def _partition_cushion(cushion0: Params):
    """(frozen path substrings, stop-grad wrapper) for a cushion tree. The
    paper tunes the cached prefix KV, so the "kv" block is the only
    trainable subtree; anything beside it is frozen (detached in the loss,
    and passed through by AdamW's ``frozen`` mask). A tree without "kv"
    trains whole."""
    if "kv" not in cushion0:
        return (), lambda c: c
    frozen = tuple(k for k in cushion0 if k != "kv")
    if not frozen:
        return (), lambda c: c

    def stop_grad_frozen(c):
        return {k: (v if k == "kv" else tree_map(torch.Tensor.detach, v))
                for k, v in c.items()}

    return frozen, stop_grad_frozen


def tune_loss_grads(api, params, cushion: Params, batch: Dict[str, Any],
                    qcfg: QuantConfig, ccfg: CushionConfig,
                    scales: Optional[Params] = None,
                    stop_grad_frozen: Callable = None):
    """One tuning step's gradient into the cushion of L = CE + λ·range
    (``stop_grad_frozen``: ``_partition_cushion``'s, default: from the
    cushion), and its metrics ("loss", "ce", "range", "qerr"), device
    tensors. Under a data axis the batch is the rank's rows, the loss's
    reductions global and the gradients summed over the axis
    (``collectives.sum_over_data``): every rank gets the global gradient."""
    from repro_torch.core import outliers as OUT
    from repro_torch.distributed import collectives as DC
    if stop_grad_frozen is None:
        stop_grad_frozen = _partition_cushion(cushion)[1]
    leaves = tree_map(lambda t: t.detach().requires_grad_(), cushion)
    with torch.enable_grad():
        _, aux = api.loss_fn(params, batch, qcfg, scales=scales,
                             cushion=stop_grad_frozen(leaves),
                             collect=True, remat=False)
        reg = OUT.activation_range_penalty(aux["taps"])
        loss = aux["ce"] + ccfg.lam * reg
        got = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                       allow_unused=True))
    # a frozen leaf is detached in the loss: its gradient is zero
    grads = DC.sum_over_data(
        tree_map(lambda t: _or_zeros(next(got), t), leaves))
    return grads, {"loss": loss.detach(), "ce": aux["ce"].detach(),
                   "range": reg.detach(), "qerr": aux["qerr"].detach()}


def _ranks_equal(tree: Params) -> torch.Tensor:
    """1.0 where every rank of the active data and tp axes holds ``tree``
    equal (elementwise, as ``torch.equal``: the max over the ranks is the
    min), else 0.0; a device scalar."""
    from repro_torch.distributed import collectives as DC
    ok = torch.ones((), dtype=torch.bool, device=tree_leaves(tree)[0].device)
    for t in tree_leaves(tree):
        for axis in ("data", "tp"):
            if DC.axis_size(axis) > 1:
                ok = ok & (DC.pmax(t, axis) == DC.pmin(t, axis)).all()
    return ok.float()


def prefix_tune(api, params, cushion0: Params,
                batch_iter: Iterable[Dict[str, Any]],
                qcfg: QuantConfig, ccfg: CushionConfig,
                scales: Optional[Params] = None, mesh=None,
                verbose: bool = True) -> TuneResult:
    """Freeze the model; train the cushion KV on L = L_pred + λ·L_range
    (eq. 11) with ``ccfg.tune_steps`` AdamW steps (constant lr
    ``ccfg.tune_lr``, no weight decay, global-norm clip 1). The quantized
    forward is straight-through; the quantizers' scales and zero points
    carry no gradient.

    * The cushion trained is a private ``detach().clone()`` of
      ``cushion0`` (which may have been made under ``inference_mode``) and
      keeps its dtype: AdamW holds f32 moments and casts each update back.
    * Only the "kv" block trains (``_partition_cushion``): the frozen
      recurrent-state leaves come out bit for bit.
    * Per-step metrics stay on the device; the log drains every
      ``ccfg.log_every`` steps through ``monitoring.host_sync``, one
      transfer of the stacked pending metrics, so a run of ``n`` steps
      makes at most ``n / log_every + 1`` transfers (on each rank) and
      still logs every step.
    * ``mesh=`` (a ``launch/mesh.TPMesh`` with a data axis; every rank of
      it calls ``prefix_tune`` with the same global batches) splits each
      batch over the data axis with the cushion and its moments replicated
      (``train/trainer.shard_update_step``): the loss's reductions over
      the batch are global, the gradients summed over the axis, and every
      rank holds the same cushion after every step. The batch size must
      divide by the axis. A model axis of more than one rank (the dense,
      VLM, encoder-decoder and xLSTM families; ``check_data_parallel``)
      runs the model on the rank's shard (``engine.shard_tree``,
      ``tp_config``), ``params`` being the whole tree: the cushion is
      whole on every rank, and a leaf a rank reads in part (the family's
      ``cushion_summed``: the KV where the heads are cut, the xLSTM's
      mLSTM state where its values are) gets the rank's share of its
      gradient, summed over tp; the statistics and L_q of a cut activation
      are the ranks'.
    * On the card every layer's attention runs ``flash_attention`` forward
      and ``flash_attention_bwd`` backward.
    """
    from repro_torch import monitoring as MON
    from repro_torch.distributed import collectives as DC
    from repro_torch.optim.adamw import AdamW, constant_lr

    t0 = time.time()
    if mesh is not None:
        from repro_torch.train.trainer import (check_data_parallel,
                                               replicated_shardings,
                                               shard_update_step)
        check_data_parallel(api.cfg, int(mesh.data_size), int(mesh.size))
    shared = None
    if mesh is not None and int(mesh.size) > 1:
        from repro_torch.models.common import as_tree
        from repro_torch.serving import engine as E
        from repro_torch.train.trainer import sum_shared
        tp = int(mesh.size)
        params = E.shard_tree(as_tree(params), api.cfg, mesh)
        api = dataclasses.replace(api, cfg=E.tp_config(api.cfg, tp))
        # the leaves a rank reads in part, by family (the KV where the
        # heads are cut; the xLSTM's mLSTM state where its values are)
        shared = tree_map(lambda summed: E.TPPart(0, summed),
                          api.mod.cushion_summed(cushion0, api.cfg))
    frozen, stop_grad_frozen = _partition_cushion(cushion0)
    opt = AdamW(lr=constant_lr(ccfg.tune_lr), weight_decay=0.0,
                grad_clip=1.0, frozen=frozen)
    cushion = tree_map(lambda t: t.detach().clone(), cushion0)
    state = opt.init(cushion)

    def step(cush, state, batch):
        grads, metrics = tune_loss_grads(api, params, cush, batch, qcfg,
                                         ccfg, scales, stop_grad_frozen)
        if shared is not None:
            grads = sum_shared(grads, shared)
        cush, state, om = opt.update(grads, state, cush)
        metrics["gnorm"] = om["grad_norm"]
        if DC.data_size() > 1 or DC.tp_size() > 1:
            metrics["ranks_equal"] = _ranks_equal(cush)
        return cush, state, metrics

    step_fn = step
    if mesh is not None:
        step_fn = shard_update_step(step, mesh,
                                    replicated_shardings(cushion0, mesh),
                                    replicated_shardings(state, mesh), True)

    log: List[Dict[str, float]] = []
    pending: List[Tuple[int, Dict[str, torch.Tensor]]] = []
    log_every = max(1, int(ccfg.log_every))
    print_every = max(1, ccfg.tune_steps // 10)

    def drain():
        if not pending:
            return
        fetched = MON.host_sync([m for _, m in pending])
        for (j, _), mv in zip(pending, fetched):
            rec = {k: float(v) for k, v in mv.items()}
            rec["step"] = j
            if rec.get("ranks_equal", 1.0) != 1.0:
                raise RuntimeError(f"prefix_tune: the ranks' cushions "
                                   f"differ after step {j}")
            log.append(rec)
            if verbose and j % print_every == 0:
                print(f"[tune] step={j} loss={rec['loss']:.4f} "
                      f"ce={rec['ce']:.4f} range={rec['range']:.4g} "
                      f"L_q={rec['qerr']:.4g}")
        pending.clear()

    for i, batch in enumerate(batch_iter):
        if i >= ccfg.tune_steps:
            break
        cushion, state, metrics = step_fn(cushion, state, batch)
        pending.append((i, metrics))
        if len(pending) >= log_every:
            drain()
    drain()
    return TuneResult(cushion=tree_map(torch.Tensor.detach, cushion),
                      log=log, wall_time_s=time.time() - t0)


# ---------------------------------------------------------------------------
# End-to-end pipeline
# ---------------------------------------------------------------------------

def discover(api, params, sample_fn: Callable[[int], Dict[str, Any]],
             batch_iter: Iterable[Dict[str, Any]], qcfg: QuantConfig,
             ccfg: CushionConfig, gen: torch.Generator,
             skip_tune: bool = False, mesh=None, verbose: bool = True):
    """greedy search -> extract the cushion KV -> quantization-aware
    tuning. Returns (cushion, SearchResult, TuneResult | None). The
    artifact keeps the dtype ``extract_cushion`` emits (the model's): a
    bf16 model gets a bf16 cushion. ``mesh=``: every rank of its data axis
    calls ``discover``; rank 0 searches and broadcasts the prefix ids
    (another rank's ``SearchResult`` holds them and no history), every
    rank extracts the cushion, and ``prefix_tune`` runs on the mesh."""
    from repro_torch.distributed import collectives as DC
    lead = mesh is None or int(mesh.data_rank) == 0
    if lead:
        sr = greedy_search(api, params, sample_fn, qcfg, ccfg, gen,
                           verbose=verbose)
    if mesh is not None and int(mesh.data_size) > 1:
        n = DC.broadcast_ints([sr.prefix_ids.size if lead else 0], mesh,
                              axis="data")[0]
        ids = DC.broadcast_ints(sr.prefix_ids.tolist() if lead else [0] * n,
                                mesh, axis="data")
        if not lead:
            sr = SearchResult(prefix_ids=np.asarray(ids, np.int32),
                              history=[], wall_time_s=0.0)
    ids = sr.prefix_ids if sr.prefix_ids.size else np.asarray([0], np.int32)
    cushion = api.extract_cushion(
        params, torch.as_tensor(ids, dtype=torch.int32, device=api.device),
        None, qcfg)
    if skip_tune:
        return cushion, sr, None
    tr = prefix_tune(api, params, cushion, batch_iter, qcfg, ccfg, mesh=mesh,
                     verbose=verbose)
    return tr.cushion, sr, tr
