"""The training step, ported from ``repro/train/trainer.py``:
``TrainState``, ``make_optimizer``, ``make_train_step`` (gradient
accumulation over microbatches, remat per layer, the quantization-aware
forward with straight-through fake quant), the mesh entries
(``replicated_shardings``, ``shard_update_step``, ``shard_train_step``),
``eval_ppl`` and ``eval_next_token_acc``.

The step is functional, as the reference's ``jax.value_and_grad``: it takes
fresh leaves of the parameter tree that require a gradient, runs
``api.loss_fn`` with ``remat=run.parallel.remat``, differentiates with
``torch.autograd.grad`` and hands the gradients to ``AdamW.update``, which
returns new leaves. Metrics stay device tensors, so a step makes no host
sync. On the card every layer's attention runs ``flash_attention`` forward
(twice with remat: the recompute) and ``flash_attention_bwd`` backward.

Data parallelism runs one process a rank (``launch/mesh.spawn_mesh``).
``shard_update_step`` gives each rank its rows of the global batch and
runs a step with the mesh's data axis active
(``distributed/collectives.use_data``): every reduction over the batch in
the model code is then global, each rank's loss carries its share of the
global loss's gradient, and the gradients are summed over the axis where
they meet the optimizer (``collectives.sum_over_data``), so every rank
takes the same update. ``shard_train_step`` adds FSDP: a rank keeps the
``data`` shard of every leaf the training rules shard ("D") and the AdamW
moments of that shard (ZeRO-1); a step gathers the whole leaves, runs on
the rank's rows, keeps its shard of the summed gradients (an all-reduce,
then a slice: gloo on one card has no reduce-scatter for CUDA tensors) and
updates the shard, clipping by the whole tree's norm.

Tensor-parallel training (the dense, VLM, encoder-decoder and xLSTM
families on a ``model`` axis of more than one rank): a rank's tree, once
gathered over ``data``, is the one
``serving/engine.shard_tree`` gives a rank at that tp, and the rank runs
its config (``tp_config``) with the mesh's tp axis active, so the model
code's collectives and their gradients (``distributed/collectives.py``:
copy-to-tp where a replicated activation enters a cut site, reduce-from-tp
after a row-parallel one) make every replicated activation's gradient the
whole one on every rank. A leaf whole on every rank but read in part
(``engine.tp_leaf_parts``: every KV head's ``wqkv`` columns where the KV
heads do not divide; the encoder-decoder's ``xattn/wq`` and ``xattn/wkv``
where the heads are cut) has its gradient summed over tp where the
gradients meet the optimizer; the clip's norm sums the squares of the
rank's parts over tp and counts each whole leaf once. The families with
experts (MoE and the Jamba hybrid) on a model axis, and the experts over a
data axis, are not ported yet (ROADMAP queue 1, items 6.10b and 6.11).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import (Family, ModelConfig, QuantConfig,
                                      RunConfig)
from repro_torch.core.quantization import SiteScale
from repro_torch.distributed import collectives as DC
from repro_torch.distributed import sharding as SH
from repro_torch.launch import cost
from repro_torch.models.common import as_tree
from repro_torch.optim.adamw import (AdamW, AdamWState, cosine_lr,
                                     tree_leaves, tree_map)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: AdamWState
    step: int


def make_optimizer(run: RunConfig) -> AdamW:
    return AdamW(lr=cosine_lr(run.lr, run.warmup_steps, run.train_steps),
                 weight_decay=run.weight_decay, grad_clip=run.grad_clip)


def _trainable(t: torch.Tensor) -> torch.Tensor:
    """A fresh leaf of ``t`` (no copy) that requires a gradient."""
    t = t.detach()
    return t.requires_grad_() if t.is_floating_point() else t


def _autograd_usable(tree: Any) -> Any:
    """``tree`` (dicts, lists, ``SiteScale`` leaves) with every tensor made
    under ``torch.inference_mode`` (calibrated scales, an extracted cushion)
    cloned, so that autograd may save it; other tensors as they are."""
    if isinstance(tree, dict):
        return {k: _autograd_usable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_autograd_usable(v) for v in tree]
    if isinstance(tree, SiteScale):
        return SiteScale(_autograd_usable(tree.scale),
                         _autograd_usable(tree.zero))
    if isinstance(tree, torch.Tensor) and tree.is_inference():
        return tree.clone()
    return tree


def make_train_step(api, run: RunConfig, opt: AdamW, microbatches: int = 1,
                    cushion: Any = None, scales: Any = None) -> Callable:
    """Builds ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``. With ``microbatches`` > 1 the batch is split along its
    leading axis, the gradients summed in microbatch order into f32 zeros
    and divided, as the reference's scan does. ``metrics``: "loss", the
    optimizer's "grad_norm" and "lr", and with one microbatch "ce", all
    device tensors. Under an active data axis (``shard_update_step``) the
    gradients are summed over it before the update."""
    return _train_step(api, run, opt, microbatches, cushion, scales)


def _train_step(api, run: RunConfig, opt: AdamW, microbatches: int,
                cushion: Any, scales: Any, fsdp: Any = None,
                donate: bool = False) -> Callable:
    """``make_train_step``; with ``fsdp`` (an ``_FSDP``) the step takes and
    returns the rank's shards of the parameters and moments, written in
    place with ``donate`` (``AdamW.update``)."""
    qcfg = run.quant
    cushion, scales = _autograd_usable(cushion), _autograd_usable(scales)

    def grads_of(params, batch):
        leaves = tree_map(_trainable, params)
        with torch.enable_grad():
            loss, aux = api.loss_fn(leaves, batch, qcfg, cushion=cushion,
                                    scales=scales, remat=run.parallel.remat)
            want = [t for t in tree_leaves(leaves) if t.requires_grad]
            got = iter(torch.autograd.grad(loss, want, allow_unused=True))

        def grad(t):
            # an unused leaf's gradient is zero, as jax.grad gives it
            g = next(got) if t.requires_grad else None
            return torch.zeros_like(t) if g is None else g
        return loss.detach(), aux, tree_map(grad, leaves)

    def train_step(params, opt_state, batch):
        params = as_tree(params)
        full = params if fsdp is None else fsdp.gather(params)
        if microbatches == 1:
            loss, aux, grads = grads_of(full, batch)
        else:
            mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                               + tuple(v.shape[1:]))
                  for k, v in batch.items()}
            grads = tree_map(lambda a: torch.zeros(
                a.shape, dtype=torch.float32, device=a.device), full)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(full)[0].device)

            def body(i, carry):
                li, _, gi = grads_of(full, {k: v[i] for k, v in mb.items()})
                return None, [tree_map(torch.add, carry[0], gi),
                              carry[1] + li]
            # a loop in microbatch order (on the dry-run's meta tensors one
            # microbatch, counted ``microbatches`` times: launch/cost.scan)
            _, (grads, lsum) = cost.scan(microbatches, body, [grads, lsum])
            grads = tree_map(lambda a: a / microbatches, grads)
            loss = lsum / microbatches
            aux = {}
        del full
        # where the gradients meet the optimizer: each rank's share of a
        # leaf read in part, summed over tp; each rank's share of the
        # global loss's gradient, summed over the data axis
        if fsdp is not None:
            grads = fsdp.sum_shared(grads)
        grads = DC.sum_over_data(grads)
        if fsdp is None:
            params, opt_state, om = opt.update(grads, opt_state, params)
        else:
            params, opt_state, om = opt.update(
                fsdp.shard(grads), opt_state, params, sharded=fsdp.sharded,
                donate=donate)
        metrics = {"loss": loss, **om}
        if isinstance(aux, dict) and "ce" in aux:
            metrics["ce"] = aux["ce"].detach()
        return params, opt_state, metrics

    return train_step


TP_TRAINING_LATER = ("tensor-parallel training of the {family} family (a "
                     "model axis of {tp} ranks) is not ported yet (ROADMAP "
                     "queue 1, item 6.10b{more})")
# the families that train and tune on a model axis of more than one rank
TP_TRAINING_FAMILIES = (Family.DENSE, Family.VLM, Family.ENCDEC, Family.SSM)


def check_data_parallel(cfg: ModelConfig, data: int, model: int = 1
                        ) -> None:
    """Refuse what training and tuning over a ``(data, model)`` mesh do not
    run yet: a model axis of more than one rank for the families with
    experts (MoE, the hybrid: ``apply_moe``'s backward under tp is item
    6.10b's), and a family with experts over a data axis of more than one
    rank; and, on a model axis, what tensor-parallel serving refuses
    (``engine.check_tp_serving``: query heads that straddle the groups of
    whole KV heads)."""
    experts = cfg.family == Family.MOE or cfg.moe is not None
    if model > 1 and cfg.family not in TP_TRAINING_FAMILIES:
        raise ValueError(f"{cfg.name}: " + TP_TRAINING_LATER.format(
            family=cfg.family.value, tp=model,
            more="; its experts over a data axis, item 6.11" if experts
            else ""))
    if data > 1 and experts:
        from repro_torch.models.moe import DATA_AXIS_LATER
        raise ValueError(f"{cfg.name}: {DATA_AXIS_LATER}")
    if model > 1:
        from repro_torch.serving.engine import check_tp_serving
        check_tp_serving(cfg, QuantConfig(), model)


def _map_leaves(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of dicts, lists, tuples and NamedTuples (an
    ``AdamWState``)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def replicated_shardings(tree: Any, mesh: Any) -> Any:
    """Every leaf replicated over ``mesh`` (the port's spec ``()``): the
    layout of small trainable trees (the cushion KV block and its AdamW
    moments) that ride a data axis for batch parallelism only."""
    return _map_leaves(lambda _: (), tree)


def shard_update_step(step_fn: Callable, mesh: Any, var_specs: Any,
                      opt_specs: Any, batch_like: Any = None) -> Callable:
    """An ``(vars, opt_state, global_batch) -> (vars, opt_state, metrics)``
    update step over ``mesh``: with ``batch_like`` given (only its being
    given matters) each rank keeps its rows of every batch leaf (the
    leading axis split over "data", which it must divide; the reference's
    batch sharding), and ``step_fn`` runs on them with the data axis active
    (``collectives.use_data``), and the tp axis (``use_tp``) where the
    mesh's model axis has more than one rank. The carried state stays on
    each rank as ``var_specs`` / ``opt_specs`` lay it out (replicated, or
    the rank's shard): the step function keeps it so, and nothing moves it
    between steps. Shared by ``shard_train_step`` (FSDP shards) and
    ``cushioncache.prefix_tune`` (the replicated cushion)."""
    def step(variables, opt_state, batch):
        if batch_like is not None:
            batch = DC.rank_rows(batch, mesh)
        tp = DC.use_tp(mesh) if int(mesh.size) > 1 \
            else contextlib.nullcontext()
        with DC.use_data(mesh), tp:
            return step_fn(variables, opt_state, batch)
    return step


class Shard(NamedTuple):
    """How a rank holds one leaf of its training tree, for the clip's norm
    (``optim/adamw._sharded_norm``): ``data``, its "data" shard; ``own``,
    as ``engine.TPPart``: the leading entries of the last axis that are the
    rank's part of a leaf cut over tp (-1 all, 0 none)."""
    data: bool
    own: int = 0


def sum_shared(grads: Any, parts: Any) -> Any:
    """The gradients with every part read in part on each rank
    (``engine.TPPart.summed``: a leaf's entries past ``own`` on its last
    axis) summed over tp, in f32, in one all-reduce; the others as they
    are. A no-op at one rank."""
    if DC.tp_size() == 1:
        return grads
    ps = tree_leaves(parts)
    gs = [g.float() if p.summed else g
          for g, p in zip(tree_leaves(grads), ps)]
    pieces = [g.narrow(-1, p.own, g.shape[-1] - p.own)
              for g, p in zip(gs, ps) if p.summed]
    if not pieces:
        return grads
    flat = DC.psum(torch.cat([t.reshape(-1) for t in pieces]))
    for t, s in zip(pieces, torch.split(flat, [t.numel() for t in pieces])):
        t.copy_(s.reshape(t.shape))
    it = iter(gs)
    return tree_map(lambda _: next(it), grads)


class _FSDP:
    """The "data" shards of a tree by its specs on one rank: ``shard``
    slices the rank's part of each sharded leaf (a copy, so the whole leaf
    can be freed), ``gather`` rebuilds the whole leaves (each rank's part
    in a buffer filled with -0.0, summed over the axis: adding -0.0 is
    exact for every value, +0 and -0 included, so the gathered leaf is
    bit for bit the one that was sharded). The leaves are a rank's tree:
    with ``parts`` (``engine.tp_leaf_parts``) its tensor-parallel shards,
    whose dims the specs of the whole tree still name (the "data" dim of a
    leaf is never the one tp cuts, so it keeps its size)."""

    def __init__(self, specs: Any, mesh: Any, parts: Any = None):
        self.mesh = mesh
        # a spec tuple is a leaf of the optimizer's tree functions
        self.axes = tree_map(
            lambda spec: spec.index("data") if "data" in spec else None,
            specs)
        self.parts = parts
        owns = tree_map(lambda _: 0, specs) if parts is None else \
            tree_map(lambda p: p.own, parts)
        self.sharded = tree_map(lambda spec, own: Shard("data" in spec, own),
                                specs, owns)

    def sum_shared(self, grads: Any) -> Any:
        return grads if self.parts is None else sum_shared(grads,
                                                           self.parts)

    def _d(self) -> int:
        # the "data" axis of the mesh (the batch axes may also hold "pod",
        # over which the "data" shards are replicated)
        return int(self.mesh.shape.get("data", self.mesh.data_size))

    def shard(self, tree: Any) -> Any:
        d, r = self._d(), int(self.mesh.data_rank) % self._d()

        def one(leaf, ax):
            if ax is None or d == 1:
                return leaf
            n = leaf.shape[ax] // d
            return leaf.narrow(ax, r * n, n).clone()
        return tree_map(one, tree, self.axes)

    def gather(self, tree: Any) -> Any:
        d, r = self._d(), int(self.mesh.data_rank) % self._d()

        def one(leaf, ax):
            if ax is None or d == 1:
                return leaf
            n = leaf.shape[ax]
            shape = list(leaf.shape)
            shape[ax] = n * d
            fill = -0.0 if leaf.is_floating_point() else 0
            full = torch.full(shape, fill, dtype=leaf.dtype,
                              device=leaf.device)
            full.narrow(ax, r * n, n).copy_(leaf)
            return DC.psum(full, "data")
        return tree_map(one, tree, self.axes)


def shard_train_step(api, run: RunConfig, opt: AdamW, mesh: Any,
                     params_like: Any, microbatches: int = 1,
                     cushion: Any = None, scales: Any = None,
                     donate: bool = False):
    """The train step over ``mesh`` (axes ``("data", "model")`` or
    ``("data", "tp")``; a model axis of more than one rank for the
    families of ``TP_TRAINING_FAMILIES``) with FSDP parameter layouts by
    the training rules (``distributed/sharding.DEFAULT_RULES``: "D" is the
    ``data`` axis) on
    the rank's tensor-parallel tree (the serving cut at the mesh's tp,
    ``engine.shard_tree``; see the module docstring) and ZeRO-1 moments
    that inherit them. Returns ``(fn, param_specs, opt_specs)``:
    ``fn(shards, opt_state, global_batch) -> (shards, opt_state,
    metrics)`` on each rank's shards (``data_shards`` of the whole tree;
    ``opt.init`` of them) and its rows of the batch. ``params_like``: the
    whole tree (its shapes; a meta tree will do). ``donate``: the step
    writes the new shards and moments into the given ones, as the
    reference's donated state (the same values; a rank then holds one
    copy of its state, not two, when it updates)."""
    from repro_torch.serving import engine as E
    tp = int(mesh.size)
    check_data_parallel(api.cfg, int(mesh.data_size), tp)
    p_specs = SH.params_shardings(as_tree(params_like), mesh)
    o_specs = AdamWState(step=(), mu=p_specs, nu=p_specs)
    parts = E.tp_leaf_parts(as_tree(params_like), api.cfg, tp)
    if tp > 1:
        api = dataclasses.replace(api, cfg=E.tp_config(api.cfg, tp))
    step_fn = _train_step(api, run, opt, microbatches, cushion, scales,
                          fsdp=_FSDP(p_specs, mesh, parts), donate=donate)
    return (shard_update_step(step_fn, mesh, p_specs, o_specs, True),
            p_specs, o_specs)


def data_shards(tree: Any, specs: Any, mesh: Any, cfg: Any = None) -> Any:
    """This rank's part of a whole tree laid out by ``specs``: on a model
    axis of more than one rank its tensor-parallel shard first
    (``engine.shard_tree`` by ``cfg``, the whole model's config), then the
    leaves with a "data" axis cut to the rank's slice, the others as they
    are."""
    tree = as_tree(tree)
    if int(mesh.size) > 1:
        if cfg is None:
            raise ValueError("a model axis of more than one rank: pass the "
                             "model's cfg for its tensor-parallel cut")
        from repro_torch.serving.engine import shard_tree
        tree = shard_tree(tree, cfg, mesh)
    return _FSDP(specs, mesh).shard(tree)


@torch.no_grad()
def eval_ppl(api, params, batches, qcfg: QuantConfig, cushion=None,
             scales=None) -> float:
    """Perplexity over an eval set (the paper's Tables 1/4 metric): exp of
    the mean per-batch next-token CE."""
    tot, n = 0.0, 0
    for b in batches:
        tot += float(api.loss_fn(params, b, qcfg, cushion=cushion,
                                 scales=scales, remat=False)[1]["ce"])
        n += 1
    return float(np.exp(tot / max(n, 1)))


@torch.no_grad()
def eval_next_token_acc(api, params, batches, qcfg: QuantConfig,
                        cushion=None, scales=None) -> float:
    """Next-token top-1 accuracy (the zero-shot-accuracy stand-in for the
    paper's Table 2 at CPU scale): the argmax of the logits against the
    pipeline's pre-shifted labels (``labels[:, i] = tokens[:, i + 1]``),
    averaged per batch, then over the batches."""
    vals = []
    for b in batches:
        logits, _ = api.forward(params, b, qcfg, cushion=cushion,
                                scales=scales, remat=False)
        pred = logits.argmax(dim=-1)
        vals.append(float((pred == b["labels"]).float().mean()))
    return float(np.mean(vals))
