"""The training step, ported from ``repro/train/trainer.py`` for one card:
``TrainState``, ``make_optimizer``, ``make_train_step`` (gradient
accumulation over microbatches, remat per layer, the quantization-aware
forward with straight-through fake quant), ``eval_ppl`` and
``eval_next_token_acc``.

The step is functional, as the reference's ``jax.value_and_grad``: it takes
fresh leaves of the parameter tree that require a gradient, runs
``api.loss_fn`` with ``remat=run.parallel.remat``, differentiates with
``torch.autograd.grad`` and hands the gradients to ``AdamW.update``, which
returns new leaves. Metrics stay device tensors, so a step makes no host
sync. On the card every layer's attention runs ``flash_attention`` forward
(twice with remat: the recompute) and ``flash_attention_bwd`` backward.

The reference's mesh entries (``replicated_shardings``,
``shard_update_step``, ``shard_train_step``) raise: training meshes are
not ported (ROADMAP queue 1 item 6.1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import QuantConfig, RunConfig
from repro_torch.core.quantization import SiteScale
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
    device tensors."""
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
        if microbatches == 1:
            loss, aux, grads = grads_of(params, batch)
        else:
            mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                               + tuple(v.shape[1:]))
                  for k, v in batch.items()}
            grads = tree_map(lambda a: torch.zeros(
                a.shape, dtype=torch.float32, device=a.device), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(microbatches):
                li, _, gi = grads_of(params, {k: v[i] for k, v in mb.items()})
                grads = tree_map(torch.add, grads, gi)
                lsum = lsum + li
            grads = tree_map(lambda a: a / microbatches, grads)
            loss = lsum / microbatches
            aux = {}
        params, opt_state, om = opt.update(grads, opt_state, params)
        metrics = {"loss": loss, **om}
        if isinstance(aux, dict) and "ce" in aux:
            metrics["ce"] = aux["ce"].detach()
        return params, opt_state, metrics

    return train_step


def _not_ported(name: str):
    raise NotImplementedError(
        f"{name}: training meshes (tensor parallel, data parallel over "
        "several cards) are not ported yet: ROADMAP queue 1 item 6.1")


def replicated_shardings(tree: Any, mesh: Any) -> Any:
    """The reference lays small trainable trees out replicated over a
    mesh; the port has no meshes yet."""
    _not_ported("replicated_shardings")


def shard_update_step(step_fn: Callable, mesh: Any, var_shardings: Any,
                      opt_shardings: Any, batch_like: Any = None):
    """The reference compiles an update step for a mesh; the port has no
    meshes yet."""
    _not_ported("shard_update_step")


def shard_train_step(api, run: RunConfig, opt: AdamW, mesh: Any,
                     params_abstract: Any, microbatches: int = 1,
                     cushion: Any = None, scales: Any = None):
    """The reference compiles the train step for a mesh with its partition
    rules; the port has no meshes yet."""
    _not_ported("shard_train_step")


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
