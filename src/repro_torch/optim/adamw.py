"""AdamW with decoupled weight decay, global-norm gradient clipping and
pluggable learning-rate schedules, ported from ``repro/optim/adamw.py``
with its arithmetic: the clip on f32 gradients, f32 moments, the update
cast back to each leaf's dtype, frozen leaves passed through bit for bit.

Parameters, gradients and moments are nested dicts and lists of tensors
(the hybrid keeps its sublayers in a list); leaves are visited in JAX's
flatten order (dict keys sorted, list items by index), and the masks match
"/"-joined key paths, a list item named by its index (``tree_paths``, the
port's copy of ``distributed.sharding.tree_paths``). ``update`` is
functional: it returns new leaves and leaves its inputs as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, List, NamedTuple, Tuple

import torch

Tensor = torch.Tensor


def _flatten(tree: Any, path: Tuple[str, ...] = ()
             ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs in JAX's flatten order: dict keys sorted,
    list items by index, an item named by its index."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], path + (str(k),)))
        return out
    if isinstance(tree, list):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, path + (str(i),)))
        return out
    return [(path, tree)]


def _unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    """``like``'s structure (dicts come back with their keys sorted, as
    JAX's) filled from ``leaves`` in flatten order."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, list):
        return [_unflatten(v, leaves) for v in like]
    return next(leaves)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of one or more trees of the same structure."""
    others = [tree_leaves(t) for t in rest]
    return _unflatten(tree, iter(
        [fn(leaf, *(o[i] for o in others))
         for i, leaf in enumerate(tree_leaves(tree))]))


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in _flatten(tree)]


def tree_paths(tree: Any) -> Any:
    """A tree of "/"-joined key paths, the same structure as ``tree``."""
    return _unflatten(tree, iter(["/".join(p) for p, _ in _flatten(tree)]))


def _sharded_norm(gs: List[Tensor], sharded: List[Any]) -> Tensor:
    """The global norm of a tree held in shards (``sharded``: each leaf's
    ``train/trainer.Shard``, ``(data, own)``): the squared sums of a
    leaf's "data" shard summed over the active data axis, those of the
    rank's tensor-parallel part (the leading ``own`` entries of its last
    axis, -1 all of them) over the tp axis as well, and each entry whole on
    every rank counted once."""
    from repro_torch.distributed import collectives as DC
    zero = torch.zeros((), dtype=torch.float32, device=gs[0].device)
    # once, over data, over tp, over both
    sums = [zero] * 4
    for g, (data, own) in zip(gs, sharded):
        g = g.float().reshape(g.shape or (1,))
        n = g.shape[-1] if own < 0 else own
        for whole, t in ((False, g.narrow(-1, 0, n)),
                         (True, g.narrow(-1, n, g.shape[-1] - n))):
            if t.numel():
                i = int(data) + (0 if whole else 2)
                sums[i] = sums[i] + t.square().sum()
    over_data = DC.psum(torch.stack([sums[1], sums[3]]), "data")
    over_tp = DC.psum(torch.stack([sums[2], over_data[1]]), "tp")
    return torch.sqrt(over_data[0] + sums[0] + over_tp[0] + over_tp[1])


class AdamWState(NamedTuple):
    step: Tensor
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[Tensor], Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # decay mask: paths matching these substrings get no weight decay
    no_decay: tuple = ("ln", "norm", "bias", "b_if", "dt_b", "A_log",
                       "Dskip", "/g", "/b")
    # freeze mask: paths matching these substrings pass through bit for bit
    # (no f32 round trip, no moment update) and stay out of the global-norm
    # clip (prefix_tune freezes everything of a cushion but its "kv" block)
    frozen: tuple = ()

    def init(self, params: Any) -> AdamWState:
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        dev = tree_leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          mu=tree_map(z, params), nu=tree_map(z, params))

    def _mask(self, params: Any, subs: tuple) -> List[bool]:
        return [any(s in p for s in subs) for p in tree_leaves(
            tree_paths(params))]

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any,
               sharded: Any = None, donate: bool = False):
        """One step. Returns (params, state, {"grad_norm", "lr"}).
        ``sharded``: a tree of ``train/trainer.Shard`` beside ``params``
        marking how each leaf holds this rank's shard of a leaf split over
        the active data axis and the tp axis
        (``train/trainer.shard_train_step``); the clip's norm is then the
        whole tree's, the shards' squares summed over their axes and each
        replicated entry counted once. ``donate``: the new parameters and
        moments are written into the given ones (the reference's donated
        train state) and returned, the same values bit for bit; the caller
        must not read the old ones again."""
        ps = tree_leaves(params)
        gs = tree_leaves(grads)
        ms, vs = tree_leaves(state.mu), tree_leaves(state.nu)
        frozen = (self._mask(params, self.frozen) if self.frozen
                  else [False] * len(ps))
        decay = [not f for f in self._mask(params, self.no_decay)]
        # frozen leaves contribute nothing to the global norm
        gs = [torch.zeros_like(g) if f else g for g, f in zip(gs, frozen)]
        if self.grad_clip > 0 and sharded is not None:
            gn = _sharded_norm(gs, tree_leaves(sharded))
        elif self.grad_clip > 0:
            gn = torch.sqrt(sum(g.float().square().sum() for g in gs))
        scale = None
        if self.grad_clip > 0:
            scale = torch.clamp(self.grad_clip / (gn + 1e-9), max=1.0)
        else:
            gn = torch.zeros((), device=ps[0].device)
        step = state.step + 1
        lr_t = self.lr(step)
        sf = step.float()
        b1c = 1.0 - torch.pow(self.b1, sf)
        b2c = 1.0 - torch.pow(self.b2, sf)
        new_p, new_m, new_v = [], [], []
        for g, m, v, p, dk, fz in zip(gs, ms, vs, ps, decay, frozen):
            if fz:
                new_p.append(p)         # bit-identical passthrough
                new_m.append(m)
                new_v.append(v)
                continue
            ins = [t.contiguous() for t in (g, m, v, p)]
            out = (m, v, p) if donate and all(
                t.is_contiguous() for t in (m, v, p)) else tuple(
                    torch.empty(t.shape, dtype=t.dtype, device=t.device)
                    for t in (m, v, p))
            # elementwise, a chunk of a leaf at a time: the same arithmetic
            # with the f32 temporaries of one chunk alive, not of a leaf
            # (internvl2-26b's embedding is 568 M entries)
            n = g.numel()
            for i in range(0, max(n, 1), UPDATE_CHUNK):
                sl = slice(i, min(i + UPDATE_CHUNK, n))
                self._update_chunk(*(t.view(-1)[sl] for t in (*ins, *out)),
                                   scale, b1c, b2c, lr_t,
                                   dk and self.weight_decay > 0)
            new_m.append(out[0])
            new_v.append(out[1])
            new_p.append(out[2])
        return (_unflatten(params, iter(new_p)),
                AdamWState(step=step, mu=_unflatten(params, iter(new_m)),
                           nu=_unflatten(params, iter(new_v))),
                {"grad_norm": gn, "lr": lr_t})

    def _update_chunk(self, g, m, v, p, m_out, v_out, p_out, scale, b1c,
                      b2c, lr_t, decay: bool) -> None:
        """AdamW's step on matching pieces of one leaf: the f32 (clipped)
        gradient, the moments and the parameter written into ``m_out``,
        ``v_out`` and ``p_out`` (which may be ``m``, ``v`` and ``p``)."""
        g = g.float() if scale is None else g.float() * scale
        torch.mul(m, self.b1, out=m_out).add_((1 - self.b1) * g)
        torch.mul(v, self.b2, out=v_out).add_((1 - self.b2) * g.square())
        del g
        delta = (m_out / b1c).div_((v_out / b2c).sqrt_().add_(self.eps))
        if decay:
            delta.add_(self.weight_decay * p.float())
        p_out.copy_(p.float() - delta.mul_(lr_t))


# the entries of a leaf that ``AdamW.update`` takes in one piece
UPDATE_CHUNK = 1 << 24


def constant_lr(lr: float) -> Callable[[Tensor], Tensor]:
    # a fill on the step's device: no host-to-device copy per step
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def cosine_lr(peak: float, warmup: int, total: int,
              floor: float = 0.1) -> Callable[[Tensor], Tensor]:
    def f(step):
        s = step.float()
        warm = s / max(1.0, warmup)
        prog = torch.clamp((s - warmup) / max(1.0, total - warmup), 0, 1)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak * torch.where(s < warmup, warm, cos)
    return f
