"""Serving counters. This slice ports ``resident_weight_bytes`` only."""
from __future__ import annotations

from typing import Any, Tuple

import torch


def _leaves(tree: Any, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def resident_weight_bytes(params: Any) -> Tuple[int, int, int]:
    """(fp_bytes, int8_bytes, int4_bytes) of a served parameter tree: int8
    ``w_int`` leaves stream 1 byte per weight, nibble-packed ``w_packed``
    leaves 0.5; everything else (embeddings, norms, scales) counts as fp.
    The port holds ``w_scale`` in f32 where the reference keeps the weight
    dtype, so a bf16 model's fp count is 2 bytes larger per matrix."""
    if hasattr(params, "tree"):
        params = params.tree()
    fp = i8 = i4 = 0
    for path, leaf in _leaves(params):
        n = leaf.numel() * leaf.element_size()
        if path and path[-1] == "w_packed":
            i4 += n
        elif leaf.dtype == torch.int8:
            i8 += n
        else:
            fp += n
    return fp, i8, i4
