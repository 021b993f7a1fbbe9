"""CushionCache artifacts (paper §4). This slice ports the content
fingerprint only; the greedy search and prefix tuning come with the
method's slice (ROADMAP queue 1 item 2)."""
from __future__ import annotations

import hashlib
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

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
