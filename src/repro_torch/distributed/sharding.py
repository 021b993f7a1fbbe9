"""The partition rules of ``repro/distributed/sharding.py``, as pure
functions.

The reference resolves role templates ("B" batch, "D" fsdp, "M" tensor
parallel, None) against a mesh into ``PartitionSpec``s that GSPMD
executes. The port has no GSPMD: these functions return the same specs as
plain tuples of axis names (or None), and ``serving/engine.py``
``shard_params_for_serving`` and the engines' pools cut each rank's shard
by them. A mesh is anything with ``shape`` (axis name -> size) and
``axis_names`` (``launch/mesh.TPMesh``). ``constrain`` and ``use_mesh``
have no counterpart: the layout is explicit in the model code
(``distributed/collectives.py``).
"""
from __future__ import annotations

import re
from typing import Any, Sequence, Tuple

import numpy as np

Spec = Tuple[Any, ...]

# (regex over "/".join(path), role template), first match wins, aligned to
# the trailing dims (the reference's table)
DEFAULT_RULES: Tuple[Tuple[str, Tuple[Any, ...]], ...] = (
    (r"(^|/)embed(/w)?$", ("M", "D")),
    (r"(^|/)(lm_)?head(/w)?$", ("D", "M")),
    (r"pos_embed", (None, "D")),
    (r"attn/wqkv$", ("D", "M")),
    (r"attn/bqkv$", ("M",)),
    (r"attn/wo$", ("M", "D")),
    (r"mlp/w_(gate|up)$", ("D", "M")),
    (r"mlp/w_down$", ("M", "D")),
    (r"moe/w_(gate|up)$", ("M", "D", None)),
    (r"moe/w_down$", ("M", None, "D")),
    (r"moe/router$", ("D", None)),
    (r"mamba/w_in$", ("D", "M")),
    (r"mamba/w_out$", ("M", "D")),
    (r"mamba/(w_x|conv_w|A_log|D|dt_)", ("M",)),
    (r"xlstm/w_(qkv|if|o)$", ("D", "M")),
    (r"xlstm/w_proj$", ("M", "D")),
    (r".*", ()),
)


def serve_rules() -> Tuple[Tuple[str, Tuple[Any, ...]], ...]:
    """Inference rules: tensor parallel only (the "D" roles replicated)."""
    return tuple((rx, tuple(None if r == "D" else r for r in roles))
                 for rx, roles in DEFAULT_RULES)


def _resolve_role(role, mesh):
    """An axis role -> the mesh axis name(s) ("M" is ``tp`` on a serving
    mesh, ``model`` on a training one)."""
    names = mesh.axis_names
    if role is None:
        return None
    if role == "B":
        return ("pod", "data") if "pod" in names else "data"
    if role == "D":
        return "data"
    if role == "M":
        return "tp" if "tp" in names else "model"
    return role


def to_pspec(roles: Sequence[Any], mesh) -> Spec:
    return tuple(_resolve_role(r, mesh) for r in roles)


def _drop_indivisible(full: Sequence[Any], shape: Tuple[int, ...],
                      mesh) -> Spec:
    """Axes that do not divide their mesh extent are replicated."""
    fixed = []
    for dim, ax in zip(shape, full):
        if ax is None:
            fixed.append(None)
            continue
        size = int(np.prod([mesh.shape[a] for a in
                            (ax if isinstance(ax, tuple) else (ax,))]))
        fixed.append(ax if dim % size == 0 else None)
    return tuple(fixed)


def rules_pspec(path: str, shape: Tuple[int, ...], mesh,
                rules=DEFAULT_RULES) -> Spec:
    """A leaf's spec by its path. Integer-resident leaves: ``w_int`` /
    ``w_packed`` shard like their fp parent, ``colsum`` follows the
    parent's output axis (replicated where that axis is not sharded: the
    row-parallel ``wo`` and ``w_down`` at serving), ``w_scale``
    replicates."""
    path = re.sub(r"/w_(int|packed)$", "", path)
    if path.endswith("/w_scale"):
        return ()
    mcol = re.match(r"^(.*)/colsum$", path)
    if mcol:
        for rx, roles in rules:
            if re.search(rx, mcol.group(1)):
                out_role = roles[-1] if roles else None
                full = (None,) * (len(shape) - 1) \
                    + (_resolve_role(out_role, mesh),)
                return _drop_indivisible(full, shape, mesh)
        return ()
    for rx, roles in rules:
        if re.search(rx, path):
            pads = (None,) * (len(shape) - len(roles))
            full = pads + tuple(_resolve_role(r, mesh) for r in roles)
            return _drop_indivisible(full, shape, mesh)
    return ()


def roles_pspec(roles: Sequence[Any], shape: Tuple[int, ...], mesh) -> Spec:
    """A role template aligned to the leading dims (the cache leaves'
    convention; trailing dims replicated), indivisible axes dropped."""
    full = tuple(_resolve_role(r, mesh) for r in roles)
    full = full + (None,) * (len(shape) - len(full))
    return _drop_indivisible(full, shape, mesh)


def cache_shardings(roles: Any, cache: Any, mesh) -> Any:
    """The spec of every leaf of a serving cache tree from a family's
    ``cache_roles`` (nested for the xLSTM's state); leaves without a
    template entry are replicated."""
    if isinstance(cache, dict):
        rd = roles if isinstance(roles, dict) else {}
        return {key: cache_shardings(rd.get(key, ()), leaf, mesh)
                for key, leaf in cache.items()}
    rt = roles if isinstance(roles, (tuple, list)) else ()
    return roles_pspec(rt, tuple(cache.shape), mesh)


def tree_paths(tree: Any, prefix: str = "") -> Any:
    """The tree with every leaf replaced by its "/"-joined key path (list
    indices as numbers)."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: tree_paths(v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_paths(v, join(i)) for i, v in enumerate(tree)]
    return prefix


def params_shardings(params: Any, mesh, rules=DEFAULT_RULES) -> Any:
    """The spec of every leaf of a parameter tree (anything with
    ``shape``)."""
    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [visit(v, f"{path}/{i}" if path else str(i))
                    for i, v in enumerate(node)]
        return rules_pspec(path, tuple(node.shape), mesh, rules)
    return visit(params, "")
