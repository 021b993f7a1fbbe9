"""Load the JAX package's pytrees into the port, through numpy.

``params_from_numpy`` takes a parameter tree as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns the port's ``ParamTree``;
``scales_from_numpy`` takes the plain ``{"scale", "zero"}`` form of a scales
tree (``calibration.scales_to_plain``); ``cushion_from_numpy`` a cushion.
bf16 arrives as an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy``
refuses, so it crosses as its uint16 bit pattern. A leaf that is already a
tensor (``checkpoint.store`` ``restore_tree``) is moved as it is. Every
leaf keeps its dtype: the MoE family's ``moe`` subtree crosses with its f32
router ``(L, D, E)`` inside a bf16 model, the experts ``w_up`` / ``w_gate``
``(L, E, D, F)`` and ``w_down`` ``(L, E, F, D)``, and arctic's dense
``residual`` MLP. The hybrid family's sublayers are a list
(``params["layers"]["sub"]``) and cross as a list.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.quantization import SiteScale
from repro_torch.models.common import ParamTree


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a, order="C")      # a C-ordered copy, 0-dim kept
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _tree(d: Any, device) -> Any:
    if isinstance(d, dict):
        return {k: _tree(v, device) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [_tree(v, device) for v in d]
    return tensor_from_numpy(d, device)


def params_from_numpy(tree: Dict[str, Any], device="cpu") -> ParamTree:
    return ParamTree(_tree(tree, device))


def scales_from_numpy(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    def visit(d):
        if set(d) == {"scale", "zero"}:
            return SiteScale(scale=tensor_from_numpy(d["scale"], device),
                             zero=tensor_from_numpy(d["zero"], device))
        return {k: visit(v) for k, v in d.items()}
    return visit(tree)


def cushion_from_numpy(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    return _tree(tree, device)
