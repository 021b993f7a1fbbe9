"""InternVL2-style VLM backbone, ported from ``repro/models/vlm.py``: the
dense stack (``models/transformer.py``) with a stub vision frontend. The
inputs are precomputed patch embeddings ``patches`` (B, P, D), placed
before the token embeddings, so a sequence is [patches; text].

The cushion sits before the patches, so patches and text both see the
sink. Decode is the dense family's: patches enter at prefill only, and VLM
slots batch continuously like dense ones. The module defines no
``SUPPORTS_CHUNKED_PREFILL``, as the reference's does not: a request with
patches admits blocking.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.models import common as C
from repro_torch.models import transformer as T

Tensor = torch.Tensor
Params = Dict[str, Any]

SITES = T.SITES
# The prefix artifact is attention KV only: the search's KV-reuse scorer
# prefills the token prefix once (no patches: the cushion sits before
# them) and scores each candidate as [candidate embedding; patches; text].
SUPPORTS_PREFIX_KV_SCORING = True
init_params = T.init_params
init_cache = T.init_cache
cache_roles = T.cache_roles
cushion_zeros = T.cushion_zeros
cushion_summed = T.cushion_summed
decode_step = T.decode_step
placeholder_all_scales = T.placeholder_all_scales
total_qerr = T.total_qerr
CACHE_BATCH_AXES = T.CACHE_BATCH_AXES
PAGED_KV_LEAVES = T.PAGED_KV_LEAVES


def forward(params, tokens: Tensor, cfg: ModelConfig, qcfg: QuantConfig, *,
            patches: Tensor, scales: Optional[Params] = None,
            cushion: Optional[Params] = None, collect: bool = False,
            n_skip: int = 0, prefix_valid: Optional[int] = None,
            pos_offset: Optional[int] = None, groups: int = 1,
            remat: bool = True):
    """tokens: (B, S_text); patches: (B, P, D). Sequence = [patches; text]."""
    return T.forward(params, tokens, cfg, qcfg, scales=scales,
                     cushion=cushion, collect=collect, n_skip=n_skip,
                     prepend_embeds=patches, prefix_valid=prefix_valid,
                     pos_offset=pos_offset, groups=groups, remat=remat)


def prefill(params, tokens: Tensor, cache: Params, cfg: ModelConfig,
            qcfg: QuantConfig, *, patches: Tensor,
            scales: Optional[Params] = None,
            cushion: Optional[Params] = None, remat: bool = False):
    return T.prefill(params, tokens, cache, cfg, qcfg, scales=scales,
                     cushion=cushion, prepend_embeds=patches, remat=remat)


def loss_fn(params, tokens: Tensor, labels: Tensor, cfg: ModelConfig,
            qcfg: QuantConfig, *, patches: Tensor, scales=None, cushion=None,
            collect: bool = False, remat: bool = True, lam: float = 0.0):
    """CE over the text positions only (patch positions carry no labels);
    L_q skips the patches too (``n_skip=P``)."""
    P = patches.shape[1]
    logits, taps = T.forward(params, tokens, cfg, qcfg, scales=scales,
                             cushion=cushion, collect=collect or lam > 0,
                             n_skip=P, prepend_embeds=patches, remat=remat)
    ce = C.cross_entropy(logits[:, P:], labels)
    loss = ce
    aux = {"ce": ce, "taps": taps}
    if lam > 0 or collect:
        qerr = T.total_qerr(taps)
        aux["qerr"] = qerr
        if lam > 0:
            loss = loss + lam * qerr
    return loss, aux
