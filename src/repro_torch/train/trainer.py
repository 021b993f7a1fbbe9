"""Evaluation helper of ``repro/train/trainer.py``: ``eval_ppl``. The
trainer itself is not ported (ROADMAP queue 1 item 6)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import QuantConfig


@torch.no_grad()
def eval_ppl(api, params, batches, qcfg: QuantConfig, cushion=None,
             scales=None) -> float:
    """Perplexity over an eval set (the paper's Tables 1/4 metric): exp of
    the mean per-batch next-token CE."""
    tot, n = 0.0, 0
    for b in batches:
        tot += float(api.loss_fn(params, b, qcfg, cushion=cushion,
                                 scales=scales)[1]["ce"])
        n += 1
    return float(np.exp(tot / max(n, 1)))
