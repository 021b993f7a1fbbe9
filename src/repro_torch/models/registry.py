"""Model API over the ported families: ``build(cfg, device)`` ->
``ModelAPI`` (``repro/models/registry.py``). Only the dense family is
ported; the others raise.

Batch dicts hold ``{"tokens": (B, S) int tensor}`` on the API's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import Family, ModelConfig, QuantConfig
from repro_torch.models import common as C
from repro_torch.models import transformer as TR

Params = Dict[str, Any]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Asking for the card where there is none raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but is not available; pass "
                           "device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device

    @property
    def sites(self) -> Tuple[str, ...]:
        return TR.SITES

    def init_params(self, gen: torch.Generator) -> C.ParamTree:
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        return TR.init_params(self.cfg, gen)

    def forward(self, params, batch, qcfg: QuantConfig, **kw):
        return TR.forward(params, batch["tokens"], self.cfg, qcfg, **kw)

    def init_cache(self, batch: int, max_seq: int, dtype=None,
                   kv_dtype=None, prefix_len: int = 0,
                   per_slot_scales: bool = False):
        return TR.init_cache(self.cfg, batch, max_seq, self.device,
                             dtype=dtype, kv_dtype=kv_dtype,
                             prefix_len=prefix_len,
                             per_slot_scales=per_slot_scales)

    @property
    def cache_batch_axes(self) -> Dict[str, int]:
        """Batch axis of every per-request cache leaf: the continuous
        scheduler's slot-scatter map."""
        return TR.CACHE_BATCH_AXES

    @property
    def paged_kv_leaves(self) -> Tuple[str, ...]:
        """Cache leaves the paged pool re-lays into a flat page store."""
        return TR.PAGED_KV_LEAVES

    @property
    def supports_chunked_prefill(self) -> bool:
        """prefill() takes pos_offset to resume a staged B=1 fp row."""
        return TR.SUPPORTS_CHUNKED_PREFILL

    def finalize_staged_kv(self, row, cache, cushion, S: int):
        """The blocking admission row, rebuilt from a finished chunk-staged
        fp row (int8 pools calibrate their per-slot scales here)."""
        return TR.finalize_staged_kv(row, cache, cushion, S)

    def prefill(self, params, batch, cache, qcfg: QuantConfig, **kw):
        return TR.prefill(params, batch["tokens"], cache, self.cfg, qcfg, **kw)

    def decode_step(self, params, token, pos, cache, qcfg: QuantConfig, **kw):
        return TR.decode_step(params, token, pos, cache, self.cfg, qcfg, **kw)

    def cushion_zeros(self, m: int, dtype=None):
        return TR.cushion_zeros(self.cfg, m, self.device, dtype=dtype)

    def extract_cushion(self, params, prefix_ids: torch.Tensor, batch,
                        qcfg: QuantConfig) -> Params:
        """Turn a token prefix into the deployment cushion: its per-layer KV
        after one pass through the model (paper eq. 8). ``batch`` is unused
        by the dense family (kept for the reference's signature)."""
        m = int(prefix_ids.shape[0])
        cache = TR.init_cache(self.cfg, 1, m, self.device)
        _, cache, _ = TR.prefill(params, prefix_ids[None].to(self.device),
                                 cache, self.cfg, qcfg)
        return {"kv": {"k": cache["k"][:, 0, :m], "v": cache["v"][:, 0, :m]}}


def build(cfg: ModelConfig, device="cuda") -> ModelAPI:
    if cfg.family != Family.DENSE:
        raise NotImplementedError(
            f"{cfg.family.value}: only the dense family is ported "
            "(ROADMAP queue 1 item 5)")
    return ModelAPI(cfg=cfg, device=resolve_device(device))
