"""Architecture registry: --arch <id> resolves here."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401
    CushionConfig,
    EncDecConfig,
    Family,
    HybridConfig,
    ModelConfig,
    MoEConfig,
    ParallelConfig,
    QuantConfig,
    RunConfig,
    SSMConfig,
    reduced,
)

_ARCH_MODULES: Dict[str, str] = {
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "whisper-base": "repro_torch.configs.whisper_base",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_05b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "paper_tiny": "repro_torch.configs.paper_tiny",
}

ARCH_IDS = [a for a in _ARCH_MODULES if a != "paper_tiny"]


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


# Assigned input shapes (LM shapes: seq_len x global_batch).
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# long_500k needs sub-quadratic attention: only SSM/hybrid archs run it
# (see DESIGN.md §6). Everyone runs the other three.
LONG_CONTEXT_ARCHS = ("xlstm-350m", "jamba-v0.1-52b")


def cell_is_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True
