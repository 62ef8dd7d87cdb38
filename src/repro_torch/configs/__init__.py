"""Architecture registry: one module per supported architecture.

`get(arch_id)` -> ModelConfig (full published config)
`get_reduced(arch_id)` -> CPU-smoke-scale config of the same family
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "deepseek_67b",
    "yi_6b",
    "gemma3_27b",
    "yi_34b",
    "grok1_314b",
    "mixtral_8x7b",
    "xlstm_350m",
    "qwen2_vl_72b",
    "zamba2_1p2b",
    "seamless_m4t_medium",
]

# normalized aliases (--arch deepseek-67b etc.)
ALIASES = {a.replace("_", "-").replace("-1p2b", "-1.2b"): a for a in ARCH_IDS}
ALIASES.update({a: a for a in ARCH_IDS})
ALIASES["grok-1-314b"] = "grok1_314b"


def get(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ALIASES[arch]}")
    return mod.CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return get(arch).reduced()
