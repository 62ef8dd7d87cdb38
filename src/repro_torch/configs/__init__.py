"""Architecture registry: one module per supported architecture.

`get(arch_id)` -> ModelConfig (full published config)
`get_reduced(arch_id)` -> CPU-smoke-scale config of the same family
`SHAPES` -> the four input-shape cells the dry-run and the benchmarks price
`supports_shape(cfg, shape)` -> None, or why a config skips a shape

`input_specs` (the lowered step's abstract inputs) is not ported: it feeds
the XLA dry-run, which has no counterpart here yet.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

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


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "long_decode"),
}


def get(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ALIASES[arch]}")
    return mod.CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return get(arch).reduced()


def supports_shape(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if supported, else the skip reason."""
    if shape.kind == "long_decode":
        sub_quadratic = (
            cfg.family in ("ssm", "hybrid")
            or cfg.attn_pattern in ("sliding", "local_global")
        )
        if not sub_quadratic:
            return ("pure full-attention arch: long_500k requires "
                    "sub-quadratic attention (DESIGN.md §Arch-applicability)")
    return None
