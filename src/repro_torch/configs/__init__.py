"""Architecture registry: one module per supported architecture.

`get(arch_id)` -> ModelConfig (full published config)
`get_reduced(arch_id)` -> CPU-smoke-scale config of the same family
`SHAPES` -> the four input-shape cells the dry-run and the benchmarks price
`supports_shape(cfg, shape)` -> None, or why a config skips a shape
`input_specs(cfg, shape)` -> every input of the dry-run's step as
    `TensorSpec`s (shape and dtype, no storage; `launch.dryrun` turns them
    into fake tensors)
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch

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


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, without storage (the reference's
    `jax.ShapeDtypeStruct`; a leaf of the port's trees)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeSpec, batch_override: Optional[int] = None):
    """`TensorSpec`s of every input of the step the dry-run runs for a
    cell, as the reference gives them: a train batch (tokens and labels
    int32, M-RoPE positions (3, B, S), pixel embeddings (B, 256, d) and
    encoder embeddings (B, max(1, S // 4), d) in bf16), a prefill batch
    (no labels and no pixels), or for decode the cache of
    `init_cache_abstract`, one token per sequence, `pos` and the encoder's
    output."""
    from repro_torch.models import model as M   # runtime: the models import this registry

    b = batch_override or shape.global_batch
    s = shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": TensorSpec((b, s), i32)}
        if shape.kind == "train":
            batch["labels"] = TensorSpec((b, s), i32)
        if cfg.mrope:
            batch["positions"] = TensorSpec((3, b, s), i32)
        if shape.kind == "train" and cfg.frontend == "vision":
            batch["pixel_embeds"] = TensorSpec((b, 256, cfg.d_model), bf16)
        if cfg.encoder_layers:
            batch["enc_embeds"] = TensorSpec((b, max(1, s // 4), cfg.d_model), bf16)
        return {"batch": batch}

    # decode / long_decode: one new token against a cache of length s
    cache, _ = M.init_cache_abstract(cfg, b, s)
    spec = {"cache": [{name: {k: TensorSpec(tuple(t.shape), t.dtype) for k, t in blk.items()}
                       for name, blk in stage.items()} for stage in cache],
            "tokens": TensorSpec((b, 1), i32),
            "pos": TensorSpec((), i32)}
    if cfg.encoder_layers:
        spec["enc_out"] = TensorSpec((b, max(1, s // 4), cfg.d_model), bf16)
    return spec
