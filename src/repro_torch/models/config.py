"""Model configuration for all assigned architectures.

One `ModelConfig` describes any member of the supported families:
dense / moe / ssm (xLSTM) / hybrid (Mamba2+shared-attn) / vlm / audio (enc-dec).
`repro_torch/configs/<arch>.py` instantiates these with the published numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # attention pattern
    attn_pattern: str = "full"     # full | sliding | local_global
    window: int = 0                # sliding/local window length
    local_global_ratio: int = 0    # gemma3: 5 local : 1 global

    # mixture of experts
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # "einsum": GShard one-hot dispatch/combine (reference; O(S·cap) ⇒
    #           quadratic in seq).  "index": gather/scatter dispatch with the
    #           SAME capacity-drop rule — no dispatch matmuls (§Perf MoE).
    moe_dispatch: str = "einsum"

    # state-space / recurrent
    ssm_state: int = 0             # N (mamba2 state dim)
    ssm_headdim: int = 64          # P
    ssm_expand: int = 2
    conv_width: int = 4
    hybrid_attn_every: int = 0     # zamba2: shared attn block every k layers
    slstm_ratio: int = 0           # xlstm: 1 sLSTM per k blocks (k=2 -> alternate)

    # encoder-decoder (seamless)
    encoder_layers: int = 0

    # embeddings / frontends
    frontend: str = "none"         # none | vision | audio (stub embeddings)
    mrope: bool = False            # qwen2-vl M-RoPE (3 position streams)
    rope_theta: float = 1e6
    tie_embeddings: bool = False

    # numerics / execution
    dtype: str = "bfloat16"
    use_photonic_mac: bool = False  # route linears through the photonic-MAC QAT op
    photonic_bits: int = 8
    # int8 weight "wire format" (§Perf): ZeRO-3 param all-gathers cross the
    # mesh at the MR weight-bank amplitude resolution (8-bit), dequantized
    # after the wire.  Runs through `make_train_step(param_wire=)` on one
    # device; under a mesh it raises (the sharded wire is not ported); 0 = off.
    wire_bits: int = 0
    use_kernels: bool = False       # hand-written CUDA kernels (False -> plain PyTorch versions)
    remat: str = "full"             # none | full | dots
    loss_chunk: int = 1024          # CE computed in seq chunks (no full-logit materialization)

    # parallelism hints (logical->mesh rules read these)
    fsdp_axes: Tuple[str, ...] = ("data",)   # ("pod","data") for the largest archs
    scan_layers: bool = True
    # "tp_fsdp"  : Megatron TP over `model` + FSDP over fsdp_axes (baseline)
    # "fsdp_all" : ZeRO-3 over the WHOLE mesh, no tensor parallelism
    # "seq_tp"   : FSDP + sequence-sharded attention (context parallel) with
    #              TP MLP — for archs whose head count won't divide `model`
    parallel_strategy: str = "tp_fsdp"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def reduced(self) -> "ModelConfig":
        """Smoke-test scale version of the same family (CPU-runnable)."""
        small_layers = {
            "local_global": max(2, self.local_global_ratio + 1),
        }.get(self.attn_pattern, 0)
        if self.hybrid_attn_every:
            small_layers = self.hybrid_attn_every + 1
        if self.slstm_ratio:
            small_layers = 2 * self.slstm_ratio
        n_layers = max(2, small_layers)
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 * self.n_kv_heads // max(self.n_heads, 1)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            window=min(self.window, 32) if self.window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else self.ssm_headdim,
            encoder_layers=2 if self.encoder_layers else 0,
            loss_chunk=64,
            dtype="float32",
        )

    def param_count(self) -> float:
        """Approximate parameter count (embeddings + blocks)."""
        m, f, v = self.d_model, self.d_ff, self.vocab
        h, hk, dh = self.n_heads, self.n_kv_heads, self.head_dim_
        attn = m * dh * (h + 2 * hk) + h * dh * m
        mlp = 3 * m * f
        if self.n_experts:
            mlp = self.n_experts * 3 * m * f + m * self.n_experts
        per_layer = attn + mlp
        if self.family == "ssm":
            din = self.d_inner
            mlstm = m * (2 * din + 2 * self.ssm_state * self.ssm_heads) + din * m
            per_layer = mlstm  # coarse
        if self.family == "hybrid":
            din = self.d_inner
            per_layer = m * (2 * din + 2 * self.ssm_state + self.ssm_heads) + din * m
        total = self.n_layers * per_layer + v * m * (1 if self.tie_embeddings else 2)
        if self.encoder_layers:
            total += self.encoder_layers * (attn + 2 * m * f)
        return float(total)

    def active_param_count(self) -> float:
        if not self.n_experts:
            return self.param_count()
        dense_share = self.param_count() - self.n_layers * self.n_experts * 3 * self.d_model * self.d_ff
        return dense_share + self.n_layers * self.top_k * 3 * self.d_model * self.d_ff
