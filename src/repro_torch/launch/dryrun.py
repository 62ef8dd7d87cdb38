"""Per-device model FLOPs of one step of an (architecture x input shape)
cell: the useful-work numerator of the roofline.

The JAX package's `launch/dryrun.py` also lowers and compiles every cell's
real step on the production meshes and reads FLOPs, bytes and the
collective schedule from the compiled XLA HLO (`hlo_analysis.analyze_hlo`).
The torch side compiles no XLA HLO; how the port counts a step's FLOPs and
bytes (`torch.utils.flop_counter` or analytic counts) waits for a design
note (ROADMAP.md, Queue 1 item 6), and the lowering with it.  Until then
this module holds `model_flops_per_device` alone.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

__all__ = ["model_flops_per_device"]


def model_flops_per_device(cfg: ModelConfig, shape, n_devices: int) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) for training;
    2*N*D for inference steps (forward only).  Per device."""
    n = cfg.active_param_count() if cfg.n_experts else cfg.param_count()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        total = 6.0 * n * d
    elif shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        total = 2.0 * n * d
    else:  # decode: one token per sequence
        d = shape.global_batch * 1
        total = 2.0 * n * d
    return total / n_devices
