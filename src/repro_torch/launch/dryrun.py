"""Per-device model FLOPs of one step of an (architecture x input shape)
cell: the useful-work numerator of the roofline.

The JAX package's `launch/dryrun.py` also lowers and compiles every cell's
real step on the production meshes and reads FLOPs, bytes and the
collective schedule from the compiled XLA HLO (`hlo_analysis.analyze_hlo`).
The port has what that lowering places the step with: the production
meshes (`launch.mesh`), the sharding rules and layouts (`parallel.sharding`:
`rules_for`, `tree_shardings`, `cache_shardings`, on a mesh's geometry
alone) and the abstract trees (`models.model.init_abstract`,
`init_cache_abstract`).  The torch side compiles no XLA HLO; how the port
counts a step's FLOPs and bytes (`torch.utils.flop_counter` or analytic
counts, on a process group of PyTorch's "fake" backend standing for the
512 devices) waits for a design note (ROADMAP.md, Queue 1 item 6), and
the lowering with it.  Until then this module holds
`model_flops_per_device` alone.
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
