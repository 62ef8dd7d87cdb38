"""The analytic roofline: compute, memory and collective terms of one step,
priced against a `core.fabric.Fabric`.

`roofline(stats, cost, model_flops, io_bytes, fabric)` turns per-device
counts of one step (`HloStats`: dot FLOPs and bytes, collective wire bytes
and counts) into seconds: compute = FLOPs over the fabric's peak, memory =
(dot bytes + program I/O) over its HBM rate, collective = wire bytes over
its cross-pod link plus its fixed per-collective latency; the largest term
names the bottleneck.  `PEAK_FLOPS`, `HBM_BW` and `ICI_BW` are the default
(`metallic_ici`) fabric's constants.  This is arithmetic over a `Fabric`,
so the port carries it as the JAX package's `launch/hlo_analysis.py`
has it, field for field.

That module also parses compiled XLA HLO text into `HloStats`
(`analyze_hlo`: while-loop trip counts, call-site multipliers, dot FLOPs,
ring-weighted collective bytes, wire-dtype correction).  The torch side
compiles no XLA HLO, so those parsers are not ported: a caller builds
`HloStats` from its own counts, as `examples/torch_photonic_design_space.py`
does for one decode cell.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.fabric import DEFAULT_FABRIC, get_fabric

__all__ = ["PEAK_FLOPS", "HBM_BW", "ICI_BW", "HloStats", "RooflineTerms",
           "roofline"]

# the metallic default fabric's constants
PEAK_FLOPS = DEFAULT_FABRIC.peak_flops
HBM_BW = DEFAULT_FABRIC.hbm_bw_bytes_per_s
ICI_BW = DEFAULT_FABRIC.cross_pod_bw_bytes_per_s


@dataclasses.dataclass
class HloStats:
    dot_flops: float
    dot_bytes: float             # Σ dot operand+result bytes × multiplier
    op_result_bytes: float       # Σ ALL result bytes × multiplier (upper bound)
    collective_bytes: float      # ring-weighted per-device wire bytes
    collective_op_bytes: Dict[str, float]
    collective_op_counts: Dict[str, int]
    max_trip: int
    collective_dtype_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)    # wire bytes per payload dtype (diagnostics)
    collective_bytes_raw: float = 0.0   # uncorrected wire bytes

    def to_json(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RooflineTerms:
    flops: float                  # trip-corrected dot FLOPs (per device)
    hbm_bytes: float              # trip-corrected result-bytes traffic proxy
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_flops_frac: float
    raw_cost_flops: float         # uncorrected cost analysis (cross-check)
    raw_cost_bytes: float
    fabric: str = "metallic_ici"  # name of the fabric that priced the terms

    def to_json(self):
        return dataclasses.asdict(self)


def roofline(stats: HloStats, cost: dict,
             model_flops_per_device: float, io_bytes: float = 0.0,
             fabric=None) -> RooflineTerms:
    """Memory term = dot operand/result traffic + program I/O (params/state
    read+written once).  Elementwise chains are assumed fused into the dots;
    `op_result_bytes` is kept as the no-fusion upper bound.

    `fabric` prices the terms against one network design point (a
    `repro_torch.core.fabric.Fabric`, a preset name like "trine_siph", or
    None for the metallic default).  The collective term charges the
    cross-pod link plus the fabric's fixed per-collective latency (MZI
    switching / arbitration); the default fabric has zero per-collective
    latency.  `cost` is a cost-analysis dict ("flops", "bytes accessed"),
    reported as the uncorrected cross-check (-1 where absent)."""
    fb = get_fabric(fabric)
    flops = stats.dot_flops
    hbm = stats.dot_bytes + io_bytes
    compute_s = fb.compute_s(flops)
    memory_s = fb.memory_s(hbm)
    collective_s = fb.collective_s(
        stats.collective_bytes,
        float(sum(stats.collective_op_counts.values())))
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    return RooflineTerms(
        flops=flops, hbm_bytes=hbm, collective_bytes=stats.collective_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops=model_flops_per_device,
        useful_flops_frac=(model_flops_per_device / flops) if flops else 0.0,
        raw_cost_flops=float(cost.get("flops", -1.0)),
        raw_cost_bytes=float(cost.get("bytes accessed", -1.0)),
        fabric=fb.name,
    )
