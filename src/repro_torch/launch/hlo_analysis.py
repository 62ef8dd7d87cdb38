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
compiles no XLA HLO: its counterpart is `count_step(fn, n_devices)`, one
`TorchDispatchMode` (`StepCounter`) over a step as one rank runs it (the
dry-run runs it under `FakeTensorMode` on a fake process group,
`launch.dryrun`), filling every `HloStats` field from the ops the rank
dispatches:

  * `dot_flops`: `torch.utils.flop_counter`'s formulas for the
    matmul-class ops (the hand-written kernels' custom operators carry
    their own, `kernels.ops`); `dot_bytes` their operand and result bytes;
  * `op_result_bytes`: every op's result bytes;
  * the collectives: every `c10d` op the rank issues, with its group's
    size and its payload's bytes and dtype, weighted as rings as the
    reference weights them (all-reduce 2(n-1)/n of the operand;
    all-gather and all-to-all (n-1)/n of the larger of operand and
    result; reduce-scatter (n-1)/n of the operand; anything else its
    operand).  The counts come from the payload dtype itself, so
    `collective_bytes_raw` equals `collective_bytes`: no wire-dtype
    correction exists;
  * `max_trip`: given by the caller (the most times one layer body runs);
    every op is dispatched as often as it runs, so no multiplier applies.
`StepCounter` also keeps the peak of the live bytes the step allocates
(each new storage counted once, until it is freed): the dry-run's
`temp_size_in_bytes`.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.core.fabric import DEFAULT_FABRIC, get_fabric

__all__ = ["PEAK_FLOPS", "HBM_BW", "ICI_BW", "HloStats", "RooflineTerms",
           "roofline", "StepCounter", "count_step", "COLLECTIVES"]

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


# ---------------------------------------------------------------------------
# counting a step as one rank dispatches it
# ---------------------------------------------------------------------------

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d operator -> the reference's collective kind
_C10D_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather", "allgather_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute", "send": "collective-permute",
    "recv_": "collective-permute",
}
# the result and operand positions of each operator's arguments
_C10D_OUT_FIRST = ("allgather_", "_allgather_base_", "allgather_into_tensor_coalesced_",
                   "allgather_coalesced_", "reduce_scatter_", "_reduce_scatter_base_",
                   "reduce_scatter_tensor_coalesced_", "alltoall_", "alltoall_base_")
# the reference's names of the payload dtypes (XLA's)
_DTYPE_NAME = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
               torch.float64: "f64", torch.int8: "s8", torch.int16: "s16", torch.int32: "s32",
               torch.int64: "s64", torch.uint8: "u8", torch.bool: "pred"}


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group_size(args) -> int:
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:      # a ReduceOp, not the group
                continue
    raise ValueError("a c10d operator without a process group")


@dataclasses.dataclass
class CollectiveEvent:
    kind: str
    group_size: int
    operand_bytes: int
    result_bytes: int
    dtype: str
    moved_bytes: float      # ring-weighted


class StepCounter(TorchDispatchMode):
    """Counts what one rank dispatches inside the context (`count_step`):
    `dot_flops`, `dot_bytes`, `op_result_bytes`, `events` (one
    `CollectiveEvent` per c10d op) and `peak_bytes`, the peak of the live
    bytes of storages made inside the context.  Storages made before it
    (`known`: the step's arguments) are never counted."""

    def __init__(self, known=()):
        super().__init__()
        self.dot_flops = 0.0
        self.dot_bytes = 0.0
        self.op_result_bytes = 0.0
        self.events: List[CollectiveEvent] = []
        self.live = 0
        self.peak_bytes = 0
        self._ids: Dict[int, int] = {}
        for t in _tensors(known):
            self._watch(t.untyped_storage(), 0)

    def _watch(self, st, nbytes: int) -> None:
        key = id(st)
        self._ids[key] = nbytes
        self.live += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._ids.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            st = t.untyped_storage()
            if id(st) not in self._ids:
                self._watch(st, st.nbytes())
        if func.namespace == "c10d":
            self._collective(func, args)
            return out
        res = _nbytes(outs)
        self.op_result_bytes += res
        packet = func._overloadpacket
        if packet in flop_registry:
            self.dot_flops += flop_registry[packet](*args, **kwargs, out_val=out)
            self.dot_bytes += _nbytes(list(args) + list(kwargs.values())) + res
        return out

    def _collective(self, func, args) -> None:
        name = func._overloadpacket.__name__
        kind = _C10D_KIND.get(name)
        if kind is None:
            return                      # barrier, monitored waits: no payload
        n = _group_size(args)
        if name in _C10D_OUT_FIRST:
            result, operand = _tensors(args[0]), _tensors(args[1])
        else:
            operand = _tensors(args[0])
            result = operand
        op_b, res_b = _nbytes(operand), _nbytes(result)
        if kind == "all-reduce":
            moved = 2 * (n - 1) / max(n, 1) * op_b
        elif kind in ("all-gather", "all-to-all"):
            moved = (n - 1) / max(n, 1) * max(res_b, op_b)
        elif kind == "reduce-scatter":
            moved = (n - 1) / max(n, 1) * op_b
        else:
            moved = float(op_b)
        dtype = _DTYPE_NAME.get(operand[0].dtype, str(operand[0].dtype)) if operand else "?"
        self.events.append(CollectiveEvent(kind, n, op_b, res_b, dtype, moved))

    def stats(self, max_trip: int = 1) -> HloStats:
        op_bytes = {k: 0.0 for k in COLLECTIVES}
        op_counts = {k: 0 for k in COLLECTIVES}
        dtype_bytes: Dict[str, float] = {}
        for e in self.events:
            op_bytes[e.kind] += e.moved_bytes
            op_counts[e.kind] += 1
            dtype_bytes[e.dtype] = dtype_bytes.get(e.dtype, 0.0) + e.moved_bytes
        total = float(sum(op_bytes.values()))
        return HloStats(dot_flops=float(self.dot_flops), dot_bytes=float(self.dot_bytes),
                        op_result_bytes=float(self.op_result_bytes), collective_bytes=total,
                        collective_op_bytes=op_bytes, collective_op_counts=op_counts,
                        max_trip=int(max_trip), collective_dtype_bytes=dtype_bytes,
                        collective_bytes_raw=total)


def count_step(fn, n_devices: int, max_trip: int = 1, known=()) -> HloStats:
    """`HloStats` of `fn()` as this rank runs it (`StepCounter`), for a
    mesh of `n_devices` (the group sizes come from the process groups
    themselves; `n_devices` bounds them).  `known`: tensors made before
    the step (its arguments), whose storages are not counted as made."""
    with StepCounter(known) as counter:
        fn()
    if any(e.group_size > n_devices for e in counter.events):
        raise ValueError(f"a collective over more than the mesh's {n_devices} devices")
    return counter.stats(max_trip)
