"""Pareto/co-design search engine on top of the batched sweep engine.

The paper's value proposition is a design-space argument: find the
interposer-network (and chiplet-mix) configurations on the latency / energy /
power frontier.  `core.sweep` evaluates grids; this module extracts
frontiers:

  pareto_mask(points)        Pareto-front membership of a 2- or 3-objective
                             point cloud on a device: blockwise all-pairs
                             dominance over the float64 points (exact:
                             float64 comparisons need no rank transform).
                             A cloud above one block is folded block by
                             block against the running front, so the cost
                             is O(n * front), not O(n^2).
  pareto_mask_reference      the O(n^2) blockwise numpy brute force the
                             tests/benchmarks cross-check against.
  ParetoFront / merge_fronts streaming-compatible front objects: Pareto
                             extraction distributes over unions,
                             front(A ∪ B) = front(front(A) ∪ front(B)),
                             so per-chunk fronts merge into the exact
                             whole-grid front.
  ParetoReducer              a `core.sweep.ChunkReducer` — plugs the merge
                             reduction into `sweep_chunked`, holding only the
                             running front (bounded memory for 1e7-point
                             grids).
  pareto_search(...)         one-call streaming per-workload front over a
                             network grid.
  codesign_pareto(...)       the joint network × chiplet-mix search: each
                             grid chunk is evaluated through the accelerator
                             grid kernel (`core.accelerator.
                             evaluate_accelerator_grid`), flat indices encode
                             (mix, network-config).
  codesign_config_at /       decode front indices into config dicts (the
  frontier_configs           format `core.fabric.Fabric.from_config` takes).

Dominance convention (weak Pareto): point q dominates p iff q <= p in every
objective and q != p in at least one; exact duplicates do not dominate each
other, so all copies of a non-dominated point stay on the front.  Lower is
better in every objective.

This is the port's counterpart of the first part of the JAX package's
`core/search.py` (fronts and searches; its gradient refinement engines are
not ported yet).  The reference extracts a front with a sort and a Fenwick
prefix-min `lax.scan`, a sequential sweep of O(n log n) steps; eager torch
would launch every step of it, so the port computes the same mask from the
definition, as batched comparisons on the device.  Every entry point takes
``device=`` (default "cuda"); fronts, indices and masks come back as host
numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.env import prefetch_depth
from repro_torch.core.sweep import (
    DEFAULT_TOPOLOGIES,
    ChunkReducer,
    GridSpec,
    SweepChunk,
    SweepResult,
    _decode,
    _nets_program,
    _run_pipeline,
    _validate_grid_values,
    grid_spec,
    sweep_chunked,
)
from repro_torch.core.workloads import Workload
from repro_torch.core.xp import TorchNS

__all__ = [
    "OBJECTIVES", "ACCEL_OBJECTIVES", "pareto_mask", "pareto_mask_reference",
    "ParetoFront", "merge_fronts", "pareto_front", "ParetoReducer",
    "pareto_search", "codesign_pareto", "codesign_config_at",
    "frontier_configs",
]

# the paper's three reported quantities, all minimized
OBJECTIVES: Tuple[str, ...] = ("latency_s", "energy_j", "power_w")


# --------------------------------------------------------------------------
# Front extraction on a device (blockwise all-pairs dominance)
# --------------------------------------------------------------------------

_MAX_POINTS = 1 << 24  # the reference's per-call limit, kept as its contract
_FRONT_BLOCK = 4096
_PAIRS = 1 << 24       # (p, q) pairs per comparison pass on the device


def _dominated_t(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(len(p),) bool: which rows of `p` some row of `q` dominates, both
    (k, m) float64 tensors on one device, compared in passes of at most
    `_PAIRS` pairs."""
    out = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    if q.shape[0] == 0:
        return out
    rows = max(1, _PAIRS // q.shape[0])
    for s in range(0, p.shape[0], rows):
        pb = p[s:s + rows, None, :]                    # (b, 1, m)
        le = (q[None, :, 0] <= pb[..., 0])
        eq = (q[None, :, 0] == pb[..., 0])
        for j in range(1, p.shape[1]):
            le &= q[None, :, j] <= pb[..., j]
            eq &= q[None, :, j] == pb[..., j]
        out[s:s + rows] = (le & ~eq).any(1)
    return out


def pareto_mask(points, device="cuda") -> np.ndarray:
    """Front membership (lower-is-better weak dominance) of an (n, m) point
    cloud, m in {2, 3}, computed on `device` from the definition: p is off
    the front iff some q has q <= p everywhere and q != p somewhere.

    Float64 comparisons are exact, so the mask equals the reference's
    (rank-transformed sort + scan) and `pareto_mask_reference`, duplicates
    included.  Clouds above `_FRONT_BLOCK` points are folded block by block:
    each block is prefiltered against the running front and only the
    survivors take the all-pairs pass with the front (a dominated point
    is always dominated by some front member, so the prefilter is
    lossless).
    """
    pts = np.asarray(points, np.float64)
    if pts.ndim != 2 or pts.shape[1] not in (2, 3):
        raise ValueError(f"expected (n, 2|3) points, got shape {pts.shape}")
    n = pts.shape[0]
    if n == 0:
        return np.zeros(0, bool)
    if n >= _MAX_POINTS:
        raise ValueError(
            f"pareto_mask handles < {_MAX_POINTS} points per call; stream "
            "larger grids through ParetoReducer / pareto_search")
    dev = require_device(device)
    p = torch.as_tensor(pts, device=dev)
    front = torch.zeros(0, dtype=torch.int64, device=dev)   # rows of `pts`
    for s in range(0, n, _FRONT_BLOCK):
        blk = torch.arange(s, min(s + _FRONT_BLOCK, n), device=dev)
        if front.numel():
            blk = blk[~_dominated_t(p[blk], p[front])]
        cand = torch.cat([front, blk])
        front = cand[~_dominated_t(p[cand], p[cand])]
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[front] = True
    return mask.cpu().numpy()


def pareto_mask_reference(points, block: int = 2048) -> np.ndarray:
    """O(n^2) blockwise pairwise-dominance brute force (numpy float64): the
    golden reference `pareto_mask` is tested and benchmarked against."""
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    dominated = np.zeros(n, bool)
    for s in range(0, n, block):
        p = pts[s:s + block]
        dom = np.zeros(p.shape[0], bool)
        for s2 in range(0, n, block):
            q = pts[s2:s2 + block]
            le = (q[:, None, :] <= p[None, :, :]).all(-1)
            ne = (q[:, None, :] != p[None, :, :]).any(-1)
            dom |= (le & ne).any(0)
        dominated[s:s + block] = dom
    return ~dominated


# --------------------------------------------------------------------------
# Front objects + the merge-fronts reduction
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParetoFront:
    """A set of mutually non-dominated points with their flat design indices
    (grid rows; for co-design searches, mix_id * grid_n + grid row)."""

    objectives: Tuple[str, ...]
    points: np.ndarray   # (k, m) float64 objective values
    indices: np.ndarray  # (k,) int64

    @property
    def size(self) -> int:
        return int(self.indices.size)

    def canonical(self) -> "ParetoFront":
        """Deterministic ordering (lex by objectives, then index) so fronts
        from different evaluation orders compare with array_equal."""
        keys = (self.indices,) + tuple(
            self.points[:, j] for j in range(self.points.shape[1] - 1, -1, -1))
        order = np.lexsort(keys)
        return ParetoFront(self.objectives, self.points[order],
                           self.indices[order])

    def configs(self, spec: GridSpec) -> List[Dict[str, float]]:
        return [spec.config_at(int(i)) for i in self.indices]


def _dominated_by(pts: np.ndarray, front_pts: np.ndarray,
                  device="cuda") -> np.ndarray:
    """Which of `pts` are weakly dominated by some member of `front_pts`,
    compared on `device` — the cheap prefilter before exact merge."""
    n = pts.shape[0]
    if front_pts.size == 0 or n == 0:
        return np.zeros(n, bool)
    dev = require_device(device)
    return _dominated_t(torch.as_tensor(np.asarray(pts, np.float64), device=dev),
                        torch.as_tensor(np.asarray(front_pts, np.float64),
                                        device=dev)).cpu().numpy()


def _front_of(points: np.ndarray, indices: np.ndarray,
              objectives: Tuple[str, ...], device="cuda") -> ParetoFront:
    """Exact front of an arbitrary point cloud, in canonical order
    (`pareto_mask` folds a large cloud block by block against its running
    front on the device, so the cost is O(n * front_size))."""
    mask = pareto_mask(points, device=device)
    return ParetoFront(objectives, points[mask],
                       np.asarray(indices)[mask].astype(np.int64)).canonical()


def merge_fronts(*fronts: ParetoFront, device="cuda") -> ParetoFront:
    """front(A ∪ B ∪ ...) from per-part fronts: Pareto extraction distributes
    over unions, which is what makes chunked streaming search exact."""
    if not fronts:
        raise ValueError("no fronts to merge")
    objectives = fronts[0].objectives
    if any(f.objectives != objectives for f in fronts):
        raise ValueError("fronts disagree on objectives")
    pts = np.concatenate([f.points for f in fronts], axis=0)
    idx = np.concatenate([f.indices for f in fronts], axis=0)
    return _front_of(pts, idx, objectives, device=device)


def _merge_into(front: Optional[ParetoFront], pts: np.ndarray,
                idx: np.ndarray,
                objectives: Tuple[str, ...], device="cuda") -> ParetoFront:
    """Merge a raw point block into a running front: prefilter points the
    front already dominates, then extract over front + survivors."""
    idx = np.asarray(idx).astype(np.int64)
    if front is not None and front.size:
        keep = ~_dominated_by(pts, front.points, device)
        pts = np.concatenate([front.points, pts[keep]], axis=0)
        idx = np.concatenate([front.indices, idx[keep]], axis=0)
    return _front_of(pts, idx, objectives, device=device)


def pareto_front(result: SweepResult,
                 objectives: Sequence[str] = OBJECTIVES, device="cuda"):
    """Monolithic front(s) of an in-memory SweepResult: one ParetoFront, or
    a list of them when the sweep batched multiple workload traffics."""
    objectives = tuple(objectives)
    pts = np.stack([np.asarray(result.metrics[k], np.float64)
                    for k in objectives], axis=-1)
    idx = np.arange(pts.shape[-2])
    if pts.ndim == 2:
        return _front_of(pts, idx, objectives, device=device)
    return [_front_of(pts[w], idx, objectives, device=device)
            for w in range(pts.shape[0])]


class ParetoReducer(ChunkReducer):
    """`sweep_chunked` reducer holding only the running per-workload
    front(s): the bounded-memory streaming Pareto search.  The dominance
    passes of each fold run on `device`."""

    def __init__(self, objectives: Sequence[str] = OBJECTIVES, device="cuda"):
        self.objectives = tuple(objectives)
        self.device = device

    def step(self, carry, chunk: SweepChunk):
        pts_all = np.stack([np.asarray(chunk.metrics[k], np.float64)
                            for k in self.objectives], axis=-1)
        scalar = pts_all.ndim == 2
        blocks = [pts_all] if scalar else list(pts_all)
        if carry is None:
            carry = {"scalar": scalar, "fronts": [None] * len(blocks)}
        idx = chunk.indices
        carry["fronts"] = [
            _merge_into(front, pts, idx, self.objectives, self.device)
            for front, pts in zip(carry["fronts"], blocks)]
        return carry

    def finish(self, carry, spec: GridSpec):
        if carry is None:
            raise ValueError("empty sweep")
        return carry["fronts"][0] if carry["scalar"] else carry["fronts"]


def pareto_search(
    traffic,
    topologies: Sequence[str] = DEFAULT_TOPOLOGIES,
    devices=None,
    active_fraction: float = 1.0,
    chunk_size: int = 65536,
    objectives: Sequence[str] = OBJECTIVES,
    shard: bool = False,
    columns_fn=None,
    materialize: str = "auto",
    prefetch: Optional[int] = None,
    device="cuda",
    **axes: Sequence[float],
):
    """Streaming per-workload Pareto front over a network configuration grid:
    `sweep_chunked` + `ParetoReducer` in one call, both on `device`.
    Returns a ParetoFront (or a list per workload traffic); recover
    configurations with `front.configs(grid_spec(topologies, **axes))`.

    `columns_fn` passes through to `sweep_chunked` — with
    `core.faults.faulted_columns_fn(scenario)` the result is the *survivable*
    frontier: the Pareto front of the grid as it performs under the fault
    scenario rather than healthy.  `materialize` / `prefetch` likewise pass
    through (device-resident decode + prefetch pipeline by default); front
    merges happen in chunk order, so every mode/depth yields the identical
    front."""
    return sweep_chunked(
        traffic, ParetoReducer(objectives, device), topologies=topologies,
        devices=devices, active_fraction=active_fraction,
        chunk_size=chunk_size, shard=shard, columns_fn=columns_fn,
        materialize=materialize, prefetch=prefetch, device=device, **axes)


# --------------------------------------------------------------------------
# Co-design search: network grid x chiplet-mix axis
# --------------------------------------------------------------------------


ACCEL_OBJECTIVES: Tuple[str, ...] = ("latency_s", "energy_j", "power_w")


def codesign_pareto(
    wl: Workload,
    mixes: Sequence[Sequence],
    topologies: Sequence[str] = DEFAULT_TOPOLOGIES,
    devices=None,
    chunk_size: int = 8192,
    objectives: Sequence[str] = ACCEL_OBJECTIVES,
    mac_rate_hz: float = 5e9,
    lambda_slot_energy_j: float = 30e-15,
    adaptive_gateways: bool = True,
    transfers_per_layer: int = 16,
    materialize: str = "auto",
    prefetch: Optional[int] = None,
    device="cuda",
    **axes: Sequence[float],
) -> Tuple[ParetoFront, GridSpec]:
    """Joint (network-grid x chiplet-mix) Pareto search for one workload.

    Streams the network grid in chunks; each chunk is evaluated against all
    `mixes` at once through the accelerator grid kernel on `device`
    (`core.accelerator.evaluate_accelerator_grid`), and the running front is
    merged per chunk.  Flat front indices encode the joint design point as
    ``mix_id * spec.n + grid_row`` — decode with `codesign_config_at`.
    Memory is O(len(mixes) * chunk_size * n_layers), independent of grid
    size.

    Chunk columns and network fields stay on the device end to end by
    default (``materialize="device"``: the mixed-radix decode, the
    network-column builder and the accelerator kernel, no per-chunk host
    numpy); ``materialize="host"`` is the serial reference layout
    (`GridSpec.chunk_cols` on the host, shipped to the device).  Both modes
    feed the same evaluation, so their fronts are bit-identical.  Each
    chunk's objectives come back to the host inside its task; `prefetch`
    chunks (default: REPRO_PREFETCH, 2) run ahead of the front merge, and
    merges happen in chunk order, so every depth yields the identical
    front.
    """
    from repro_torch.core.accelerator import (
        chiplet_mix_columns,
        evaluate_accelerator_grid,
    )

    objectives = tuple(objectives)
    if not mixes:
        raise ValueError("empty mixes: need at least one chiplet mix")
    xp = TorchNS(require_device(device))
    spec = grid_spec(topologies, devices=devices, **axes)
    n = spec.n
    if n == 0:
        raise ValueError(
            "empty grid: every swept axis (and `topologies`) needs at "
            "least one value")
    _validate_grid_values(spec)
    chiplet_mix_columns(mixes)  # eager validation (tasks run on a worker)
    if materialize not in ("auto", "host", "device"):
        raise ValueError(f"materialize must be 'auto', 'host', or 'device', "
                         f"got {materialize!r}")
    if materialize == "auto":
        materialize = "device"
    depth = prefetch_depth() if prefetch is None else max(0, int(prefetch))

    n_mix = len(mixes)
    mix_off = np.arange(n_mix, dtype=np.int64)[:, None] * n
    step = int(min(max(1, chunk_size), n))
    if materialize == "device":
        tables_t = {k: xp.asarray(np.asarray(v, np.float64))
                    for k, v in spec.axes.items()}
        base_t = {k: xp.asarray(v) for k, v in spec.base.items()}

    def make_task(start):
        stop = min(start + step, n)

        def task():
            if materialize == "device":
                cols, topo_id = _decode(spec, step, tables_t, base_t, start,
                                        xp.device)
            else:
                cols, topo_id = spec.chunk_cols(start, stop)
                pad = step - (stop - start)
                if pad:  # repeat the last row: every chunk has one shape;
                    # padded lanes are sliced off below
                    cols = {k: np.concatenate([v, np.repeat(v[-1:], pad)])
                            for k, v in cols.items()}
                    topo_id = np.concatenate(
                        [topo_id, np.repeat(topo_id[-1:], pad)])
                cols = {k: xp.asarray(v) for k, v in cols.items()}
                topo_id = torch.as_tensor(topo_id, device=xp.device)
            nets, mem_bw = _nets_program(cols, topo_id, spec.topologies, xp)
            out = evaluate_accelerator_grid(
                wl, mixes, nets, cols, mem_bw,
                mac_rate_hz=mac_rate_hz,
                lambda_slot_energy_j=lambda_slot_energy_j,
                adaptive_gateways=adaptive_gateways,
                transfers_per_layer=transfers_per_layer,
                as_numpy=False, device=xp.device)
            valid = stop - start
            pts = torch.stack([out[k][:, :valid] for k in objectives], -1)
            return start, stop, pts.reshape(n_mix * valid, len(objectives)).cpu().numpy()
        return task

    front: Optional[ParetoFront] = None

    def fold(result):
        nonlocal front
        start, stop, pts = result
        idx = (mix_off + np.arange(start, stop)[None, :]).reshape(-1)
        front = _merge_into(front, pts, idx, objectives, xp.device)

    _run_pipeline(range(0, n, step), make_task, fold, depth)
    assert front is not None  # n > 0 and n_mix > 0 guarantee >= 1 chunk
    return front, spec


def codesign_config_at(spec: GridSpec, mixes: Sequence, flat_index: int
                       ) -> Dict[str, object]:
    """Decode a `codesign_pareto` flat index into mix + network settings."""
    flat_index = int(flat_index)
    mix_id, row = divmod(flat_index, spec.n)
    out: Dict[str, object] = {"mix": mix_id, "chiplets": list(mixes[mix_id])}
    out.update(spec.config_at(row))
    return out


def frontier_configs(front: ParetoFront, spec: GridSpec,
                     mixes: Optional[Sequence] = None
                     ) -> List[Dict[str, object]]:
    """Decode every frontier row of `front` into a config dict, in the
    front's canonical order.  Pass `mixes` for co-design fronts (flat index
    = mix_id * spec.n + grid_row -> dict with "mix"/"chiplets" keys); omit
    it for plain network fronts (flat index = grid row).  The dicts are
    directly consumable by `core.fabric.Fabric.from_config`."""
    if mixes is not None:
        return [codesign_config_at(spec, mixes, int(i))
                for i in front.indices]
    return front.configs(spec)
