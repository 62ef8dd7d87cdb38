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
  refine_continuous(...)     gradient-based local refinement: autograd
                             through the namespace-generic topology kernels
                             + the shared metric math w.r.t. the
                             *continuous* columns (losses, rates,
                             bandwidths, geometry), descended with a
                             projected (log-space, boxed) gradient loop from
                             a Pareto point.
  refine_codesign(...)       the co-design analog: joint relaxed descent
                             over accelerator axes (per-chiplet n_units /
                             vector_size, mac_rate_hz, lambda_slot_energy_j)
                             AND network axes, seeded from a codesign_pareto
                             frontier row, then round-and-rescore — snap the
                             discrete axes to integer neighbors and exactly
                             re-score every candidate through the grid
                             kernel, so the reported point is always a
                             feasible integer design, never worse than its
                             seed.  Accepts one Workload or a weighted batch
                             (scalarized as the weighted geomean of the
                             per-workload objective) and two descent
                             methods: "first_order" (fixed-lr projected
                             gradient + one-shot floor/ceil snap) and
                             "trust_region" (second-order log-space
                             trust-region descent + coordinate-wise integer
                             line search to a local integer optimum).
  refine_trust_region(...)   `refine_codesign(method="trust_region")`.
  refine_front(...)          frontier-wide entry point: refine every (or
                             top-k) row, merge the refined points back with
                             merge_fronts (the result weakly dominates the
                             seed front by construction — asserted), report
                             per-axis gradient-magnitude sensitivities.

Dominance convention (weak Pareto): point q dominates p iff q <= p in every
objective and q != p in at least one; exact duplicates do not dominate each
other, so all copies of a non-dominated point stay on the front.  Lower is
better in every objective.

This is the port's counterpart of the JAX package's `core/search.py`.  The
reference extracts a front with a sort and a Fenwick prefix-min `lax.scan`,
a sequential sweep of O(n log n) steps; eager torch would launch every step
of it, so the port computes the same mask from the definition, as batched
comparisons on the device.  Every entry point takes ``device=`` (default
"cuda"); fronts, indices and masks come back as host numpy.

The refiners evaluate their losses, gradients and Hessians in float64 on
the device (`torch.autograd`, reverse over reverse for the Hessian) and
run the descent loops, the trust-region subproblem and the integer line
search on the host in float64.  The reference runs its first-order paths
at jax's default precision (float32 unless x64 is on) and only its
trust-region path in forced float64; the port is float64 throughout, so it
equals the reference run inside `engine_x64()`.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.env import prefetch_depth
from repro_torch.core.power import EVAL_DEVICE_FIELDS, eval_network_math
from repro_torch.core.topology import MODEL_FIELDS, TOPOLOGY_ARRAYS
from repro_torch.core.sweep import (
    DEFAULT_TOPOLOGIES,
    INTEGER_AXES,
    METRIC_FIELDS,
    ChunkReducer,
    GridSpec,
    SweepChunk,
    SweepResult,
    _decode,
    _network_columns_arrays,
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
    "frontier_configs", "refine_continuous", "refine_front_point",
    "DEFAULT_REFINE_AXES", "refine_codesign", "refine_trust_region",
    "refine_front", "ACCEL_REFINE_AXES",
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
    (`core.accelerator.evaluate_accelerator_grid`, run for every chunk as
    one `core.accelerator.CodesignChunk`: a CUDA graph on the card), and
    the running front is merged per chunk.  Flat front indices encode the
    joint design point as
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
    from repro_torch.core.accelerator import CodesignChunk, chiplet_mix_columns

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
    # one program for every chunk (a CUDA graph on the card)
    program = CodesignChunk(wl, mixes, spec.topologies, step, xp.device,
                            mac_rate_hz=mac_rate_hz,
                            lambda_slot_energy_j=lambda_slot_energy_j,
                            adaptive_gateways=adaptive_gateways,
                            transfers_per_layer=transfers_per_layer)

    def make_task(start):
        stop = min(start + step, n)

        def task():
            if materialize == "device":
                cols, topo_id = _decode(spec, step, tables_t, base_t, start,
                                        xp.device)
            else:
                # the program pads a short chunk with its last row
                cols, topo_id = spec.chunk_cols(start, stop)
            valid = stop - start
            out = program(cols, topo_id, valid)
            pts = torch.stack([out[k] for k in objectives], -1)
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


# --------------------------------------------------------------------------
# Gradient refinement of Pareto points (projected descent, log-space)
# --------------------------------------------------------------------------


DEFAULT_REFINE_AXES: Tuple[str, ...] = (
    "modulation_rate_bps", "mem_bw_bytes_per_s", "interposer_side_cm",
    "mzi.insertion_loss_db")


def _check_objective(objective: str, vocabulary: Sequence[str],
                     where: str) -> None:
    """Eager objective-name validation: fail with the valid vocabulary
    before any device work happens (a bare KeyError from deep inside the
    loss names no valid options)."""
    if objective != "edp" and objective not in vocabulary:
        raise ValueError(
            f"unknown {where} objective {objective!r}; valid objectives "
            f"are 'edp' or one of {list(vocabulary)}")


def _projected_descent(value_and_grad, theta0, lo, hi, steps: int,
                       lr: float):
    """Log-space projected gradient descent shared by the refiners:
    theta <- clip(theta - lr * grad, lo, hi), tracking the best iterate
    ever visited (the trajectory is not monotone across quantization
    boundaries).  `value_and_grad(theta) -> (float, float64 numpy)`; the
    loop carries theta as host float64 (so no autograd graph spans two
    iterations), clipping with maximum then minimum as `TorchNS.clip`
    does.  Returns (best_loss, best_theta, trace, grad0) where grad0 is
    the float64 gradient at theta0 — the per-axis sensitivity
    `refine_codesign` reports."""
    theta = theta0
    best_loss, best_theta = np.inf, theta
    trace: List[float] = []
    grad0: Optional[np.ndarray] = None
    for _ in range(steps):
        v, g = value_and_grad(theta)
        if grad0 is None:
            grad0 = np.asarray(g, np.float64)
        v = float(v)
        trace.append(v)
        if v < best_loss:
            best_loss, best_theta = v, theta
        theta = np.minimum(np.maximum(theta - lr * np.asarray(g, np.float64), lo), hi)
    v_end = float(value_and_grad(theta)[0])
    trace.append(v_end)
    if v_end < best_loss:
        best_loss, best_theta = v_end, theta
    if grad0 is None:  # steps == 0: report a zero sensitivity vector
        grad0 = np.zeros(np.shape(theta0), np.float64)
    return best_loss, best_theta, trace, grad0


def _tr_step(hess: np.ndarray, grad: np.ndarray, radius: float,
             damping: float = 1e-6) -> np.ndarray:
    """Approximately solve the trust-region subproblem
    min_s g.s + 0.5 s.H.s  s.t.  |s| <= radius  by Levenberg damping:
    symmetrize H, eigendecompose, lift the spectrum so the smallest
    eigenvalue is at least `damping` (negative curvature becomes a
    steepest-descent-like direction instead of a runaway), then escalate
    the ridge until the damped Newton step fits inside the radius.  Any
    non-finite curvature falls back to the radius-length steepest-descent
    step, so the caller always gets a usable direction."""
    g = np.asarray(grad, np.float64)

    def _cauchy():
        n = float(np.linalg.norm(g))
        return -g * (radius / n) if n > 0 else np.zeros_like(g)

    H = np.asarray(hess, np.float64)
    H = 0.5 * (H + H.T)
    if not np.all(np.isfinite(H)):
        return _cauchy()
    w, V = np.linalg.eigh(H)
    lam = max(0.0, damping - float(w.min()))
    gp = V.T @ g
    s = np.zeros_like(g)
    for _ in range(64):
        s = -(V @ (gp / (w + lam)))
        norm = float(np.linalg.norm(s))
        if not np.isfinite(norm):
            return _cauchy()
        if norm <= radius:
            break
        lam = 2.0 * lam + damping
    norm = float(np.linalg.norm(s))
    if not np.isfinite(norm) or norm == 0.0:
        return _cauchy()
    if norm > radius:
        s *= radius / norm
    return s


def _trust_region_descent(value_and_grad, hess_fn, theta0, lo, hi,
                          steps: int, radius: float = 0.5,
                          min_radius: float = 1e-5,
                          max_radius: float = 4.0,
                          accept_ratio: float = 1e-4,
                          damping: float = 1e-6):
    """Box-constrained trust-region descent — the second-order alternative
    to `_projected_descent`, shared by `refine_codesign(method=
    "trust_region")` and directly unit-testable with plain-python callables.

    Each iteration builds the local quadratic model from the exact gradient
    and Hessian of the objective (`hess_fn`), solves the subproblem via
    `_tr_step`, clips the candidate into the [lo, hi] box, and
    accepts/rejects on an exact re-evaluation at the clipped candidate:
    rho = actual_decrease / model_decrease.  Accepted steps with good model
    agreement while pinned at the radius grow the radius (x2, capped at
    `max_radius`); rejected or badly-modelled steps shrink it (x0.25); the
    loop stops early once the radius collapses below `min_radius` or the
    box pins the iterate.  The best iterate ever visited is returned, so
    the result is never worse than theta0.

    Everything runs host-side in float64; `value_and_grad`/`hess_fn` may
    evaluate on a device or be plain functions.  Returns (best_loss,
    best_theta, trace, grad0, stats): `trace` is the accepted-iterate loss
    history (trace[0] is the seed loss), `grad0` the float64 gradient at
    theta0, and `stats` counts accepts/rejects and records the
    per-iteration radius trajectory (an entry AFTER each update — a
    rejected step shows a strictly smaller radius than its predecessor)."""
    theta = np.clip(np.asarray(theta0, np.float64),
                    np.asarray(lo, np.float64), np.asarray(hi, np.float64))
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    v, g = value_and_grad(theta)
    f = float(v)
    g = np.asarray(g, np.float64)
    grad0 = g.copy()
    best_loss, best_theta = f, theta.copy()
    trace: List[float] = [f]
    stats: Dict[str, object] = {
        "accepted": 0, "rejected": 0, "radius_trace": [],
        "stopped_early": False}
    radius = float(radius)
    for _ in range(int(steps)):
        H = np.asarray(hess_fn(theta), np.float64)
        s = _tr_step(H, g, radius, damping)
        cand = np.clip(theta + s, lo, hi)
        s_eff = cand - theta
        if not np.any(s_eff):
            stats["stopped_early"] = True
            break  # pinned against the box: no admissible move left
        pred = -(float(g @ s_eff) + 0.5 * float(s_eff @ H @ s_eff))
        v_new, g_new = value_and_grad(cand)
        f_new = float(v_new)
        actual = f - f_new
        if pred > 0:
            rho = actual / pred
        else:  # model predicts no decrease: trust the exact re-score alone
            rho = np.inf if actual > 0 else -np.inf
        if np.isfinite(f_new) and actual > 0 and rho >= accept_ratio:
            theta, f = cand, f_new
            g = np.asarray(g_new, np.float64)
            trace.append(f)
            stats["accepted"] = int(stats["accepted"]) + 1
            if f < best_loss:
                best_loss, best_theta = f, theta.copy()
            if rho > 0.75 and float(np.linalg.norm(s_eff)) >= 0.8 * radius:
                radius = min(2.0 * radius, max_radius)
        else:
            stats["rejected"] = int(stats["rejected"]) + 1
            radius *= 0.25
        stats["radius_trace"].append(radius)
        if radius < min_radius:
            stats["stopped_early"] = True
            break
    stats["final_radius"] = radius
    return best_loss, best_theta, trace, grad0, stats


def _coordinate_int_search(x0: Mapping, lo: Mapping, hi: Mapping, score,
                           max_sweeps: int = 4, max_steps: int = 64):
    """Coordinate-wise integer line search: walk each discrete axis in ±1
    integer steps holding the others fixed, keeping every strictly
    improving move and continuing in the improving direction; sweep the
    axes round-robin until one full sweep makes no move (a local integer
    optimum) or `max_sweeps` is exhausted.  `score(values) -> float` must
    return +inf (or raise nothing) for infeasible candidates; scores are
    memoized so a design is never re-scored.  Seeded at `x0` (assumed
    feasible — e.g. the floor/ceil snap winner), so the result is never
    worse than its seed.  Returns (best_values, best_score, stats)."""
    cur = {k: int(v) for k, v in x0.items()}
    keys = list(cur)
    cache: Dict[Tuple[int, ...], float] = {}

    def _scored(vals: Mapping) -> float:
        key = tuple(int(vals[k]) for k in keys)
        if key not in cache:
            cache[key] = float(score(vals))
        return cache[key]

    cur_v = _scored(cur)
    sweeps = 0
    for _ in range(int(max_sweeps)):
        sweeps += 1
        moved = False
        for k in keys:
            for d in (+1, -1):
                for _step in range(int(max_steps)):
                    cand = dict(cur)
                    cand[k] = cur[k] + d
                    if not (int(lo[k]) <= cand[k] <= int(hi[k])):
                        break
                    v = _scored(cand)
                    if v < cur_v:
                        cur, cur_v = cand, v
                        moved = True
                    else:
                        break
        if not moved:
            break
    return cur, cur_v, {"n_scored": len(cache), "n_sweeps": sweeps}


def _value_and_grad(loss_of, dev: torch.device):
    """(float, float64 numpy) value and gradient of `loss_of` at a host
    theta: a fresh leaf on `dev` per call (no graph survives the call),
    one copy back to the host for both."""
    def vg(theta):
        t = torch.tensor(np.asarray(theta, np.float64), dtype=torch.float64,
                         device=dev, requires_grad=True)
        v = loss_of(t)
        (g,) = torch.autograd.grad(v, t)
        out = torch.cat([v.detach().reshape(1), g]).cpu().numpy()
        return float(out[0]), out[1:]
    return vg


def _hessian(loss_of, dev: torch.device):
    """float64 numpy Hessian of `loss_of` at a host theta, by reverse over
    reverse (`torch.autograd.functional.hessian`) on `dev`, the rows of the
    second pass batched (``vectorize=True``: one batched backward, not one
    backward per parameter)."""
    def hess(theta):
        t = torch.tensor(np.asarray(theta, np.float64), dtype=torch.float64,
                         device=dev)
        return torch.autograd.functional.hessian(
            loss_of, t, vectorize=True).cpu().numpy()
    return hess


def _log_objective(m: Mapping[str, torch.Tensor], objective: str):
    """The refiners' log-space loss of one metric dict: log energy + log
    latency for "edp", else the log of the metric."""
    if objective == "edp":
        return torch.log(m["energy_j"]) + torch.log(m["latency_s"])
    return torch.log(m[objective])


def refine_continuous(
    topology: str,
    overrides: Mapping[str, float],
    traffic,
    refine_axes: Sequence[str] = DEFAULT_REFINE_AXES,
    objective: str = "edp",
    steps: int = 48,
    lr: float = 0.1,
    span: float = 4.0,
    bounds: Optional[Mapping[str, Tuple[float, float]]] = None,
    active_fraction: float = 1.0,
    devices=None,
    device="cuda",
) -> Dict[str, object]:
    """Locally refine one configuration by autograd through the continuous
    columns (losses, rates, bandwidths, interposer geometry), in float64 on
    `device`.

    The design point is parameterized in log-space (every continuous column
    is positive and spans decades) and descended with a projected-gradient
    loop: theta <- clip(theta - lr * grad, log lo, log hi), default box
    [x0/span, x0*span] per axis.  `objective` is "edp"
    (log energy + log latency, the example's search quantity) or any metric
    name ("energy_j", "latency_s", "power_w", ...) minimized in log-space.
    Discrete kernel quantities (stage counts, subnetwork counts, rounded
    active-wavelength counts) are piecewise-constant — zero gradient — so
    descent moves only along genuinely continuous directions; a step that
    crosses a quantization boundary is still scored exactly by the next
    forward evaluation.

    Returns {"start", "refined"} column values, the objective trace, and the
    refined point's full metric dict.
    """
    if topology not in TOPOLOGY_ARRAYS:
        raise KeyError(f"unknown topology {topology!r}")
    _check_objective(objective, METRIC_FIELDS, "refine_continuous")
    spec = grid_spec((topology,), devices=devices)
    cols: Dict[str, float] = dict(spec.base)
    for k, v in overrides.items():
        if k == "topology":
            continue
        if k not in cols:
            raise KeyError(f"unknown column {k!r}")
        cols[k] = float(v)
    names = tuple(refine_axes)
    for nm in names:
        if nm not in cols:
            raise KeyError(f"unknown refine axis {nm!r}")
        if cols[nm] <= 0:
            raise ValueError(f"refine axis {nm!r} must be positive")

    x0 = np.asarray([cols[nm] for nm in names], np.float64)
    if bounds is None:
        bounds = {nm: (x0[i] / span, x0[i] * span)
                  for i, nm in enumerate(names)}
    lo_box = np.asarray([bounds[nm][0] for nm in names], np.float64)
    hi_box = np.asarray([bounds[nm][1] for nm in names], np.float64)
    lo, hi = np.log(lo_box), np.log(hi_box)

    xp = TorchNS(require_device(device))
    kern = TOPOLOGY_ARRAYS[topology]
    const = {k: xp.asarray(v) for k, v in cols.items()}
    bits, xfers = xp.asarray(traffic.total_bits), xp.asarray(traffic.n_transfers)
    frac = xp.asarray(active_fraction)

    def metrics_of(theta):
        c = dict(const)
        x = torch.exp(theta)
        for i, nm in enumerate(names):
            c[nm] = x[i]
        fields = kern(c, xp)
        dev = {k: c[k] for k in EVAL_DEVICE_FIELDS}
        return eval_network_math(fields, dev, bits, xfers, frac)

    def metrics_at(theta) -> Dict[str, float]:
        t = torch.tensor(np.asarray(theta, np.float64), dtype=torch.float64,
                         device=xp.device)
        with torch.no_grad():
            m = metrics_of(t)
        vals = torch.stack([v.reshape(()) for v in m.values()]).cpu().numpy()
        return {k: float(v) for k, v in zip(m, vals)}

    value_and_grad = _value_and_grad(
        lambda t: _log_objective(metrics_of(t), objective), xp.device)

    theta0 = np.minimum(np.maximum(np.log(x0), lo), hi)
    best_loss, best_theta, trace, _ = _projected_descent(
        value_and_grad, theta0, lo, hi, steps, lr)

    # snap the reported values back inside the exact float64 box, then
    # re-evaluate the metrics AT the clipped point: the reported metrics
    # describe the reported design
    x_best = np.clip(np.exp(np.asarray(best_theta, np.float64)),
                     lo_box, hi_box)
    metrics = metrics_at(np.log(x_best))
    if objective == "edp":
        best_loss = float(np.log(metrics["energy_j"])
                          + np.log(metrics["latency_s"]))
    else:
        best_loss = float(np.log(metrics[objective]))
    if best_loss > trace[0]:
        # clipping moved the iterate enough to undo the descent gain: fall
        # back to the seed point, keeping refined_value <= start_value
        x_best = np.clip(np.exp(np.asarray(theta0, np.float64)),
                         lo_box, hi_box)
        metrics = metrics_at(theta0)
        best_loss = trace[0]
    return {
        "topology": topology,
        "objective": objective,
        "refine_axes": list(names),
        "start": {nm: float(x0[i]) for i, nm in enumerate(names)},
        "refined": {nm: float(x_best[i]) for i, nm in enumerate(names)},
        "start_value": float(np.exp(trace[0])),
        "refined_value": float(np.exp(best_loss)),
        "improvement": float(1.0 - np.exp(best_loss - trace[0])),
        "loss_trace": trace,
        "metrics": metrics,
    }


def refine_front_point(
    spec: GridSpec,
    traffic,
    index: int,
    **kwargs,
) -> Dict[str, object]:
    """`refine_continuous` seeded from flat grid row `index` of `spec` —
    the "descend locally from a Pareto point" entry point."""
    cfg = spec.config_at(int(index))
    topology = cfg.pop("topology")
    return refine_continuous(topology, cfg, traffic, **kwargs)


# --------------------------------------------------------------------------
# Co-design gradient refinement: accelerator + network axes jointly
# --------------------------------------------------------------------------


# the relaxable accelerator-side axes: per-chiplet unit/vector counts plus
# the two compute-rate/energy scalars of `core.accelerator._accel_mix_math`
ACCEL_REFINE_AXES: Tuple[str, ...] = (
    "n_units", "vector_size", "mac_rate_hz", "lambda_slot_energy_j")


def _objective_value(metrics: Mapping[str, object], objective: str):
    """Scalarize a metric dict: "edp" = energy * latency, anything else is
    the metric itself.  Works on floats and on (M, N) metric grids."""
    if objective == "edp":
        return (np.asarray(metrics["energy_j"], np.float64)
                * np.asarray(metrics["latency_s"], np.float64))
    return np.asarray(metrics[objective], np.float64)


def _int_neighbors(v: float, extra: Optional[float] = None,
                   lo: int = 1) -> List[int]:
    """Admissible integer neighbors of a relaxed value: floor and ceil
    (clamped at `lo`), plus the seed's original value when given — the
    fallback that keeps the round-and-rescore candidate set from ever
    excluding the known-feasible seed setting."""
    opts = {int(np.floor(v)), int(np.ceil(v))}
    if extra is not None:
        opts.add(int(round(extra)))
    return sorted(o for o in opts if o >= lo) or [lo]


def _as_workload_batch(wl, weights) -> Tuple[List[Workload], np.ndarray]:
    """Normalize the `wl` argument of the refiners: one `Workload` or a
    sequence of them, with optional positive per-workload weights
    (normalized to sum 1; uniform when omitted)."""
    wls = [wl] if isinstance(wl, Workload) else list(wl)
    if not wls:
        raise ValueError("need at least one workload to refine against")
    for w in wls:
        if not isinstance(w, Workload):
            raise TypeError(
                f"expected Workload entries, got {type(w).__name__}")
    if weights is None:
        wts = np.full(len(wls), 1.0 / len(wls), np.float64)
    else:
        wts = np.asarray(list(weights), np.float64)
        if wts.shape != (len(wls),):
            raise ValueError(
                f"weights shape {wts.shape} does not match "
                f"{len(wls)} workloads")
        if not np.all(wts > 0):
            raise ValueError("workload weights must all be positive")
        wts = wts / wts.sum()
    return wls, wts


def _combined_value(values: Sequence[float], weights: np.ndarray) -> float:
    """The multi-workload scalarization: weighted geometric mean of the
    per-workload objective values.  A single workload short-circuits to its
    exact objective value (no exp/log round-trip), so one-workload
    refinement reports bit-identically to the single-workload engine."""
    vals = np.asarray(values, np.float64)
    if vals.shape[0] == 1:
        return float(vals[0])
    return float(np.exp(np.sum(np.asarray(weights, np.float64)
                               * np.log(vals))))


def _relaxed_loss(cols: Mapping[str, float], topology: str,
                  entries: Sequence[Tuple[str, object, float]],
                  seed_mix: Sequence, wls: Sequence[Workload],
                  wts: np.ndarray, objective: str, mac_rate_hz: float,
                  lambda_slot_energy_j: float, transfers_per_layer: int,
                  adaptive_gateways: bool, xp: TorchNS):
    """`refine_codesign`'s relaxed differentiable loss of the log-space
    parameter vector theta (one entry per `entries` row: a network column,
    a chiplet's n_units or vector_size, mac_rate_hz or
    lambda_slot_energy_j): the topology kernel plus the accelerator kernel
    with ``relaxed=True``, as the weights-weighted sum of per-workload log
    objectives on `xp`'s device.  Constants go to the device once; each
    call builds the graph of theta only, with the (C,) chiplet columns
    stacked from theta and seed constants (no in-place write)."""
    from repro_torch.core.accelerator import _accel_mix_math, layer_columns

    kern = TOPOLOGY_ARRAYS[topology]
    const = {k: xp.asarray(v) for k, v in cols.items()}
    lcs = [{k: xp.asarray(np.asarray(v, np.float64))
            for k, v in layer_columns(w).items()} for w in wls]
    units0 = [xp.asarray(float(c.n_units)) for c in seed_mix]
    vec0 = [xp.asarray(float(c.vector_size)) for c in seed_mix]
    mac0, slot0 = xp.asarray(mac_rate_hz), xp.asarray(lambda_slot_energy_j)
    xfers = xp.asarray(float(transfers_per_layer))
    at = {(kind, key): i for i, (kind, key, _) in enumerate(entries)}
    C = len(seed_mix)

    def relaxed_metrics(theta, lc):
        x = torch.exp(theta)
        c = dict(const)
        for i, (kind, key, _) in enumerate(entries):
            if kind == "net":
                c[key] = x[i]
        units = torch.stack([x[at[("units", j)]] if ("units", j) in at
                             else units0[j] for j in range(C)])
        vec = torch.stack([x[at[("vec", j)]] if ("vec", j) in at
                           else vec0[j] for j in range(C)])
        mac = x[at[("mac", None)]] if ("mac", None) in at else mac0
        slot = x[at[("slot", None)]] if ("slot", None) in at else slot0
        fields = kern(c, xp)
        nets1 = {k: torch.reshape(fields[k], (1,)) for k in MODEL_FIELDS}
        dev1 = {k: torch.reshape(c[k], (1,)) for k in EVAL_DEVICE_FIELDS}
        mem_bw1 = torch.reshape(
            c["n_mem_chiplets"] * c["mem_bw_bytes_per_s"], (1,))
        m = _accel_mix_math(
            {"n_units": units, "vector_size": vec}, None, lc, nets1, dev1,
            mem_bw1, mac, slot, xfers, adaptive=adaptive_gateways,
            relaxed=True)
        return {k: v[0] for k, v in m.items()}

    def loss_of(theta):
        # weighted sum of per-workload log objectives = log of the
        # weighted-geomean scalarization (one workload: plain log loss)
        total = 0.0
        for wt, lc in zip(wts, lcs):
            term = _log_objective(relaxed_metrics(theta, lc), objective)
            total = total + float(wt) * term
        return total

    return loss_of


def refine_codesign(
    spec: GridSpec,
    mixes: Sequence,
    wl,
    flat_index: int,
    *,
    refine_axes: Sequence[str] = DEFAULT_REFINE_AXES,
    accel_axes: Sequence[str] = ACCEL_REFINE_AXES,
    objective: str = "edp",
    method: str = "first_order",
    weights: Optional[Sequence[float]] = None,
    steps: int = 32,
    lr: float = 0.1,
    span: float = 4.0,
    bounds: Optional[Mapping[str, Tuple[float, float]]] = None,
    mac_rate_hz: float = 5e9,
    lambda_slot_energy_j: float = 30e-15,
    adaptive_gateways: bool = True,
    transfers_per_layer: int = 16,
    max_candidates: int = 1024,
    tr_radius: float = 0.5,
    max_sweeps: int = 4,
    device="cuda",
) -> Dict[str, object]:
    """Jointly refine one `codesign_pareto` frontier point over accelerator
    AND network axes, then snap back to a feasible integer design; the
    descent and every exact score run in float64 on `device`.

    Seeds from flat index `flat_index` (decoded via `codesign_config_at`),
    relaxes the accelerator axes continuously (the grid kernel's
    ``relaxed=True`` mode replaces ceil(L/V) with max(L/V, 1) so per-chiplet
    `n_units`/`vector_size`, `mac_rate_hz` and `lambda_slot_energy_j` all
    carry nonzero gradients; zero-unit padding chiplets stay exactly
    masked), and descends the concatenated accelerator + `refine_axes`
    network parameter vector in log-space.

    `method` picks the descent + integerization strategy:

    - "first_order": the fixed-lr projected-gradient loop shared with
      `refine_continuous`, followed by the one-shot floor/ceil
      round-and-rescore over the integer-neighbor cross product.
    - "trust_region": second-order log-space trust-region descent
      (`_trust_region_descent` — quadratic model from the autograd Hessian
      of the relaxed objective, adaptive radius, accept/reject on exactly
      re-evaluated steps), followed by the floor/ceil snap AND a
      coordinate-wise integer line search (`_coordinate_int_search`) seeded
      at the snap winner: each discrete axis walks in +-1 integer steps,
      every candidate exactly re-scored through
      `evaluate_accelerator_grid`, to a local integer optimum.  The
      line-search result weakly dominates the plain snap by construction
      (it starts there).

    `wl` is one `Workload` or a sequence of them; with several, the scalar
    objective is the `weights`-weighted geometric mean of the per-workload
    objective values (weights normalized to sum 1, uniform by default) and
    the returned metrics carry a "per_workload" breakdown for the final
    integer design.

    Round-and-rescore: every discrete axis (per-chiplet vector_size /
    n_units, and any refined network axis in `core.sweep.INTEGER_AXES`) is
    snapped to its floor/ceil integer neighbors (seed value kept as a
    fallback for the network axes), every candidate combination is re-scored
    EXACTLY through `evaluate_accelerator_grid` (relaxed=False), and the
    best candidate wins — re-scored once more as a single (M=1, N=1) cell
    so the reported metrics are bit-identical to any later standalone
    evaluation of that design on the same device.  If no candidate beats
    the seed's exact score, the seed is returned (improvement 0.0): the
    refined point is always a feasible integer design and never worse than
    its seed.  Candidates whose network settings the topology rejects (e.g.
    SPACX with < 8 gateways) are filtered out before scoring; the integer
    line search scores rejected candidates as +inf.

    Returns a dict with "seed"/"refined" {config, metrics, per_workload,
    value} (configs are `core.fabric.Fabric.from_config`-consumable;
    "metrics" is the first workload's exact metric dict, "per_workload" the
    full per-workload list, "value" the scalarized objective),
    "improvement" (fractional objective gain, >= 0), per-axis
    gradient-magnitude "sensitivity" at the seed, the descent "loss_trace",
    the "relaxed" (pre-snap) axis values, "n_candidates" scored, plus
    "method", "workloads"/"weights", and — for the trust-region method —
    "tr_stats" (accept/reject counts, radius trajectory) and "line_search"
    ({snap_value, value, n_scored, n_sweeps}).
    """
    from repro_torch.core.accelerator import (
        ACCEL_REPORT_FIELDS, ChipletSpec, evaluate_accelerator_grid)

    _check_objective(objective, ACCEL_REPORT_FIELDS, "refine_codesign")
    if method not in ("first_order", "trust_region"):
        raise ValueError(
            f"unknown refine method {method!r}; valid methods are "
            "'first_order' or 'trust_region'")
    bad = [a for a in accel_axes if a not in ACCEL_REFINE_AXES]
    if bad:
        raise KeyError(
            f"unknown accelerator refine axes {bad!r}; valid axes are "
            f"{list(ACCEL_REFINE_AXES)}")
    wls, wts = _as_workload_batch(wl, weights)
    xp = TorchNS(require_device(device))

    cfg = codesign_config_at(spec, mixes, flat_index)
    seed_mix = [ChipletSpec(int(c.n_units), int(c.vector_size))
                for c in cfg.pop("chiplets")]
    mix_id = cfg.pop("mix")
    topology = cfg.pop("topology")
    kern = TOPOLOGY_ARRAYS[topology]

    cols: Dict[str, float] = dict(spec.base)
    for k, v in cfg.items():
        cols[k] = float(v)
    net_names = tuple(refine_axes)
    for nm in net_names:
        if nm not in cols:
            raise KeyError(f"unknown refine axis {nm!r}")
        if cols[nm] <= 0:
            raise ValueError(f"refine axis {nm!r} must be positive")

    # ---- parameter vector: network axes ++ relaxed accelerator axes ----
    C = len(seed_mix)
    active = [j for j in range(C) if seed_mix[j].n_units > 0]
    entries: List[Tuple[str, object, float]] = [
        ("net", nm, cols[nm]) for nm in net_names]
    if "n_units" in accel_axes:
        entries += [("units", j, float(seed_mix[j].n_units))
                    for j in active]
    if "vector_size" in accel_axes:
        entries += [("vec", j, float(seed_mix[j].vector_size))
                    for j in active]
    if "mac_rate_hz" in accel_axes:
        entries.append(("mac", None, float(mac_rate_hz)))
    if "lambda_slot_energy_j" in accel_axes:
        entries.append(("slot", None, float(lambda_slot_energy_j)))
    if not entries:
        raise ValueError(
            "nothing to refine: refine_axes and accel_axes are both empty")

    def _label(kind, key):
        if kind == "net":
            return key
        if kind == "units":
            return f"n_units[{key}]"
        if kind == "vec":
            return f"vector_size[{key}]"
        return "mac_rate_hz" if kind == "mac" else "lambda_slot_energy_j"

    labels = [_label(k, j) for k, j, _ in entries]
    x0 = np.asarray([v for _, _, v in entries], np.float64)
    lo_f, hi_f = x0 / span, x0 * span
    for i, (kind, _, _) in enumerate(entries):
        if kind in ("units", "vec"):  # count axes never relax below 1
            lo_f[i] = max(lo_f[i], 1.0)
            hi_f[i] = max(hi_f[i], 1.0)
    if bounds:
        for i, lb in enumerate(labels):
            if lb in bounds:
                lo_f[i], hi_f[i] = bounds[lb]
    lo, hi = np.log(lo_f), np.log(hi_f)

    loss_of = _relaxed_loss(cols, topology, entries, seed_mix, wls, wts,
                            objective, mac_rate_hz, lambda_slot_energy_j,
                            transfers_per_layer, adaptive_gateways, xp)
    value_and_grad = _value_and_grad(loss_of, xp.device)
    theta0 = np.minimum(np.maximum(np.log(x0), lo), hi)
    tr_stats: Optional[Dict[str, object]] = None
    if method == "first_order":
        _, best_theta, trace, grad0 = _projected_descent(
            value_and_grad, theta0, lo, hi, steps, lr)
    else:
        _, best_theta, trace, grad0, tr_stats = _trust_region_descent(
            value_and_grad, _hessian(loss_of, xp.device), theta0, lo, hi,
            steps, radius=tr_radius)
    sensitivity = {lb: float(abs(g)) for lb, g in zip(labels, grad0)}
    x_best = np.clip(np.exp(np.asarray(best_theta, np.float64)), lo_f, hi_f)

    # ---- round-and-rescore: snap discrete axes, score exactly, keep best --
    refined_net = {nm: float(cols[nm]) for nm in net_names}
    refined_units = np.asarray([float(c.n_units) for c in seed_mix])
    refined_vec = np.asarray([float(c.vector_size) for c in seed_mix])
    refined_mac = float(mac_rate_hz)
    refined_slot = float(lambda_slot_energy_j)
    for i, (kind, key, _) in enumerate(entries):
        v = float(x_best[i])
        if kind == "net":
            refined_net[key] = v
        elif kind == "units":
            refined_units[key] = v
        elif kind == "vec":
            refined_vec[key] = v
        elif kind == "mac":
            refined_mac = v
        else:
            refined_slot = v

    unit_opts = [[seed_mix[j].n_units] for j in range(C)]
    vec_opts = [[seed_mix[j].vector_size] for j in range(C)]
    if "n_units" in accel_axes:
        for j in active:
            unit_opts[j] = _int_neighbors(refined_units[j])
    if "vector_size" in accel_axes:
        for j in active:
            vec_opts[j] = _int_neighbors(refined_vec[j])
    net_int = [nm for nm in net_names if nm in INTEGER_AXES]
    net_opts = {nm: _int_neighbors(refined_net[nm], extra=cols[nm])
                for nm in net_int}

    n_mix_full = int(np.prod([len(u) * len(v)
                              for u, v in zip(unit_opts, vec_opts)]))
    n_net_full = int(np.prod([len(v) for v in net_opts.values()])
                     ) if net_opts else 1
    if n_mix_full * n_net_full <= max_candidates:
        per_chip = [[(u, v) for u in uo for v in vo]
                    for uo, vo in zip(unit_opts, vec_opts)]
        mix_cands = [tuple(chips) for chips in itertools.product(*per_chip)]
        net_cands = [dict(zip(net_opts, vals))
                     for vals in itertools.product(*net_opts.values())]
    else:
        # corner count exploded past max_candidates: score the nearest-
        # rounded design plus every single-axis flip instead of the full
        # cross product
        near_u = [min(uo, key=lambda o: abs(o - refined_units[j]))
                  for j, uo in enumerate(unit_opts)]
        near_v = [min(vo, key=lambda o: abs(o - refined_vec[j]))
                  for j, vo in enumerate(vec_opts)]
        base = tuple(zip(near_u, near_v))
        mix_cands = [base]
        for j in range(C):
            for u in unit_opts[j]:
                if u != near_u[j]:
                    alt = list(base)
                    alt[j] = (u, near_v[j])
                    mix_cands.append(tuple(alt))
            for v in vec_opts[j]:
                if v != near_v[j]:
                    alt = list(base)
                    alt[j] = (near_u[j], v)
                    mix_cands.append(tuple(alt))
        near_net = {nm: min(net_opts[nm],
                            key=lambda o: abs(o - refined_net[nm]))
                    for nm in net_opts}
        net_cands = [dict(near_net)]
        for nm in net_opts:
            for o in net_opts[nm]:
                if o != near_net[nm]:
                    alt = dict(near_net)
                    alt[nm] = o
                    net_cands.append(alt)
    seed_net = {nm: int(round(cols[nm])) for nm in net_int}
    if seed_net not in net_cands:
        net_cands.append(seed_net)

    # drop candidates the topology itself rejects (e.g. SPACX < 8 gateways):
    # the numpy kernel on the host raises for them
    valid_net = []
    for cand in net_cands:
        c1 = {k: np.full(1, v, np.float64) for k, v in cols.items()}
        for nm in net_names:
            c1[nm][:] = refined_net[nm]
        for nm, v in cand.items():
            c1[nm][:] = float(v)
        try:
            kern(c1)
        except (ValueError, FloatingPointError):
            continue
        valid_net.append(cand)
    if not valid_net:
        # even the seed integers fail under the refined continuous values:
        # retreat to the seed network configuration wholesale
        valid_net = [seed_net]
        for nm in net_names:
            if nm not in net_int:
                refined_net[nm] = float(cols[nm])

    n_net = len(valid_net)
    cand_cols = {k: np.full(n_net, v, np.float64) for k, v in cols.items()}
    for nm in net_names:
        cand_cols[nm][:] = refined_net[nm]
    for i, cand in enumerate(valid_net):
        for nm, v in cand.items():
            cand_cols[nm][i] = float(v)
    nets = _network_columns_arrays(
        cand_cols, np.zeros(n_net, np.int64), (topology,))
    mem_bw = cand_cols["n_mem_chiplets"] * cand_cols["mem_bw_bytes_per_s"]
    cand_mixes = [[ChipletSpec(int(u), int(v)) for (u, v) in chips]
                  for chips in mix_cands]

    def _score_grid(ms, nets_, cols_, mbw_):
        """Scalarized (M, N) candidate scores: the weights-weighted sum of
        per-workload log objectives — i.e. the log of the weighted-geomean
        objective, so argmin matches the scalarization exactly."""
        total = None
        for wt, w in zip(wts, wls):
            o = evaluate_accelerator_grid(
                w, ms, nets_, cols_, mbw_, mac_rate_hz=refined_mac,
                lambda_slot_energy_j=refined_slot,
                adaptive_gateways=adaptive_gateways,
                transfers_per_layer=transfers_per_layer, device=xp.device)
            s = float(wt) * np.log(_objective_value(o, objective))
            total = s if total is None else total + s
        return total

    score = _score_grid(cand_mixes, nets, cand_cols, mem_bw)
    mi, ni = np.unravel_index(int(np.argmin(score)), score.shape)

    def _score_single(mix, net_vals: Mapping[str, float], mac, slot):
        """Exact (M=1, N=1) per-workload scores — bit-identical to any later
        standalone `evaluate_accelerator_grid` call on the same design and
        device.  Returns (per_workload_metric_dicts, scalarized_value)."""
        c1 = {k: np.full(1, v, np.float64) for k, v in cols.items()}
        for nm, v in net_vals.items():
            c1[nm][:] = float(v)
        n1 = _network_columns_arrays(c1, np.zeros(1, np.int64), (topology,))
        mbw = c1["n_mem_chiplets"] * c1["mem_bw_bytes_per_s"]
        per = []
        for w in wls:
            o = evaluate_accelerator_grid(
                w, [mix], n1, c1, mbw, mac_rate_hz=mac,
                lambda_slot_energy_j=slot,
                adaptive_gateways=adaptive_gateways,
                transfers_per_layer=transfers_per_layer, device=xp.device)
            per.append({k: float(v[0, 0]) for k, v in o.items()})
        value = _combined_value(
            [float(_objective_value(m, objective)) for m in per], wts)
        return per, value

    win_net = dict(refined_net)
    win_net.update({nm: float(v) for nm, v in valid_net[ni].items()})
    win_mix = list(cand_mixes[mi])

    line_search: Optional[Dict[str, object]] = None
    if method == "trust_region":
        # coordinate-wise integer line search seeded at the floor/ceil snap
        # winner: walk every discrete axis in +-1 steps (others held), each
        # candidate exactly re-scored, to a local integer optimum — the
        # result can only improve on the snap (it starts there)
        ls_vars: Dict[Tuple[str, object], int] = {}
        ls_lo: Dict[Tuple[str, object], int] = {}
        ls_hi: Dict[Tuple[str, object], int] = {}
        for i, (kind, key, _) in enumerate(entries):
            if kind == "units":
                v = int(win_mix[key].n_units)
            elif kind == "vec":
                v = int(win_mix[key].vector_size)
            elif kind == "net" and key in net_int:
                v = int(round(win_net[key]))
            else:
                continue
            ls_vars[(kind, key)] = v
            ls_lo[(kind, key)] = min(int(np.ceil(lo_f[i] - 1e-9)), v)
            ls_hi[(kind, key)] = max(int(np.floor(hi_f[i] + 1e-9)), v)

        def _ls_score(vals: Mapping) -> float:
            mix = [ChipletSpec(
                int(vals.get(("units", j), win_mix[j].n_units)),
                int(vals.get(("vec", j), win_mix[j].vector_size)))
                for j in range(C)]
            if not any(csp.n_units > 0 for csp in mix):
                return float(np.inf)
            nv = dict(win_net)
            for nm in net_int:
                if ("net", nm) in vals:
                    nv[nm] = float(vals[("net", nm)])
            c1 = {k: np.full(1, v, np.float64) for k, v in cols.items()}
            for nm, v in nv.items():
                c1[nm][:] = float(v)
            try:
                n1 = _network_columns_arrays(
                    c1, np.zeros(1, np.int64), (topology,))
            except (ValueError, FloatingPointError):
                return float(np.inf)  # topology rejects this integer point
            mbw = c1["n_mem_chiplets"] * c1["mem_bw_bytes_per_s"]
            return float(_score_grid([mix], n1, c1, mbw)[0, 0])

        if ls_vars:
            snap_score = _ls_score(ls_vars)
            best_vals, best_score, ls_stats = _coordinate_int_search(
                ls_vars, ls_lo, ls_hi, _ls_score, max_sweeps=max_sweeps)
            if best_score < snap_score:
                win_mix = [ChipletSpec(
                    int(best_vals.get(("units", j), win_mix[j].n_units)),
                    int(best_vals.get(("vec", j), win_mix[j].vector_size)))
                    for j in range(C)]
                for nm in net_int:
                    if ("net", nm) in best_vals:
                        win_net[nm] = float(best_vals[("net", nm)])
            line_search = {
                "snap_value": float(np.exp(snap_score)),
                "value": float(np.exp(min(best_score, snap_score))),
                "n_scored": int(ls_stats["n_scored"]),
                "n_sweeps": int(ls_stats["n_sweeps"]),
            }
        else:
            line_search = {"snap_value": float(np.exp(score[mi, ni])),
                           "value": float(np.exp(score[mi, ni])),
                           "n_scored": 0, "n_sweeps": 0}

    win_per, win_value = _score_single(
        win_mix, win_net, refined_mac, refined_slot)
    win_metrics = win_per[0]
    seed_per, seed_value = _score_single(
        seed_mix, {}, float(mac_rate_hz), float(lambda_slot_energy_j))
    seed_metrics = seed_per[0]

    seed_cfg: Dict[str, object] = {"topology": topology, **cfg}
    seed_cfg.update({
        "mix": mix_id, "chiplets": list(seed_mix),
        "mac_rate_hz": float(mac_rate_hz),
        "lambda_slot_energy_j": float(lambda_slot_energy_j)})
    if win_value < seed_value:
        ref_cfg: Dict[str, object] = {"topology": topology, **cfg}
        for nm in net_names:
            ref_cfg[nm] = float(win_net[nm])
        ref_cfg.update({
            "mix": mix_id, "chiplets": list(win_mix),
            "mac_rate_hz": refined_mac,
            "lambda_slot_energy_j": refined_slot})
        refined = {"config": ref_cfg, "metrics": win_metrics,
                   "per_workload": win_per, "value": win_value,
                   "chiplets": list(win_mix)}
    else:
        # no snapped candidate beat the exact seed score: keep the seed, so
        # the refined point is never worse than where it started
        refined = {"config": dict(seed_cfg), "metrics": dict(seed_metrics),
                   "per_workload": [dict(m) for m in seed_per],
                   "value": seed_value, "chiplets": list(seed_mix)}

    return {
        "flat_index": int(flat_index),
        "topology": topology,
        "objective": objective,
        "method": method,
        "workloads": [w.name for w in wls],
        "weights": [float(x) for x in wts],
        "labels": labels,
        "seed": {"config": seed_cfg, "metrics": seed_metrics,
                 "per_workload": seed_per, "value": seed_value},
        "refined": refined,
        "improvement": float(1.0 - refined["value"] / seed_value),
        "sensitivity": sensitivity,
        "loss_trace": trace,
        "relaxed": {lb: float(x_best[i]) for i, lb in enumerate(labels)},
        "n_candidates": len(cand_mixes) * n_net,
        "tr_stats": tr_stats,
        "line_search": line_search,
    }


def refine_trust_region(spec: GridSpec, mixes: Sequence, wl, flat_index: int,
                        **kwargs) -> Dict[str, object]:
    """`refine_codesign(method="trust_region")`: second-order log-space
    trust-region descent on the relaxed objective followed by a
    coordinate-wise integer line search on the discrete axes, optionally
    jointly over a weighted batch of workloads.  See `refine_codesign` for
    the full contract."""
    kwargs.setdefault("method", "trust_region")
    return refine_codesign(spec, mixes, wl, flat_index, **kwargs)


def _front_objective(front: ParetoFront, objective: str) -> np.ndarray:
    """Scalar objective of each front row from its stored columns ("edp" =
    energy * latency); falls back to the first objective column when the
    requested metric isn't one the front tracks."""
    names = list(front.objectives)
    if objective == "edp" and {"energy_j", "latency_s"} <= set(names):
        return (front.points[:, names.index("energy_j")]
                * front.points[:, names.index("latency_s")])
    if objective in names:
        return front.points[:, names.index(objective)]
    return front.points[:, 0]


def refine_front(
    front: ParetoFront,
    spec: GridSpec,
    mixes: Sequence,
    wl,
    *,
    top_k: Optional[int] = None,
    objective: str = "edp",
    method: str = "first_order",
    device="cuda",
    **kwargs,
) -> Dict[str, object]:
    """Refine every (or the `top_k` best-objective) row of a
    `codesign_pareto` front through `refine_codesign` on `device`, then
    merge the refined integer designs back into the seed front with
    `merge_fronts`.

    `method` selects the descent engine per row ("first_order" or
    "trust_region" — see `refine_codesign`); `wl` may be a single
    `Workload` or a weighted batch (pass `weights=` through kwargs), in
    which case each row is refined against the scalarized multi-workload
    objective and the merged front's points are the FIRST workload's exact
    metrics for the final integer designs.

    Merging unions the point sets, so the merged front weakly dominates the
    seed front by construction — asserted before returning (a violation
    would mean the exact rescore and the front machinery disagree, i.e. a
    real bug).  Per-axis gradient-magnitude sensitivities are averaged
    across the refined seeds: which axis the objective is most elastic to
    along this frontier.

    Returns {"front", "seed_front", "results", "configs", "n_improved",
    "sensitivity"}.  `configs` decodes every merged-front row — refined
    rows to their snapped refined config, surviving seed rows via
    `codesign_config_at` — each directly consumable by
    `core.fabric.Fabric.from_config`.
    """
    if front.size == 0:
        raise ValueError("empty front: nothing to refine")
    order = np.argsort(_front_objective(front, objective), kind="stable")
    chosen = order if top_k is None else order[:max(1, int(top_k))]
    results = [refine_codesign(spec, mixes, wl, int(front.indices[i]),
                               objective=objective, method=method,
                               device=device, **kwargs)
               for i in chosen]
    obj_names = front.objectives
    ref_pts = np.asarray(
        [[r["refined"]["metrics"][k] for k in obj_names] for r in results],
        np.float64)
    ref_idx = np.asarray([r["flat_index"] for r in results], np.int64)
    merged = merge_fronts(front, ParetoFront(obj_names, ref_pts, ref_idx),
                          device=device)

    # weak-dominance gate: every seed point must be dominated by, or still
    # present in, the merged front
    dom = _dominated_by(front.points, merged.points, device)
    present = np.asarray([
        bool(np.all(merged.points == p, axis=1).any())
        for p in front.points])
    if not bool(np.all(dom | present)):
        raise AssertionError(
            "refined front fails to weakly dominate its seed front")

    ref_map = {(int(r["flat_index"]), tuple(pt)): r["refined"]["config"]
               for r, pt in zip(results, ref_pts)}
    configs: List[Dict[str, object]] = []
    for i in range(merged.size):
        key = (int(merged.indices[i]), tuple(merged.points[i]))
        hit = ref_map.get(key)
        configs.append(hit if hit is not None else
                       codesign_config_at(spec, mixes,
                                          int(merged.indices[i])))
    sens: Dict[str, List[float]] = {}
    for r in results:
        for lb, v in r["sensitivity"].items():
            sens.setdefault(lb, []).append(v)
    return {
        "front": merged,
        "seed_front": front,
        "results": results,
        "configs": configs,
        "n_improved": int(sum(r["improvement"] > 0 for r in results)),
        "sensitivity": {lb: float(np.mean(v)) for lb, v in sens.items()},
    }
