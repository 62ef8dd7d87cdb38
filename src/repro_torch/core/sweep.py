"""Vectorized design-space sweep engine for the interposer-network models.

The paper's headline figures come from sweeping network configurations across
gateways / wavelengths / modulation rates / device corners.  The scalar
dataclass path (`NetworkParams` -> `NetworkModel` -> `evaluate_network`)
evaluates one configuration per Python call; this module flattens whole
parameter grids into struct-of-arrays columns and evaluates every metric the
power model produces — laser, trimming, latency, energy, energy-per-bit — for
10k+ configurations in one call.

Pipeline:

  build_grid(...)          cartesian product of a topology axis, any
                           NetworkParams field, any dotted DeviceLibrary leaf
                           ("mzi.insertion_loss_db", ...), and the TRINE
                           "n_subnetworks" override -> SweepGrid of float64
                           columns.
  network_columns(grid)    struct-of-arrays NetworkModel fields, via the
                           columnar topology kernels in core.topology.
  evaluate_columns(...)    the batched power/latency/energy math on a
                           device (mirrors power.evaluate_network
                           branch-free).
  sweep(traffic, ...)      all of the above in one call -> SweepResult.

`sweep_scalar_reference` walks the identical grid through the scalar
dataclass path one row at a time; it is the golden reference the parity tests
(and benchmarks/sweep_bench.py) compare the batched engine against.

`evaluate_accelerator_batch` is the same treatment for the Fig. 6 accelerator
model: all layers of a workload evaluated as one batch instead of a Python
loop per layer.

Device-resident streaming execution
-----------------------------------

`sweep(...)` materializes every grid column in host memory — ~45 float64
columns, so a 1e7-point grid costs ~3.6 GB before a single metric exists.
The streaming path bounds that AND keeps the hot loop off the host:

  grid_spec(...)           the same validation/axis vocabulary as
                           `build_grid`, but *lazy*: a GridSpec holds only
                           the axis value tuples and can materialize any
                           [start, stop) row window in O(window) memory
                           (mixed-radix decode of the flat index).
  sweep_chunked(traffic, reducer, ...)
                           streams fixed-size chunks through the one
                           universal evaluation (`_engine`), feeding each
                           chunk's metrics to a running `ChunkReducer` and
                           keeping nothing else.  Peak memory is
                           O(chunk_size), independent of grid size.

Two materialization modes feed the same evaluation:

  materialize="device"     (default) a chunk is generated from the `start`
                           scalar alone: the mixed-radix decode
                           (`_decode`) gathers each column from small
                           device-resident axis-value tables, so
                           steady-state streaming performs no per-chunk host
                           numpy work and no per-chunk column copy to the
                           device.
  materialize="host"       the serial reference layout: `GridSpec.chunk_cols`
                           builds the columns on the host (the golden
                           mixed-radix decode the device decode is
                           parity-tested against) and ships them to the
                           device.  Forced when ``shard=True`` or when a
                           legacy `columns_fn` callable needs host columns.

With ``shard=True`` under a process group of W > 1 ranks (`_config_mesh`,
the counterpart of the reference's config-axis `NamedSharding`), the chunk
size rounds up to a multiple of W, every rank builds the chunk's host
columns and evaluates its own contiguous chunk_size / W lanes on its
device, and the fold gathers every rank's network fields and metrics back
in rank order, so that every rank folds the whole chunk and returns the
same reducer result.  With no process group, or at world size 1,
``shard=True`` only forces host materialization, as the reference's does
on one device.

Bitwise reproducibility.  The reference gets it from one jitted program
instance; here every operation is its own eager kernel, and each computes
every element by the same correctly rounded arithmetic at any shape — the
engine does no reduction over the configuration axis, takes the same
sequence of operations on every path, and computes 10**x with
`TorchNS.pow10` (torch's CPU `pow` rounds its vectorised and tail lanes
differently).  So the decoded columns equal `chunk_cols` bit for bit, and
monolithic, chunked, sharded, host- and device-materialized runs at any
prefetch depth fold to bit-identical reducer states.  Everything is float64 by
construction, independent of `torch.get_default_dtype()`.

On top of either mode sits a double-buffered prefetch pipeline: a
single-worker executor runs chunk k+1 (decode, evaluation, and the copy of
its results to the host) while chunk k's results fold on the main thread
(torch releases the interpreter lock while the card computes and copies, so
reducer host work overlaps device compute).  The depth comes from
``prefetch=`` or the REPRO_PREFETCH environment flag (default 2); depth 0 is
the fully serial schedule.  Folds happen in chunk order regardless of
depth, so any depth produces bit-identical reducer states.

The fault hook composes on the device: `faults.faulted_columns_fn(scenario)`
returns a scenario-carrying hook whose six fields become *runtime inputs* of
the evaluation (the degradation algebra runs on every lane).  A healthy
scenario feeds exact IEEE identities (x+0, x*1), so a faulted-healthy sweep
is bitwise equal to a plain sweep.  Arbitrary legacy
``columns_fn(cols, topo_id, topologies) -> (nets, dev_cols)`` callables
still run on host-materialized columns.

Reducers are associative folds over chunks of host numpy arrays:
`MinReducer` tracks a metric's running argmin + config, and a Pareto
reducer keeps a running front via the merge-fronts property
front(A ∪ B) = front(front(A) ∪ front(B)).

This is the port's counterpart of the JAX package's `core/sweep.py`.  The
columnar, batched and streaming entry points take ``device=`` (default
"cuda", raising without a card) and return numpy arrays; the scalar
reference (`sweep_scalar_reference`) is host numpy and takes no device.
The config-axis sharding takes its ranks from the process group the caller
set up (`torchrun`, or `torch.distributed.init_process_group`), as the
reference takes its devices from `jax.devices()`.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.env import prefetch_depth
from repro_torch.core.devices import (
    DeviceLibrary,
    DEFAULT_DEVICES,
    device_columns,
    replace_device_leaves,
)
from repro_torch.core.topology import (
    MODEL_FIELDS,
    PARAM_FIELDS,
    TOPOLOGIES,
    TOPOLOGY_ARRAYS,
    NetworkParams,
    model_from_row,
)
from repro_torch.core.power import (
    EVAL_DEVICE_FIELDS,
    EVAL_METRIC_FIELDS,
    Traffic,
    broadcast_metrics,
    eval_network_math as eval_math,
    evaluate_network,
)
from repro_torch.core.accelerator import (  # noqa: F401  (re-exported; see below)
    evaluate_accelerator_batch,
    evaluate_accelerator_grid,
)
from repro_torch.core.xp import TorchNS

__all__ = [
    "SweepGrid", "SweepResult", "build_grid", "network_columns",
    "network_columns_device",
    "evaluate_columns", "sweep", "sweep_scalar_reference",
    "evaluate_accelerator_batch", "METRIC_FIELDS", "INTEGER_AXES",
    "DEFAULT_TOPOLOGIES",
    "GridSpec", "grid_spec", "SweepChunk", "ChunkReducer", "MinReducer",
    "sweep_chunked", "eval_math",
]

DEFAULT_TOPOLOGIES: Tuple[str, ...] = ("sprint", "spacx", "tree", "trine", "elec")

# int-typed NetworkParams fields (scalar-reference reconstruction)
_INT_PARAM_FIELDS = frozenset({"n_gateways", "n_mem_chiplets", "n_lambda",
                               "gateway_width_bits"})

# grid axes whose admissible values are integers: the int NetworkParams
# fields plus the TRINE subnetwork override.  A co-design refinement snaps
# relaxed values of these axes back to integer neighbors during
# round-and-rescore; everything else in the axis vocabulary is continuous.
INTEGER_AXES = _INT_PARAM_FIELDS | {"n_subnetworks"}

# metric columns emitted by the batched evaluator == NetworkReport fields
# (defined in core.power next to the math that emits them)
METRIC_FIELDS = EVAL_METRIC_FIELDS

# device leaves the power kernel reads (re-exported; defined in core.power
# next to the shared metric math)
_EVAL_DEVICE_FIELDS = EVAL_DEVICE_FIELDS


# --------------------------------------------------------------------------
# Grid construction
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Lazy cartesian grid: the axis vocabulary and defaults of `build_grid`
    without the materialized columns.  Any [start, stop) row window can be
    produced on demand by mixed-radix decoding the flat index, so a window
    costs O(window) memory regardless of grid size — the foundation of
    `sweep_chunked`'s bounded-memory streaming evaluation.

    axis order: ("topology", *axes), C-order raveled — identical flat-index
    layout to the eager SweepGrid `build_grid` returns.
    """

    topologies: Tuple[str, ...]
    axes: Dict[str, Tuple[float, ...]]
    base: Dict[str, float]
    shape: Tuple[int, ...]

    @property
    def n(self) -> int:
        return int(np.prod(self.shape))

    def chunk_cols(self, start: int, stop: int
                   ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """(cols, topo_id) for flat rows [start, stop) — element-for-element
        the values eager `build_grid` places at those rows.  The golden host
        reference the device decode is parity-tested against."""
        idx = np.arange(start, stop)
        digits = np.unravel_index(idx, self.shape)
        cols = {name: np.full(idx.size, v, np.float64)
                for name, v in self.base.items()}
        for ai, (name, vals) in enumerate(self.axes.items()):
            cols[name] = np.asarray(vals, np.float64)[digits[1 + ai]]
        return cols, np.ascontiguousarray(digits[0])

    def config_at(self, i: int) -> Dict[str, float]:
        """Human-readable swept-axis settings of flat row `i`."""
        digits = np.unravel_index(int(i), self.shape)
        out: Dict[str, float] = {"topology": self.topologies[int(digits[0])]}
        for ai, (name, vals) in enumerate(self.axes.items()):
            out[name] = float(vals[int(digits[1 + ai])])
        return out


def grid_spec(
    topologies: Sequence[str] = DEFAULT_TOPOLOGIES,
    devices: Optional[DeviceLibrary] = None,
    **axes: Sequence[float],
) -> GridSpec:
    """Validate and describe a grid without materializing it (see
    `build_grid` for the axis vocabulary)."""
    base: Dict[str, float] = {name: float(getattr(NetworkParams(), name))
                              for name in PARAM_FIELDS}
    base.update(device_columns(devices or DEFAULT_DEVICES))
    base["n_subnetworks"] = 0.0

    for name in axes:
        if name not in base:
            raise KeyError(
                f"unknown sweep axis {name!r}; valid axes are NetworkParams "
                f"fields, dotted device leaves, or 'n_subnetworks'")
    unknown = [t for t in topologies if t not in TOPOLOGY_ARRAYS]
    if unknown:
        raise KeyError(f"unknown topologies {unknown!r}")

    axes_vals = {k: tuple(float(x) for x in v) for k, v in axes.items()}
    shape = (len(topologies),) + tuple(len(v) for v in axes_vals.values())
    return GridSpec(topologies=tuple(topologies), axes=axes_vals,
                    base=base, shape=shape)


def _validate_grid_values(spec: GridSpec) -> None:
    """Eager data-dependent validation the device evaluation cannot do.

    The numpy SPACX kernel raises on n_gateways < 8 (zero clusters => zero
    bandwidth); the device evaluation runs every topology on every lane and
    selects, so it cannot raise data-dependently.  The grid is cartesian —
    every gateway value reaches the SPACX lanes — so the whole-axis check is
    exactly the condition the per-chunk numpy kernel would have tripped on.
    """
    if "spacx" not in spec.topologies:
        return
    gvals = spec.axes.get("n_gateways") or (spec.base["n_gateways"],)
    if min(gvals) < 8:
        raise ValueError(
            "SPACX requires n_gateways >= 8 (one 8-gateway cluster minimum; "
            "fewer means zero clusters and zero bandwidth)")


@dataclasses.dataclass(frozen=True)
class SweepGrid:
    """A flattened cartesian parameter grid (struct-of-arrays columns).

    axis order: ("topology", *axes) — `shape` follows it, every column and
    `topo_id` is raveled to length `n = prod(shape)`.
    """

    topologies: Tuple[str, ...]
    axes: Dict[str, Tuple[float, ...]]
    cols: Dict[str, np.ndarray]
    topo_id: np.ndarray
    shape: Tuple[int, ...]

    @property
    def n(self) -> int:
        return int(self.topo_id.size)

    @functools.cached_property
    def topo_masks(self) -> Tuple[np.ndarray, ...]:
        """Per-topology boolean row masks, computed once per grid object and
        reused by every `network_columns` call on it (cached_property writes
        to the instance __dict__, bypassing the frozen-dataclass setattr)."""
        return tuple(self.topo_id == ti for ti in range(len(self.topologies)))

    def row_params(self, i: int) -> NetworkParams:
        kw = {}
        for name in PARAM_FIELDS:
            v = self.cols[name][i]
            kw[name] = int(v) if name in _INT_PARAM_FIELDS else float(v)
        return NetworkParams(**kw)

    def row_devices(self, i: int,
                    base: Optional[DeviceLibrary] = None) -> DeviceLibrary:
        base = base or DEFAULT_DEVICES
        swept = {k: float(self.cols[k][i]) for k in self.axes if "." in k}
        return replace_device_leaves(base, swept) if swept else base

    def row_topology(self, i: int) -> str:
        return self.topologies[int(self.topo_id[i])]


def build_grid(
    topologies: Sequence[str] = DEFAULT_TOPOLOGIES,
    devices: Optional[DeviceLibrary] = None,
    **axes: Sequence[float],
) -> SweepGrid:
    """Cartesian product of `topologies` x every keyword axis.

    Axis names may be NetworkParams fields (``n_gateways=(16, 32, 64)``),
    dotted DeviceLibrary leaves (``mzi.insertion_loss_db`` — pass via a dict
    expansion since dots aren't identifiers: ``**{"mzi.insertion_loss_db":
    (1.0, 2.0)}``), or ``n_subnetworks`` (TRINE K override; 0 = bandwidth-
    matched auto).  Unswept columns take their NetworkParams/DeviceLibrary
    defaults.
    """
    spec = grid_spec(topologies, devices=devices, **axes)
    cols, topo_id = spec.chunk_cols(0, spec.n)
    return SweepGrid(topologies=spec.topologies, axes=spec.axes,
                     cols=cols, topo_id=topo_id, shape=spec.shape)


def _network_columns_arrays(cols: Mapping[str, np.ndarray],
                            topo_id: np.ndarray,
                            topologies: Sequence[str],
                            masks: Optional[Sequence[np.ndarray]] = None,
                            ) -> Dict[str, np.ndarray]:
    """Struct-of-arrays NetworkModel fields for (cols, topo_id) rows (host
    numpy reference path).  `masks` short-circuits the per-topology row-mask
    computation with precomputed masks (see `SweepGrid.topo_masks`)."""
    out = {f: np.zeros(topo_id.size, np.float64) for f in MODEL_FIELDS}
    for ti, name in enumerate(topologies):
        mask = masks[ti] if masks is not None else topo_id == ti
        if not mask.any():
            continue  # chunk windows may not contain every topology
        sub = {k: v[mask] for k, v in cols.items()}
        fields = TOPOLOGY_ARRAYS[name](sub)
        for f in MODEL_FIELDS:
            out[f][mask] = fields[f]
    return out


def network_columns(grid: SweepGrid, device="cuda") -> Dict[str, np.ndarray]:
    """Struct-of-arrays NetworkModel fields for every grid row, computed on
    `device` by the same per-topology masked evaluation as the host path
    (each topology kernel on its own rows), returned as host float64.  The
    SPACX gateway check runs first, on the host, as the numpy kernel's
    would."""
    dev = require_device(device)
    xp = TorchNS(dev)
    for ti, name in enumerate(grid.topologies):
        if name == "spacx" and np.any(grid.cols["n_gateways"][grid.topo_masks[ti]] < 8):
            raise ValueError("SPACX requires n_gateways >= 8 (one full cluster); "
                             "smaller values would leave zero usable waveguides")
    cols = {k: xp.asarray(v) for k, v in grid.cols.items()}
    out = {f: torch.zeros(grid.n, dtype=torch.float64, device=dev)
           for f in MODEL_FIELDS}
    for ti, name in enumerate(grid.topologies):
        host_mask = grid.topo_masks[ti]
        if not host_mask.any():
            continue
        mask = torch.as_tensor(host_mask, device=dev)
        fields = TOPOLOGY_ARRAYS[name]({k: v[mask] for k, v in cols.items()}, xp)
        for f in MODEL_FIELDS:
            out[f][mask] = fields[f]
    return {k: v.cpu().numpy() for k, v in out.items()}


# --------------------------------------------------------------------------
# Batched evaluation on a device
# --------------------------------------------------------------------------

# the metric math itself lives in core.power.eval_network_math (shared with
# the co-design accelerator kernel); this module owns the decode, selection,
# fault and streaming machinery around it


def _to_host(out: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in out.items()}


def evaluate_columns(
    nets: Mapping[str, np.ndarray],
    cols: Mapping[str, np.ndarray],
    total_bits,
    n_transfers,
    active_fraction=1.0,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Run the batched evaluator on `device` over struct-of-arrays
    NetworkModel fields.  `total_bits` / `n_transfers` / `active_fraction`
    broadcast against the config axis (e.g. shape (W, 1) traffic x (N,)
    configs -> (W, N) metrics).  Always evaluates in float64."""
    xp = TorchNS(require_device(device))
    nets_t = {k: xp.asarray(nets[k]) for k in MODEL_FIELDS}
    dev_t = {k: xp.asarray(cols[k]) for k in _EVAL_DEVICE_FIELDS}
    out = eval_math(nets_t, dev_t, xp.asarray(total_bits),
                    xp.asarray(n_transfers), xp.asarray(active_fraction))
    # static-only metrics (laser, trimming) don't see the traffic operands;
    # broadcast everything to the full (traffic x config) result shape
    return broadcast_metrics(_to_host(out), np)


# ---- the universal evaluation ---------------------------------------------
#
# Bitwise reproducibility across execution modes pins the operation sequence:
# `sweep` (full shape), host-materialized chunks and device-decoded chunks
# all go through `_engine`, which runs every topology kernel on every lane
# and selects by `topo_id`.  The mixed-radix decode is separate and exact
# (integer strides and gathers), so its columns are bit-identical to
# `GridSpec.chunk_cols`.


def _select(cols, topo_id, topologies, xp, scenario=None, n_gateways=None):
    """Every topology kernel on every lane, `topo_id` selecting — the device
    mirror of `_network_columns_arrays`' masking.  With a `scenario`, each
    topology's fields are derated by the survival algebra."""
    if scenario is not None:
        from repro_torch.core import faults as _faults  # runtime: cycle
    nets = None
    for ti, name in enumerate(topologies):
        fields = TOPOLOGY_ARRAYS[name](cols, xp)
        if scenario is not None:
            fields = _faults._degrade_fields(fields, n_gateways, scenario,
                                             name, xp)
        sel = topo_id == ti
        if nets is None:
            nets = {f: torch.where(sel, fields[f], torch.zeros_like(fields[f]))
                    for f in MODEL_FIELDS}
        else:
            nets = {f: torch.where(sel, fields[f], nets[f])
                    for f in MODEL_FIELDS}
    return nets


def _engine(cols, topo_id, scen, bits, xfers, frac, topologies, xp):
    """The universal chunk evaluation: (cols, topo_id, scenario, bits,
    xfers, frac) -> (nets, metrics), every metric at its natural broadcast
    shape.  The fault algebra is always on, with the six scenario fields as
    tensor inputs: a healthy scenario feeds exact IEEE identities (x + 0.0,
    x * 1.0, banks/banks), so plain and faulted-healthy sweeps are bitwise
    equal through this one sequence of operations."""
    from repro_torch.core import faults as _faults  # runtime: cycle
    scenario = _faults.FaultScenario(**scen)
    dcols = _faults.degrade_device_columns(cols, scenario, xp)
    nets = _select(dcols, topo_id, topologies, xp, scenario,
                   cols["n_gateways"])
    dev = {k: dcols[k] for k in _EVAL_DEVICE_FIELDS}
    return nets, eval_math(nets, dev, bits, xfers, frac)


def _nets_program(cols, topo_id, topologies, xp):
    """Healthy network columns on the device: (nets,
    mem_bw_bytes_per_s_total), without the fault algebra — the co-design
    search's network builder; `network_columns_device` exposes the nets to
    host callers."""
    nets = _select(cols, topo_id, topologies, xp)
    return nets, cols["n_mem_chiplets"] * cols["mem_bw_bytes_per_s"]


def network_columns_device(cols: Mapping[str, np.ndarray],
                           topo_id: np.ndarray,
                           topologies: Sequence[str],
                           device="cuda",
                           as_numpy: bool = True,
                           ) -> Dict[str, np.ndarray]:
    """Device-path network columns as host float64 — the analog of
    `_network_columns_arrays` through the selection the streaming engines
    use (numpy's and torch's transcendentals may differ in the last ulp, so
    exact-front comparisons against the engine build their reference nets
    here, not on the numpy path).  With ``as_numpy=False`` the columns stay
    float64 tensors on `device` (`cols` may already be tensors there), for
    `accelerator.evaluate_accelerator_grid` to take with no host
    round-trip."""
    xp = TorchNS(require_device(device))
    cols_t = {k: xp.asarray(v) for k, v in cols.items()}
    topo_t = torch.as_tensor(np.asarray(topo_id, np.int64), device=xp.device)
    nets, _ = _nets_program(cols_t, topo_t, tuple(topologies), xp)
    return _to_host(nets) if as_numpy else nets


def _scenario_inputs(xp, scenario=None) -> Dict[str, torch.Tensor]:
    """The six fault-scenario operands as float64 tensors on the device
    (healthy identity values when None)."""
    from repro_torch.core.faults import _SCENARIO_FIELDS, HEALTHY  # runtime: cycle
    s = HEALTHY if scenario is None else scenario
    return {f: xp.asarray(getattr(s, f)) for f in _SCENARIO_FIELDS}


def _decode(spec: GridSpec, chunk: int, tables, base, start: int, device):
    """Mixed-radix decode on the device: (axis tables, base scalars, start)
    -> (cols, topo_id) for flat rows [start, start+chunk), clamped to the
    last row — exactly `chunk_cols`' repeat-last-row padding.  Integer
    strides and gathers are exact, so the decoded columns are bit-identical
    to the host reference."""
    shape = spec.shape
    n = spec.n
    strides = tuple(int(np.prod(shape[i + 1:], dtype=np.int64))
                    for i in range(len(shape)))
    idx = torch.clamp(torch.arange(start, start + chunk, dtype=torch.int64,
                                   device=device), max=n - 1)
    cols = {name: v.expand(chunk) for name, v in base.items()}
    for ai, name in enumerate(spec.axes):
        digit = torch.remainder(torch.div(idx, strides[1 + ai],
                                          rounding_mode="floor"), shape[1 + ai])
        cols[name] = tables[name][digit]
    return cols, torch.div(idx, strides[0], rounding_mode="floor")


# --------------------------------------------------------------------------
# Top-level sweep API
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Metrics + model fields for every grid point (flat, length grid.n)."""

    grid: SweepGrid
    nets: Dict[str, np.ndarray]
    metrics: Dict[str, np.ndarray]

    def metric(self, name: str) -> np.ndarray:
        """One metric reshaped to the grid's (topology, *axes) shape."""
        return self.metrics[name].reshape(self.grid.shape)

    def config_at(self, i: int) -> Dict[str, float]:
        """Human-readable swept-axis settings of flat row `i`."""
        out: Dict[str, float] = {"topology": self.grid.row_topology(i)}
        for name in self.grid.axes:
            out[name] = float(self.grid.cols[name][i])
        return out

    def best(self, name: str = "energy_j") -> Tuple[int, Dict[str, float]]:
        """(flat index, swept-axis settings) of the metric's minimizer."""
        i = int(np.argmin(self.metrics[name]))
        return i, self.config_at(i)

    def model_at(self, i: int):
        """Scalar NetworkModel dataclass view of flat row `i`."""
        key = self.grid.row_topology(i)
        name = {"sprint": "SPRINT", "spacx": "SPACX", "tree": "Tree",
                "elec": "ElecMesh"}.get(key)
        if name is None:  # trine carries its subnetwork count
            name = f"TRINE-{int(self.nets['n_laser_banks'][i])}"
        return model_from_row(self.nets, name, i=i)


def sweep(
    traffic: Traffic,
    topologies: Sequence[str] = DEFAULT_TOPOLOGIES,
    devices: Optional[DeviceLibrary] = None,
    active_fraction: float = 1.0,
    device="cuda",
    **axes: Sequence[float],
) -> SweepResult:
    """Evaluate one workload's traffic over a full configuration grid.

    `nets` stays on the host numpy reference path (exact dataclass
    round-trips via `model_at`); the metrics run on `device` through the
    same universal evaluation the streaming paths use, at the full grid
    shape — which is what makes chunked results bit-identical to this
    monolithic call."""
    xp = TorchNS(require_device(device))
    grid = build_grid(topologies, devices=devices, **axes)
    # host reference (also validates, eagerly)
    nets = _network_columns_arrays(grid.cols, grid.topo_id, grid.topologies,
                                   masks=grid.topo_masks)
    cols_t = {k: xp.asarray(v) for k, v in grid.cols.items()}
    topo_t = torch.as_tensor(grid.topo_id, device=xp.device)
    _, mets = _engine(cols_t, topo_t, _scenario_inputs(xp),
                      xp.asarray(traffic.total_bits),
                      xp.asarray(traffic.n_transfers),
                      xp.asarray(active_fraction), grid.topologies, xp)
    metrics = broadcast_metrics(_to_host(mets), np)
    return SweepResult(grid=grid, nets=nets, metrics=metrics)


# --------------------------------------------------------------------------
# Chunked streaming evaluation (bounded memory for 1e7-point grids)
# --------------------------------------------------------------------------


def _traffic_arrays(traffic) -> Tuple[np.ndarray, np.ndarray]:
    """(total_bits, n_transfers) operands: scalar for one Traffic, (W, 1)
    columns for a sequence of workload traffics (broadcast against configs)."""
    if isinstance(traffic, Traffic):
        return np.float64(traffic.total_bits), np.float64(traffic.n_transfers)
    ts = list(traffic)
    bits = np.asarray([[t.total_bits] for t in ts], np.float64)
    xfers = np.asarray([[t.n_transfers] for t in ts], np.float64)
    return bits, xfers


@dataclasses.dataclass(frozen=True)
class SweepChunk:
    """One evaluated grid window [start, stop): metrics (and model fields)
    for those rows only, as host numpy arrays.  `metrics` values have shape
    (..., stop-start) — a leading workload axis appears when the sweep
    batches traffics."""

    spec: GridSpec
    start: int
    stop: int
    topo_id: np.ndarray
    nets: Dict[str, np.ndarray]
    metrics: Dict[str, np.ndarray]

    @property
    def indices(self) -> np.ndarray:
        """Flat grid row indices of this chunk."""
        return np.arange(self.start, self.stop)


class ChunkReducer:
    """Associative fold over SweepChunks.  Implementations hold only running
    reductions (argmin scalars, Pareto fronts, histograms ...) so streaming
    sweeps stay O(chunk_size) regardless of grid size."""

    def init(self, spec: GridSpec):
        return None

    def step(self, carry, chunk: SweepChunk):
        raise NotImplementedError

    def finish(self, carry, spec: GridSpec):
        return carry


class MinReducer(ChunkReducer):
    """Running argmin of one metric — the bounded-memory `SweepResult.best`.
    Tracks per-workload minima when the sweep batches traffics.  Ties go to
    the lowest flat index, as `np.argmin` does over the whole grid."""

    def __init__(self, metric: str = "energy_j"):
        self.metric = metric

    def step(self, carry, chunk: SweepChunk):
        m = chunk.metrics[self.metric]
        j = np.argmin(m, axis=-1)
        v = np.take_along_axis(m, j[..., None], -1)[..., 0]
        i = chunk.start + j
        if carry is None:
            return v, i
        best_v, best_i = carry
        upd = v < best_v
        return np.where(upd, v, best_v), np.where(upd, i, best_i)

    def finish(self, carry, spec: GridSpec):
        if carry is None:
            raise ValueError("empty sweep")
        v, i = carry
        if np.ndim(i) == 0:
            return {"value": float(v), "index": int(i),
                    "config": spec.config_at(int(i))}
        flat_i = np.asarray(i).ravel()
        return {"value": np.asarray(v), "index": np.asarray(i),
                "config": [spec.config_at(int(k)) for k in flat_i]}


def _config_mesh(device_type: str):
    """A 1-D mesh ``("configs",)`` over the default process group when one
    is initialized with more than one rank (the scale-out hook for grids
    past one device); None in one process or at world size 1."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() <= 1:
        return None
    from repro_torch.launch.mesh import _make  # runtime: launch sits above core

    return _make((dist.get_world_size(),), ("configs",), device_type)


def _gather_lanes(mesh, *parts: Mapping[str, torch.Tensor]):
    """Every rank's float64 tensors (each (..., lanes)) in the dicts
    `parts`, as host arrays (..., W * lanes) in rank order, one dict for
    each: one all-gather of them all packed as (rows, lanes), on the device
    under NCCL, on the host otherwise (gloo)."""
    import torch.distributed as dist

    group, world = mesh.get_group(), mesh.size()
    tensors = [v for d in parts for v in d.values()]
    packed = torch.cat([v.reshape(-1, v.shape[-1]) for v in tensors]).contiguous()
    if dist.get_backend(group) == "nccl":
        out = packed.new_empty((world,) + tuple(packed.shape))
        dist.all_gather_into_tensor(out, packed, group=group)
        out = out.cpu()
    else:
        packed = packed.cpu()
        bufs = [torch.empty_like(packed) for _ in range(world)]
        dist.all_gather(bufs, packed, group=group)
        out = torch.stack(bufs)
    whole = out.permute(1, 0, 2).reshape(packed.shape[0], -1).numpy()
    res, row = [], 0
    for d in parts:
        res.append({})
        for k, v in d.items():
            rows = v[..., 0].numel()
            res[-1][k] = whole[row:row + rows].reshape(tuple(v.shape[:-1]) + (-1,))
            row += rows
    return res


def _run_pipeline(starts, make_task, fold, depth: int) -> None:
    """Double-buffered chunk pipeline: at most `depth` chunk tasks in flight
    beyond the one being folded, folds strictly in submission order (so any
    depth — including 0, the inline serial schedule — produces bit-identical
    reducer states).  Tasks run on one worker thread; torch releases the
    interpreter lock while the card computes and copies, so the main
    thread's reducer folds overlap the next chunk's compute.  Single-chunk
    grids run inline: there is nothing to overlap, and worker-thread startup
    would only add latency."""
    starts = list(starts)
    if depth <= 0 or len(starts) <= 1:
        for start in starts:
            fold(make_task(start)())
        return
    pending = deque()
    with ThreadPoolExecutor(max_workers=1) as ex:
        for start in starts:
            pending.append(ex.submit(make_task(start)))
            while len(pending) > depth:
                fold(pending.popleft().result())
        while pending:
            fold(pending.popleft().result())


def sweep_chunked(
    traffic,
    reducer: ChunkReducer,
    topologies: Sequence[str] = DEFAULT_TOPOLOGIES,
    devices: Optional[DeviceLibrary] = None,
    active_fraction: float = 1.0,
    chunk_size: int = 65536,
    shard: bool = False,
    columns_fn=None,
    materialize: str = "auto",
    prefetch: Optional[int] = None,
    device="cuda",
    **axes: Sequence[float],
):
    """Stream a configuration grid through the universal evaluation on
    `device` in fixed-size chunks, folding each chunk into `reducer` and
    keeping nothing else.

    Every chunk has exactly `chunk_size` columns (the last one is padded by
    clamping the decode at the final row — repeat-last-row — then sliced
    back); peak memory is O(chunk_size * n_columns), independent of grid
    size.  `traffic` may be one Traffic or a sequence (per-workload metric
    rows).

    `materialize` picks where chunk columns come from:
      * "device" — the mixed-radix decode generates the chunk on the device
        from the `start` scalar and small axis tables: no per-chunk host
        numpy, no per-chunk column copy to the device.
      * "host"   — `GridSpec.chunk_cols` builds the columns on the host and
        ships them (the serial reference layout).
      * "auto"   — "device" unless ``shard=True`` or a legacy `columns_fn`
        requires host columns.
    Both modes feed the same evaluation, so reducer folds are bit-identical
    between them.  Each chunk's results come back to the host inside its
    task, so reducers see numpy arrays.

    ``shard=True`` under a process group of W > 1 ranks (`_config_mesh`)
    rounds `chunk_size` up to a multiple of W; each rank evaluates its
    contiguous chunk_size / W lanes of the host columns on `device` ("cuda"
    is the rank's current card) and the fold gathers the lanes back in rank
    order, so that every rank returns the same result, bit for bit the one
    of world size 1.  Every rank must make the same call.

    `prefetch` (default: the REPRO_PREFETCH env flag, 2) chunks may be in
    flight ahead of the reducer fold; folds happen in chunk order, so every
    depth produces bit-identical reducer states.

    `columns_fn` hooks fault injection.  A scenario-carrying hook from
    `faults.faulted_columns_fn(scenario)` composes on the device: the
    scenario fields become tensor inputs of the evaluation (its numpy
    __call__ stays available as the host reference).  Any other callable
    ``columns_fn(cols, topo_id, topologies) -> (nets, dev_cols)`` runs
    legacy-style on host-materialized columns, whose returned columns may
    carry a leading scenario axis ((S, chunk)).  The reference's config-axis
    sharding assumes 1-D columns and takes no batched `columns_fn`; here
    the lanes are cut on the last axis, the scenario's inputs go to every
    rank whole.
    """
    xp = TorchNS(require_device(device))
    spec = grid_spec(topologies, devices=devices, **axes)
    n = spec.n
    if n == 0:
        raise ValueError("empty grid")
    _validate_grid_values(spec)

    scenario = getattr(columns_fn, "scenario", None)
    legacy_fn = columns_fn is not None and scenario is None

    if materialize not in ("auto", "host", "device"):
        raise ValueError(f"materialize must be 'auto', 'host', or 'device', "
                         f"got {materialize!r}")
    if materialize == "auto":
        materialize = "host" if (shard or legacy_fn) else "device"
    elif materialize == "device" and (shard or legacy_fn):
        # sharded layouts and legacy hooks consume host-built columns
        materialize = "host"

    depth = prefetch_depth() if prefetch is None else max(0, int(prefetch))
    mesh = _config_mesh(xp.device.type) if shard else None
    chunk_size = int(min(max(1, chunk_size), n))
    if mesh is not None:
        if xp.device.type == "cuda" and xp.device.index is None:
            # the chunk tasks run on a worker thread: pin the rank's card
            xp = TorchNS(torch.device("cuda", torch.cuda.current_device()))
        world = mesh.size()
        chunk_size = -(-chunk_size // world) * world
        lanes = chunk_size // world
        mine = slice(mesh.get_local_rank() * lanes, (mesh.get_local_rank() + 1) * lanes)

    def lanes_of(v):  # this rank's lanes of a host column (all without a mesh)
        return v if mesh is None else np.asarray(v)[..., mine]

    bits, xfers = _traffic_arrays(traffic)
    bits_t, xfers_t = xp.asarray(bits), xp.asarray(xfers)
    frac_t = xp.asarray(active_fraction)
    scen_t = None if legacy_fn else _scenario_inputs(xp, scenario)
    if materialize == "device":
        tables_t = {k: xp.asarray(np.asarray(v, np.float64))
                    for k, v in spec.axes.items()}
        base_t = {k: xp.asarray(v) for k, v in spec.base.items()}

    def _host_chunk(start, stop):
        cols, topo_id = spec.chunk_cols(start, stop)
        pad = chunk_size - (stop - start)
        if pad:  # repeat the last (valid) row; padded lanes are sliced off
            cols = {k: np.concatenate([v, np.repeat(v[-1:], pad)])
                    for k, v in cols.items()}
            topo_id = np.concatenate([topo_id, np.repeat(topo_id[-1:], pad)])
        return cols, topo_id

    def make_task(start):
        stop = min(start + chunk_size, n)

        def task():
            if legacy_fn:
                cols, topo_id = _host_chunk(start, stop)
                nets, dev_cols = columns_fn(cols, topo_id, spec.topologies)
                mets = eval_math({k: xp.asarray(lanes_of(nets[k])) for k in MODEL_FIELDS},
                                 {k: xp.asarray(lanes_of(dev_cols[k]))
                                  for k in _EVAL_DEVICE_FIELDS},
                                 bits_t, xfers_t, frac_t)
                nets = {k: np.asarray(v, np.float64) for k, v in nets.items()}
                return (start, stop, topo_id, nets,
                        mets if mesh is not None else _to_host(mets))
            if materialize == "host":
                cols, topo_id = _host_chunk(start, stop)
                cols = {k: xp.asarray(lanes_of(v)) for k, v in cols.items()}
                topo_t = torch.as_tensor(lanes_of(topo_id), device=xp.device)
            else:  # device-resident materialization: start scalar only
                cols, topo_t = _decode(spec, chunk_size, tables_t, base_t,
                                       start, xp.device)
            nets, mets = _engine(cols, topo_t, scen_t, bits_t, xfers_t,
                                 frac_t, spec.topologies, xp)
            if mesh is not None:  # this rank's lanes; the fold gathers them
                return start, stop, topo_id, nets, mets
            return (start, stop, topo_t.cpu().numpy(), _to_host(nets),
                    _to_host(mets))
        return task

    carry = reducer.init(spec)

    def fold(result):
        nonlocal carry
        start, stop, topo_id, nets, mets = result
        if mesh is not None and legacy_fn:  # every rank's lanes, in rank order
            mets, = _gather_lanes(mesh, mets)
        elif mesh is not None:
            nets, mets = _gather_lanes(mesh, nets, mets)
        valid = stop - start
        out = {k: v[..., :valid] for k, v in broadcast_metrics(mets, np).items()}
        nets = {k: v[..., :valid] for k, v in nets.items()}
        carry = reducer.step(carry, SweepChunk(
            spec=spec, start=start, stop=stop, topo_id=topo_id[:valid],
            nets=nets, metrics=out))

    _run_pipeline(range(0, n, chunk_size), make_task, fold, depth)
    return reducer.finish(carry, spec)


def sweep_scalar_reference(
    traffic: Traffic,
    topologies: Sequence[str] = DEFAULT_TOPOLOGIES,
    devices: Optional[DeviceLibrary] = None,
    active_fraction: float = 1.0,
    **axes: Sequence[float],
) -> Dict[str, np.ndarray]:
    """Golden reference: the identical grid walked through the scalar
    dataclass path (`NetworkParams` -> topology factory -> `evaluate_network`)
    one configuration per Python call, on the host.  Returns the same metric
    columns as `sweep(...).metrics`."""
    grid = build_grid(topologies, devices=devices, **axes)
    base = devices or DEFAULT_DEVICES
    out = {k: np.zeros(grid.n, np.float64) for k in METRIC_FIELDS}
    for i in range(grid.n):
        p = grid.row_params(i)
        d = grid.row_devices(i, base)
        name = grid.row_topology(i)
        if name == "trine":
            k = int(grid.cols["n_subnetworks"][i])
            net = TOPOLOGIES[name](p, n_subnetworks=k or None, d=d)
        else:
            net = TOPOLOGIES[name](p, d=d)
        rep = evaluate_network(net, traffic, d, active_fraction=active_fraction)
        for key in METRIC_FIELDS:
            out[key][i] = getattr(rep, key)
    return out


# `evaluate_accelerator_batch` (the Fig. 6 path) is one (mix, config) cell of
# the co-design grid kernel in core.accelerator, re-exported here (via the
# import at the top) as the reference does.
