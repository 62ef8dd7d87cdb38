"""Interposer network topologies: SPRINT/SPACX-style buses, Tree, TRINE, and
the electrical-mesh baseline ([21]).

Each topology reduces to a small set of quantities the power/latency models
consume:

  worst_path_loss_db   worst-case optical loss writer->reader (laser sizing)
  n_wavelengths        total active wavelengths (laser count)
  n_mr                 total microrings (trimming power)
  n_mzi                total MZI switches (static power, area)
  n_stages             switch stages on a path (reconfig latency, loss)
  aggregate_bw_bps     raw network bandwidth memory<->compute
  effective_bw_bps     after arbitration/contention derating (buses) --
                       switched trees are circuit-scheduled and keep raw BW
  per_transfer_s       fixed per-transfer overhead (arbitration or switching)

Geometry: gateways sit on an interposer of `interposer_side_cm`; bus
waveguides traverse the full perimeter, trees span half a side per stage.

Structure of this module (the vectorized sweep engine's foundation): every
topology is implemented once as a **columnar kernel** (`*_arrays`) that maps a
struct-of-arrays column dict — NetworkParams fields plus dotted DeviceLibrary
leaves, any of which may be a full grid axis — to struct-of-arrays
NetworkModel fields, elementwise in float64 numpy.  The scalar dataclass
constructors (`sprint_bus(p, d)` etc.) are thin batch-of-one wrappers kept for
existing callers; `core.sweep` drives the same kernels over 10k+ configs at
once.

Every columnar kernel takes an `xp` namespace argument (numpy by default,
a `core.xp.TorchNS` for float64 tensors on a device): on tensors the whole
topology -> metrics chain is differentiable in the continuous columns
(losses, rates, bandwidths, interposer geometry), which gradient-based
refinement of Pareto points relies on.  Discrete quantities (ceil/floor/round
stage and subnetwork counts) are piecewise-constant and contribute zero
gradient, as intended.  This is the port's counterpart of the JAX package's
`core/topology.py`; the kernels are written once for both namespaces.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np

from repro_torch.core.devices import DeviceLibrary, DEFAULT_DEVICES, device_columns
from repro_torch.core.planner import ceil_log2, choose_subnetworks_arr


@dataclasses.dataclass(frozen=True)
class NetworkParams:
    """Shared sizing for all topologies (paper Sec. IV evaluation setup)."""

    n_gateways: int = 32              # gateways on compute chiplets
    n_mem_chiplets: int = 1   # TRINE eval: one 100GB/s memory interface; 2.5D accel uses 4
    mem_bw_bytes_per_s: float = 100e9  # 100 GB/s per memory chiplet (microbump-limited)
    n_lambda: int = 8                 # WDM wavelengths per waveguide
    modulation_rate_bps: float = 12e9  # 12 GHz modulation
    gateway_rate_hz: float = 2e9      # 2 GHz gateway (serialization endpoint)
    gateway_width_bits: int = 64
    interposer_side_cm: float = 4.0


PARAM_FIELDS = tuple(f.name for f in dataclasses.fields(NetworkParams))

# NetworkModel numeric fields, in the order the columnar kernels emit them
MODEL_FIELDS = (
    "worst_path_loss_db", "n_wavelengths", "n_mr", "n_mzi", "n_stages",
    "aggregate_bw_bps", "effective_bw_bps", "per_transfer_s",
    "n_laser_banks", "is_electrical", "avg_hops", "n_routers",
)


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    name: str
    worst_path_loss_db: float
    n_wavelengths: int
    n_mr: int
    n_mzi: int
    n_stages: int
    aggregate_bw_bps: float
    effective_bw_bps: float
    per_transfer_s: float
    n_laser_banks: int = 1
    is_electrical: bool = False
    # electrical-only fields
    avg_hops: float = 0.0
    n_routers: int = 0


# --------------------------------------------------------------------------
# Columnar kernels (struct-of-arrays; elementwise float64)
# --------------------------------------------------------------------------

ColumnMap = Mapping[str, np.ndarray]


def _asx(xp, v):
    """Coerce to the kernel namespace: float64 for numpy (the analytical layer
    is 64-bit host math) and float64 tensors for the torch namespace."""
    return np.asarray(v, np.float64) if xp is np else xp.asarray(v)


def params_columns(p: NetworkParams, d: Optional[DeviceLibrary] = None,
                   n_subnetworks: int = 0) -> Dict[str, np.ndarray]:
    """Batch-of-one column dict for a scalar (params, devices) pair.

    `n_subnetworks` is the TRINE K override; 0 means "auto" (bandwidth-match
    via the planner), matching `trine_network(p, n_subnetworks=None)`.
    """
    cols = {name: np.float64(getattr(p, name)) for name in PARAM_FIELDS}
    for key, val in device_columns(d or DEFAULT_DEVICES).items():
        cols[key] = np.float64(val)
    cols["n_subnetworks"] = np.float64(n_subnetworks)
    return cols


def _fields(xp=np, **kw) -> Dict[str, np.ndarray]:
    """Assemble a MODEL_FIELDS dict, zero-filling the ones not given and
    broadcasting everything to a common shape."""
    out = {name: _asx(xp, kw.get(name, 0.0)) for name in MODEL_FIELDS}
    shape = np.broadcast_shapes(*(v.shape for v in out.values()))
    return {k: xp.broadcast_to(v, shape) for k, v in out.items()}


def _waveguide_bw_arr(c: ColumnMap):
    """One waveguide carries n_lambda * modulation rate, but the endpoints can
    only source/sink at the gateway rate (the paper's 12 GHz modulator vs
    2 GHz gateway mismatch): a single gateway saturates at gw_rate*width."""
    return c["n_lambda"] * c["modulation_rate_bps"]


def _bus_contention_derate_arr(writers_per_waveguide, xp=np):
    """Shared-medium (MWMR) arbitration derating.  Token-slot arbitration
    wastes slots as the writer population grows; switched (circuit) networks
    do not pay this.  Calibrated so a 32-writer bus runs near ~40% utilization
    (SPRINT-class reported network utilizations)."""
    return 1.0 / (1.0 + 0.05 * xp.maximum(0.0, writers_per_waveguide - 1.0))


def sprint_bus_arrays(c: ColumnMap, xp=np) -> Dict[str, np.ndarray]:
    """SPRINT [14]: MWMR bus -- every gateway's modulators+filters sit on every
    waveguide, so a signal's worst-case path passes (G-1) gateways' 2*n_lambda
    rings.  8 parallel waveguides to make aggregate BW comparable."""
    n_wg = 8.0
    g = c["n_gateways"]
    through = (g - 1) * 2 * c["n_lambda"] * c["mr.through_loss_db"]
    prop = 4 * c["interposer_side_cm"] * c["wg.propagation_loss_db_per_cm"]  # full perimeter
    loss = through + prop + c["mr.drop_loss_db"] + c["mr.modulation_loss_db"]
    raw = n_wg * _waveguide_bw_arr(c)
    return _fields(
        xp,
        worst_path_loss_db=loss,
        n_wavelengths=n_wg * c["n_lambda"],
        n_mr=(g + c["n_mem_chiplets"]) * 2 * c["n_lambda"] * 2,  # R+W sets on 2 waveguides each
        aggregate_bw_bps=raw,
        effective_bw_bps=raw * _bus_contention_derate_arr(g, xp),
        per_transfer_s=xp.full_like(loss, 12e-9),  # MWMR token arbitration
        n_laser_banks=xp.full_like(loss, n_wg),
    )


def spacx_bus_arrays(c: ColumnMap, xp=np) -> Dict[str, np.ndarray]:
    """SPACX [15]: wavelength/cluster-partitioned bus -- gateways are grouped
    into clusters of 8, each cluster on its own shorter waveguide segment, so
    fewer rings sit on any path (lower loss than SPRINT) at the cost of fewer
    concurrently-usable wavelengths (BW partitioned by cluster)."""
    cluster = 8.0
    if xp is np and np.any(np.asarray(c["n_gateways"]) < cluster):
        # data-dependent validation only on the host (numpy) path; on the
        # device the caller validates the grid eagerly (no per-row raise)
        raise ValueError("SPACX requires n_gateways >= 8 (one full cluster); "
                         "smaller values would leave zero usable waveguides")
    n_clusters = xp.floor(c["n_gateways"] / cluster)
    through = (cluster - 1) * 2 * c["n_lambda"] * c["mr.through_loss_db"]
    prop = 1.5 * c["interposer_side_cm"] * c["wg.propagation_loss_db_per_cm"]
    loss = through + prop + c["mr.drop_loss_db"] + c["mr.modulation_loss_db"]
    raw = n_clusters * _waveguide_bw_arr(c)
    return _fields(
        xp,
        worst_path_loss_db=loss,
        n_wavelengths=n_clusters * c["n_lambda"],
        n_mr=(c["n_gateways"] * 2 * c["n_lambda"]
              + c["n_mem_chiplets"] * 2 * c["n_lambda"] * n_clusters),
        aggregate_bw_bps=raw,
        effective_bw_bps=raw * _bus_contention_derate_arr(
            xp.full_like(loss, cluster), xp),
        per_transfer_s=xp.full_like(loss, 8e-9),
        n_laser_banks=n_clusters,
    )


def tree_network_arrays(c: ColumnMap, xp=np) -> Dict[str, np.ndarray]:
    """Single switched tree (paper Fig. 3b): all G gateways under one binary
    tree of broadband MZIs.  Stage count ceil(log2 G) (=5 for 32 gateways, as
    the paper states); memory BW restricted to ONE waveguide's bandwidth."""
    g = c["n_gateways"]
    # exact stage count: a ceil(log2(.)) can overshoot at powers of two
    stages = ceil_log2(g, xp)
    prop = (c["interposer_side_cm"] / 2) * c["wg.propagation_loss_db_per_cm"]
    loss = (stages * c["mzi.insertion_loss_db"] + prop
            + c["mr.drop_loss_db"] + c["mr.modulation_loss_db"])
    raw = _waveguide_bw_arr(c)  # ONE waveguide -- the paper's stated limitation
    return _fields(
        xp,
        worst_path_loss_db=loss,
        n_wavelengths=c["n_lambda"],
        n_mr=(g + c["n_mem_chiplets"]) * 2 * c["n_lambda"],
        n_mzi=g - 1,
        n_stages=stages,
        aggregate_bw_bps=raw,
        effective_bw_bps=raw,
        per_transfer_s=stages * c["mzi.switch_time_s"],
        n_laser_banks=xp.ones_like(loss),
    )


def trine_network_arrays(c: ColumnMap, xp=np) -> Dict[str, np.ndarray]:
    """TRINE [11] (paper Fig. 3c): K parallel tree subnetworks, each spanning
    G/K gateways => ceil(log2(G/K)) stages.  K chosen to match the memory
    bandwidth (planner.choose_subnetworks; =8 in the paper's setup), unless
    the "n_subnetworks" column overrides it (>0).  With G=32, K=8:
    4 gateways/subnet -> 2 stages (paper: "2 switch stages for TRINE,
    contrasting with 5 stages in the Tree")."""
    g = c["n_gateways"]
    k_auto = choose_subnetworks_arr(
        c["n_lambda"], c["modulation_rate_bps"], c["n_mem_chiplets"],
        c["mem_bw_bytes_per_s"], g, xp=xp)
    k_over = _asx(xp, c.get("n_subnetworks", 0.0))
    k = xp.where(k_over > 0, k_over, k_auto)
    per = xp.maximum(1.0, xp.floor(g / k))
    stages = xp.maximum(1.0, ceil_log2(per, xp))
    prop = (c["interposer_side_cm"] / 3) * c["wg.propagation_loss_db_per_cm"]  # shorter subnet spans
    loss = (stages * c["mzi.insertion_loss_db"] + prop
            + c["mr.drop_loss_db"] + c["mr.modulation_loss_db"])
    raw = k * _waveguide_bw_arr(c)
    # memory can only source/sink at its aggregate BW (bandwidth matching)
    raw = xp.minimum(raw, c["n_mem_chiplets"] * c["mem_bw_bytes_per_s"] * 8)
    return _fields(
        xp,
        worst_path_loss_db=loss,
        # memory side needs one modulator/filter bank per subnetwork (SWMR) +
        # each gateway keeps one set (this is why TRINE's trimming power is
        # higher than SPACX/Tree -- more total rings)
        n_mr=(g + c["n_mem_chiplets"] * k) * 2 * c["n_lambda"],
        n_wavelengths=k * c["n_lambda"],
        n_mzi=k * (per - 1),
        n_stages=stages,
        aggregate_bw_bps=raw,
        effective_bw_bps=raw,
        per_transfer_s=stages * c["mzi.switch_time_s"],
        n_laser_banks=k,
    )


def electrical_mesh_arrays(c: ColumnMap, xp=np) -> Dict[str, np.ndarray]:
    """Electrical 2D-mesh interposer NoC baseline (DeFT [21]), used by the
    2.5D-CrossLight-Elec-Interposer variant in Sec. V."""
    n = c["n_gateways"] + c["n_mem_chiplets"]
    side = xp.ceil(xp.sqrt(n))
    avg_hops = 2 * side / 3  # uniform-random average Manhattan distance
    hop_cm = c["interposer_side_cm"] / side
    per_hop_s = (c["elec.router_latency_s"]
                 + hop_cm * c["elec.wire_latency_s_per_cm"])
    bisection = side * c["elec.link_bandwidth_bps"] * 2
    # memory chiplets sit at the mesh edge with 2 usable ports each; hotspot
    # (gather/scatter to memory) saturates the mesh well below bisection
    mem_ingress = c["n_mem_chiplets"] * 2 * c["elec.link_bandwidth_bps"]
    raw = xp.minimum(bisection, mem_ingress)
    return _fields(
        xp,
        aggregate_bw_bps=raw,
        effective_bw_bps=raw * c["elec.hotspot_saturation"],
        n_stages=2 * side,
        per_transfer_s=avg_hops * per_hop_s,
        n_laser_banks=xp.ones_like(side),  # dataclass default; unused for elec
        is_electrical=xp.ones_like(side),
        avg_hops=avg_hops,
        n_routers=side * side,
    )


TOPOLOGY_ARRAYS: Dict[str, Callable[[ColumnMap], Dict[str, np.ndarray]]] = {
    "sprint": sprint_bus_arrays,
    "spacx": spacx_bus_arrays,
    "tree": tree_network_arrays,
    "trine": trine_network_arrays,
    "elec": electrical_mesh_arrays,
}


# --------------------------------------------------------------------------
# Scalar wrappers (batch-of-one over the columnar kernels)
# --------------------------------------------------------------------------


def model_from_row(f: Mapping[str, np.ndarray], name: str,
                   i=()) -> NetworkModel:
    """One NetworkModel dataclass from row `i` of struct-of-arrays fields."""
    def _f(key):
        return float(np.asarray(f[key], np.float64)[i])

    return NetworkModel(
        name=name,
        worst_path_loss_db=_f("worst_path_loss_db"),
        n_wavelengths=int(_f("n_wavelengths")),
        n_mr=int(_f("n_mr")),
        n_mzi=int(_f("n_mzi")),
        n_stages=int(_f("n_stages")),
        aggregate_bw_bps=_f("aggregate_bw_bps"),
        effective_bw_bps=_f("effective_bw_bps"),
        per_transfer_s=_f("per_transfer_s"),
        n_laser_banks=int(_f("n_laser_banks")),
        is_electrical=bool(_f("is_electrical")),
        avg_hops=_f("avg_hops"),
        n_routers=int(_f("n_routers")),
    )


def sprint_bus(p: NetworkParams, d: Optional[DeviceLibrary] = None) -> NetworkModel:
    return model_from_row(sprint_bus_arrays(params_columns(p, d)), "SPRINT")


def spacx_bus(p: NetworkParams, d: Optional[DeviceLibrary] = None) -> NetworkModel:
    return model_from_row(spacx_bus_arrays(params_columns(p, d)), "SPACX")


def tree_network(p: NetworkParams, d: Optional[DeviceLibrary] = None) -> NetworkModel:
    return model_from_row(tree_network_arrays(params_columns(p, d)), "Tree")


def trine_network(
    p: NetworkParams,
    n_subnetworks: Optional[int] = None,
    d: Optional[DeviceLibrary] = None,
) -> NetworkModel:
    cols = params_columns(p, d, n_subnetworks=n_subnetworks or 0)
    f = trine_network_arrays(cols)
    k = int(float(np.asarray(f["n_laser_banks"], np.float64)))
    return model_from_row(f, f"TRINE-{k}")


def electrical_mesh(p: NetworkParams, d: Optional[DeviceLibrary] = None) -> NetworkModel:
    return model_from_row(electrical_mesh_arrays(params_columns(p, d)), "ElecMesh")


TOPOLOGIES = {
    "sprint": sprint_bus,
    "spacx": spacx_bus,
    "tree": tree_network,
    "trine": trine_network,
    "elec": electrical_mesh,
}
