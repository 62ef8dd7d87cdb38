"""2.5D-CrossLight accelerator analytical model (paper Sec. V, Fig. 6).

Three variants, matching the paper's comparison:

  * CrossLight            — monolithic SiPh accelerator [16]: one reticle-
                            limited die, homogeneous MAC vector size, off-chip
                            DRAM bandwidth, long on-die shared photonic buses
                            (high loss -> high laser power).
  * 2.5D-CrossLight-Elec  — chiplet scale-out, electrical mesh interposer [21].
  * 2.5D-CrossLight-SiPh  — chiplet scale-out, TRINE-style photonic interposer
                            with PCMC-adaptive gateways.

Compute model: noncoherent broadcast-and-weight photonic MAC units.  A unit
with vector size V performs a V-long dot-product slice per cycle; a layer with
dot length L needs ceil(L/V) passes per dot product.  Heterogeneous chiplets
(different V per chiplet, e.g. 3x3-conv chiplets vs 7x7 vs FC) reduce the
pass count + wavelength-slot waste — one of the paper's two stated reasons
for the 2.5D win (the other being the high-bandwidth photonic interposer).

The port's counterpart of the JAX package's `core/accelerator.py`: the scalar
layer loop (`evaluate_accelerator`) is host numpy, as there; the co-design
grid (`evaluate_accelerator_grid`) runs in float64 on a device, with the
chiplet-mix axis as an explicit leading tensor axis where the reference
vmaps a jitted kernel over it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.core.devices import DeviceLibrary, DEFAULT_DEVICES, device_columns
from repro_torch.core.power import (
    EVAL_DEVICE_FIELDS,
    Traffic,
    eval_network_math,
    evaluate_network,
)
from repro_torch.core.topology import (
    MODEL_FIELDS,
    NetworkModel,
    NetworkParams,
    sprint_bus,
    trine_network,
    electrical_mesh,
)
from repro_torch.core.planner import plan_gateway_activation, plan_gateway_activation_arr
from repro_torch.core.workloads import Workload
from repro_torch.core.xp import TorchNS


@dataclasses.dataclass(frozen=True)
class ChipletSpec:
    n_units: int          # photonic MAC (VDP) units on this chiplet
    vector_size: int      # wavelengths per unit = dot-slice width


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    name: str
    chiplets: List[ChipletSpec]
    network: NetworkModel
    mem_bw_bytes_per_s: float
    mac_rate_hz: float = 5e9          # VDP issue rate (MR-modulation limited)
    lambda_slot_energy_j: float = 30e-15  # per wavelength-slot MAC energy
    adaptive_gateways: bool = False    # PCMC bandwidth adaptation (SiPh 2.5D)
    transfers_per_layer: int = 16


# AccelReport metric fields, in emission order — the accelerator-side metric
# vocabulary
ACCEL_REPORT_FIELDS = (
    "latency_s", "power_w", "energy_j", "epb_j",
    "compute_s", "network_s", "memory_s", "network_energy_j",
)


@dataclasses.dataclass(frozen=True)
class AccelReport:
    name: str
    latency_s: float
    power_w: float
    energy_j: float
    epb_j: float                       # interposer-network energy per bit
    compute_s: float
    network_s: float
    memory_s: float
    network_energy_j: float


# --------------------------------------------------------------------------
# The paper's three configurations
# --------------------------------------------------------------------------

def monolithic_crosslight(d: Optional[DeviceLibrary] = None) -> AcceleratorConfig:
    """Monolithic CrossLight: homogeneous vec=32 units; one co-packaged DRAM
    stack (~50GB/s); on-die GLB<->unit traffic rides a long MWMR photonic bus
    spanning all 32 unit clusters (SPRINT-like loss profile on a big die --
    the accumulated ring/propagation loss on the monolithic die is exactly
    why the paper's 2.5D split wins on EPB)."""
    p = NetworkParams(n_gateways=32, n_mem_chiplets=1,
                      mem_bw_bytes_per_s=50e9, interposer_side_cm=2.0)
    net = sprint_bus(p, d)
    net = dataclasses.replace(net, name="CrossLight-onchip",
                              effective_bw_bps=min(net.effective_bw_bps, 50e9 * 8))
    return AcceleratorConfig(
        name="CrossLight",
        chiplets=[ChipletSpec(n_units=512, vector_size=32)],
        network=net,
        mem_bw_bytes_per_s=50e9,
    )


def _hetero_chiplets() -> List[ChipletSpec]:
    """Heterogeneous 2.5D chiplet mix (paper Fig. 5: 3x3-conv chiplets, 7x7
    chiplets, large FC chiplets)."""
    return [
        ChipletSpec(n_units=512, vector_size=9),     # 3x3 kernels
        ChipletSpec(n_units=512, vector_size=27),    # 3x3xC slices
        ChipletSpec(n_units=512, vector_size=49),    # 7x7 kernels
        ChipletSpec(n_units=512, vector_size=128),   # FC / pointwise
    ]


ACCEL_NETPARAMS = NetworkParams(n_gateways=64, n_mem_chiplets=4)


def crosslight_25d_siph(d: Optional[DeviceLibrary] = None,
                        params: Optional[NetworkParams] = None) -> AcceleratorConfig:
    p = params or ACCEL_NETPARAMS
    return AcceleratorConfig(
        name="2.5D-CrossLight-SiPh",
        chiplets=_hetero_chiplets(),
        network=trine_network(p, d=d),
        mem_bw_bytes_per_s=p.n_mem_chiplets * p.mem_bw_bytes_per_s,
        adaptive_gateways=True,
    )


def crosslight_25d_elec(d: Optional[DeviceLibrary] = None,
                        params: Optional[NetworkParams] = None) -> AcceleratorConfig:
    p = params or ACCEL_NETPARAMS
    return AcceleratorConfig(
        name="2.5D-CrossLight-Elec",
        chiplets=_hetero_chiplets(),
        network=electrical_mesh(p, d),
        mem_bw_bytes_per_s=p.n_mem_chiplets * p.mem_bw_bytes_per_s,
    )


# --------------------------------------------------------------------------
# Struct-of-arrays flattening (consumed by core.sweep's batched evaluator)
# --------------------------------------------------------------------------

def layer_columns(wl: Workload) -> Dict[str, np.ndarray]:
    """Workload layers as float64 columns, one row per layer."""
    def col(get):
        return np.asarray([get(l) for l in wl.layers], np.float64)

    return {
        "dot_length": col(lambda l: l.dot_length),
        "n_dots": col(lambda l: l.n_dots),
        "weight_bytes": col(lambda l: l.weight_bytes),
        "in_bytes": col(lambda l: l.in_bytes),
        "out_bytes": col(lambda l: l.out_bytes),
    }


def chiplet_columns(accel: AcceleratorConfig) -> Dict[str, np.ndarray]:
    """Chiplet mix as float64 columns, one row per chiplet."""
    return {
        "n_units": np.asarray([c.n_units for c in accel.chiplets], np.float64),
        "vector_size": np.asarray([c.vector_size for c in accel.chiplets], np.float64),
    }


def chiplet_mix_columns(mixes: Sequence[Sequence[ChipletSpec]]
                        ) -> Dict[str, np.ndarray]:
    """A batch of chiplet mixes as (M, C) columns — the leading mix axis of
    the co-design grid kernel.  Shorter mixes are padded with zero-unit
    chiplets (vector_size 1), which the kernel masks out of both the
    throughput sum and the slot minimum."""
    if not mixes:
        raise ValueError("need at least one chiplet mix")
    width = max(len(m) for m in mixes)
    n_units = np.zeros((len(mixes), width), np.float64)
    vec = np.ones((len(mixes), width), np.float64)
    for i, mix in enumerate(mixes):
        for j, c in enumerate(mix):
            n_units[i, j] = c.n_units
            vec[i, j] = c.vector_size
    dead = np.where(~(n_units > 0).any(axis=1))[0]
    if dead.size:
        raise ValueError(
            f"chiplet mix(es) {dead.tolist()} have no active (n_units > 0) "
            "chiplets; an all-zero mix has no compute throughput")
    return {"n_units": n_units, "vector_size": vec}


# --------------------------------------------------------------------------
# Evaluation
# --------------------------------------------------------------------------

def _layer_compute(accel: AcceleratorConfig, dot_length: int, n_dots: float):
    """Layer split across all chiplets proportionally to their throughput for
    this dot length.  Returns (seconds, wavelength-slots consumed).

    Zero-unit chiplets (mix padding) carry no compute: they contribute
    neither throughput nor a slot count, exactly like the grid kernel's
    `units > 0` masks."""
    total_thr = 0.0
    slots_per_dot_best = None
    for c in accel.chiplets:
        if c.n_units <= 0:
            continue
        passes = -(-dot_length // c.vector_size)  # ceil
        thr = c.n_units * accel.mac_rate_hz / passes  # dots/s on this chiplet
        total_thr += thr
        slots = passes * c.vector_size
        if slots_per_dot_best is None or slots < slots_per_dot_best:
            slots_per_dot_best = slots
    if slots_per_dot_best is None:
        raise ValueError(
            f"accelerator {accel.name!r} has no active (n_units > 0) "
            "chiplets; an all-zero mix has no compute throughput")
    secs = n_dots / total_thr
    # energy accounting uses the best-matching chiplet's slot count weighted
    # by throughput share; approximate with the best (mapping preference)
    return secs, n_dots * slots_per_dot_best


def evaluate_accelerator(
    accel: AcceleratorConfig,
    wl: Workload,
    devices: Optional[DeviceLibrary] = None,
) -> AccelReport:
    d = devices or DEFAULT_DEVICES
    if not any(c.n_units > 0 for c in accel.chiplets):
        raise ValueError(
            f"accelerator {accel.name!r} has no active (n_units > 0) "
            "chiplets; an all-zero mix has no compute throughput")
    total_lat = 0.0
    total_compute = total_net = total_mem = 0.0
    compute_energy = 0.0
    net_energy = 0.0
    total_bits = 0.0

    for layer in wl.layers:
        c_s, slots = _layer_compute(accel, layer.dot_length, layer.n_dots)
        compute_energy += slots * accel.lambda_slot_energy_j

        t = Traffic(bytes_read=layer.weight_bytes + layer.in_bytes,
                    bytes_written=layer.out_bytes,
                    n_transfers=accel.transfers_per_layer)
        frac = 1.0
        if accel.adaptive_gateways:
            demand = t.total_bytes / max(c_s, 1e-12)
            frac = plan_gateway_activation(
                demand, accel.network.effective_bw_bps / 8.0,
                n_gateways=max(1, accel.network.n_wavelengths // 8))
        rep = evaluate_network(accel.network, t, d, active_fraction=frac)
        mem_s = t.total_bytes / accel.mem_bw_bytes_per_s

        # double-buffered: network/memory overlap compute; layer pays the max
        total_lat += max(c_s, rep.latency_s, mem_s)
        total_compute += c_s
        total_net += rep.latency_s
        total_mem += mem_s
        net_energy += rep.energy_j
        total_bits += t.total_bits

    energy = compute_energy + net_energy
    return AccelReport(
        name=accel.name,
        latency_s=total_lat,
        power_w=energy / max(total_lat, 1e-30),
        energy_j=energy,
        epb_j=net_energy / max(total_bits, 1.0),
        compute_s=total_compute,
        network_s=total_net,
        memory_s=total_mem,
        network_energy_j=net_energy,
    )


# --------------------------------------------------------------------------
# Co-design grid evaluation: chiplet-mix axis x network-config axis
# --------------------------------------------------------------------------


def _f64(x, device) -> torch.Tensor:
    """A float64 tensor on `device`; tensors already there pass through
    untouched (no host round-trip for the streaming engine's columns)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def _bcast_col(v, n: int, device) -> torch.Tensor:
    """(n,) column on `device` from a scalar or a column."""
    return torch.broadcast_to(_f64(v, device), (n,))


def _accel_mix_math(cc, frac_ov, lc, nets, dev, mem_bw, mac_rate, slot_e,
                    xfers, *, adaptive: bool, relaxed: bool = False):
    """Chiplet mixes against (N,) network configs and (L,) workload layers,
    on float64 tensors.

    cc   : (..., C) chiplet columns (zero-unit rows are padding); the
           leading axes, if any, are mix axes — the reference vmaps one
           (C,) mix at a time, here the mix axis is a tensor axis
    lc   : (L,) layer columns
    nets : (N,) NetworkModel field columns
    dev  : (N,) EVAL_DEVICE_FIELDS columns
    frac_ov : optional precomputed PCMC activation, (..., 1, L) or
        (..., N, L); when None and `adaptive`, the planner runs in-kernel
        per (config, layer)
    returns (..., N)-shaped AccelReport fields.

    With ``relaxed=True`` the pass count drops its ceil — ``max(L/V, 1)``
    instead of ``ceil(L/V)`` — so every accelerator axis (per-chiplet
    `n_units`/`vector_size` as positive reals, `mac_rate_hz`,
    `lambda_slot_energy_j`) carries a nonzero gradient: the continuous
    relaxation a co-design refinement descends before snapping back to
    integers and re-scoring exactly (relaxed=False).  The two modes agree
    wherever V divides L and the relaxed pass count is >= 1; the zero-unit
    masks stay: padding rows are exact zeros, never descended.  Everything
    is differentiable (no host syncs, no in-place writes), and max/clip
    split the gradient at ties as the reference's do.
    """
    xp = TorchNS(lc["dot_length"].device)
    vec = cc["vector_size"][..., :, None]                       # (..., C, 1)
    units = cc["n_units"][..., :, None]
    raw_passes = lc["dot_length"] / vec                         # (..., C, L)
    passes = (xp.maximum(raw_passes, 1.0) if relaxed
              else torch.ceil(raw_passes))
    live = units > 0
    thr = torch.where(live, units * mac_rate / passes, xp.asarray(0.0))
    total_thr = thr.sum(-2)                                     # (..., L)
    slots = torch.where(live, passes * vec, xp.asarray(torch.inf)).amin(-2)
    c_s = lc["n_dots"] / total_thr                              # (..., L)
    compute_e = (lc["n_dots"] * slots).sum(-1) * slot_e         # (...,)

    bytes_total = lc["weight_bytes"] + lc["in_bytes"] + lc["out_bytes"]
    bits = 8.0 * bytes_total                                    # (L,)
    if frac_ov is not None:
        frac = frac_ov
    elif adaptive:
        demand = bytes_total / xp.maximum(c_s, 1e-12)           # (..., L)
        n_gw = xp.maximum(1.0, torch.floor(nets["n_wavelengths"] / 8.0))
        frac = plan_gateway_activation_arr(
            demand[..., None, :], nets["effective_bw_bps"][:, None] / 8.0,
            n_gw[:, None], xp=xp)                               # (..., N, L)
    else:
        frac = torch.ones_like(bits)

    nets2 = {k: v[:, None] for k, v in nets.items()}            # (N, 1)
    dev2 = {k: v[:, None] for k, v in dev.items()}
    m = eval_network_math(nets2, dev2, bits, xfers, frac)       # (..., N, L)

    mem_s = bytes_total / mem_bw[:, None]                       # (N, L)
    # double-buffered: network/memory overlap compute; layer pays the max
    layer_lat = xp.maximum(xp.maximum(c_s[..., None, :], m["latency_s"]),
                           mem_s)
    latency = layer_lat.sum(-1)                                 # (..., N)
    net_e = m["energy_j"].sum(-1)
    net_s = m["latency_s"].sum(-1)
    energy = compute_e[..., None] + net_e
    bits_sum = bits.sum()
    shape = latency.shape
    return {
        "latency_s": latency,
        "power_w": energy / xp.maximum(latency, 1e-30),
        "energy_j": energy,
        "epb_j": torch.broadcast_to(net_e / xp.maximum(bits_sum, 1.0), shape),
        "compute_s": torch.broadcast_to(c_s.sum(-1)[..., None], shape),
        "network_s": torch.broadcast_to(net_s, shape),
        "memory_s": torch.broadcast_to(mem_s.sum(-1), shape),
        "network_energy_j": torch.broadcast_to(net_e, shape),
    }


def evaluate_accelerator_grid(
    wl: Workload,
    mixes: Sequence[Sequence[ChipletSpec]],
    nets: Mapping[str, np.ndarray],
    dev_cols: Mapping[str, np.ndarray],
    mem_bw_bytes_per_s,
    *,
    mac_rate_hz: float = 5e9,
    lambda_slot_energy_j: float = 30e-15,
    adaptive_gateways: bool = True,
    transfers_per_layer: int = 16,
    frac: Optional[np.ndarray] = None,
    as_numpy: bool = True,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Joint (chiplet-mix x network-config) accelerator evaluation in one
    call on `device`: M mixes x N network configs x all L workload layers.

    `nets` holds MODEL_FIELDS columns and `dev_cols` EVAL_DEVICE_FIELDS
    columns, each (N,) or scalar (a sweep-chunk's `nets`/`cols` dicts fit
    directly); `mem_bw_bytes_per_s` likewise.  Columns that are already
    tensors on `device` stay there (no host round-trip).  Always evaluates
    in float64.  Returns (M, N) float64 arrays for every AccelReport field —
    numpy by default, tensors on `device` with ``as_numpy=False``.  `frac`
    optionally overrides the in-kernel PCMC planner with a precomputed
    activation of shape (M, L) or (M, N, L) — `evaluate_accelerator_batch`
    uses that to keep its float64 host-side planner rounding.  Memory is
    O(M * N * L); stream big network grids in chunks.  The sums over layers
    and chiplets are reductions, so the card and the CPU agree to rounding,
    not bit for bit.
    """
    dev = require_device(device)
    lc = {k: _f64(v, dev) for k, v in layer_columns(wl).items()}
    cc = {k: _f64(v, dev) for k, v in chiplet_mix_columns(mixes).items()}
    shape = np.broadcast_shapes(
        *(tuple(np.shape(nets[k])) for k in MODEL_FIELDS),
        *(tuple(np.shape(dev_cols[k])) for k in EVAL_DEVICE_FIELDS),
        tuple(np.shape(mem_bw_bytes_per_s)))
    n = int(shape[0]) if shape else 1
    nets_t = {k: _bcast_col(nets[k], n, dev) for k in MODEL_FIELDS}
    dev_t = {k: _bcast_col(dev_cols[k], n, dev) for k in EVAL_DEVICE_FIELDS}
    mem_bw_t = _bcast_col(mem_bw_bytes_per_s, n, dev)
    frac_t = None
    if frac is not None:
        frac_t = _f64(frac, dev)
        if frac_t.ndim == 2:                                    # (M, L)
            frac_t = frac_t[:, None, :]
    out = _accel_mix_math(cc, frac_t, lc, nets_t, dev_t, mem_bw_t,
                          _f64(mac_rate_hz, dev), _f64(lambda_slot_energy_j, dev),
                          _f64(transfers_per_layer, dev),
                          adaptive=bool(adaptive_gateways))
    if not as_numpy:
        return out
    return {k: v.cpu().numpy().astype(np.float64) for k, v in out.items()}


def evaluate_accelerator_batch(
    accel: AcceleratorConfig,
    wl: Workload,
    devices: Optional[DeviceLibrary] = None,
    device="cuda",
) -> AccelReport:
    """Batched mirror of `evaluate_accelerator`: the per-layer Python loop
    becomes one (M=1 mix, N=1 config) cell of the co-design grid kernel on
    `device`.  The PCMC gateway planner runs host-side in float64 so its
    step rounding is bit-identical to the scalar reference path."""
    d = devices or DEFAULT_DEVICES
    lc = layer_columns(wl)
    cc = chiplet_columns(accel)
    bytes_total = lc["weight_bytes"] + lc["in_bytes"] + lc["out_bytes"]
    net = accel.network
    if accel.adaptive_gateways:
        passes = np.ceil(lc["dot_length"][:, None] / cc["vector_size"][None, :])
        thr = cc["n_units"][None, :] * accel.mac_rate_hz / passes
        c_s = lc["n_dots"] / thr.sum(axis=1)
        demand = bytes_total / np.maximum(c_s, 1e-12)
        frac = plan_gateway_activation_arr(
            demand, net.effective_bw_bps / 8.0,
            max(1, net.n_wavelengths // 8))
    else:
        frac = np.ones_like(bytes_total)
    nets = {f: np.float64(getattr(net, f)) for f in MODEL_FIELDS}
    out = evaluate_accelerator_grid(
        wl, [accel.chiplets], nets, device_columns(d),
        accel.mem_bw_bytes_per_s,
        mac_rate_hz=accel.mac_rate_hz,
        lambda_slot_energy_j=accel.lambda_slot_energy_j,
        transfers_per_layer=accel.transfers_per_layer,
        frac=frac[None, :], device=device)
    return AccelReport(
        name=accel.name,
        **{f: float(out[f][0, 0]) for f in ACCEL_REPORT_FIELDS})
