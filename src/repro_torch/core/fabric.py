"""Fabric: one network design point as the Layer-B link model.

The bridge between the two halves of the repo.  Layer A (core.topology /
core.power / core.faults) scores interposer-network *designs*; Layer B (the
channel planner, the batcher's and the trainer's modelled collectives)
prices *programs* against link numbers.  A `Fabric` converts a design point
— a named preset, a `NetworkModel`, a config dict from
`GridSpec.config_at` / `codesign_config_at`, or a whole `core.search`
Pareto frontier — into the link numbers the Layer-B estimate path
consumes:

  cross_pod_bw_bytes_per_s   the slow inter-pod link (the channel planner's
                             link bandwidth): effective_bw_bps / 8 of the
                             network.
  intra_pod_bw_bytes_per_s   subnetwork-provisioned bandwidth inside a pod
                             (aggregate_bw_bps / 8 — parallel subnetworks /
                             waveguides all usable for local stages).
  link_latency_s             fixed per-collective overhead (arbitration or
                             MZI switching), from per_transfer_s.
  energy_per_bit_j           network energy per wire bit, from the Layer-A
                             power model under a probe traffic.
  hbm_bw_bytes_per_s /       chip-local constants, carried so a Fabric fully
  peak_flops                 determines a roofline evaluation.

`DEFAULT_FABRIC` is the metallic-ICI preset of the reference's modelled
chip (its link latency is 0: that model lumps per-hop costs into the
bandwidth term).

Entry points:

  metallic_ici() / FABRIC_PRESETS / get_fabric(name)
  Fabric.from_network_model(net)       any core.topology NetworkModel
  Fabric.from_config(cfg)              a config dict (topology + axis
                                       overrides) as emitted by
                                       GridSpec.config_at or
                                       codesign_config_at
  fabrics_from_front(front, spec)      one Fabric per distinct network
                                       design on a Pareto frontier — the
                                       search -> system loop closed
  degrade(fabric, scenario)            the link numbers under a fault
                                       scenario (core.faults)
  overlapped_step_s(...)               a step's modelled time when a
                                       collective overlaps compute

This is the port's counterpart of the JAX package's `core/fabric.py`: host
numpy over the port's `evaluate_network` and `model_from_row`; `degrade`
evaluates the degraded design's energy on ``device=`` (default "cuda").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, TYPE_CHECKING

import numpy as np

from repro_torch.core.devices import DeviceLibrary, DEFAULT_DEVICES
from repro_torch.core.power import Traffic, evaluate_network
from repro_torch.core.topology import (
    NetworkModel,
    NetworkParams,
    model_from_row,
    TOPOLOGY_ARRAYS,
    sprint_bus,
    spacx_bus,
    tree_network,
    trine_network,
    electrical_mesh,
)

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.search import ParetoFront
    from repro_torch.core.sweep import GridSpec

__all__ = [
    "Fabric", "DEFAULT_FABRIC", "FABRIC_PRESETS", "get_fabric",
    "metallic_ici", "fabrics_from_front", "degrade", "overlapped_step_s",
    "DEFAULT_PEAK_FLOPS", "DEFAULT_HBM_BW", "METALLIC_ICI_BW",
]

# The reference's modelled chip: a TPU v5e-class accelerator with metallic
# ICI links.  These are inputs of the analytic model, not measurements, and
# not the H100 this package runs on: every preset, roofline term and
# channel plan is priced against them, so the port keeps them as they are
# to give the reference's numbers.
DEFAULT_PEAK_FLOPS = 197e12    # bf16 FLOP/s per modelled chip
DEFAULT_HBM_BW = 819e9         # bytes/s HBM per modelled chip
METALLIC_ICI_BW = 50e9         # bytes/s per modelled metallic ICI link

# probe traffic used to extract an energy-per-bit figure from the Layer-A
# power model (large enough that per-transfer overheads are amortized)
_PROBE = Traffic(bytes_read=1 << 30, bytes_written=1 << 30, n_transfers=16)

# config-dict keys that describe the accelerator's compute side, not the
# interposer link model — `from_config`/`fabrics_from_front` drop them
_COMPUTE_SIDE_KEYS = ("mix", "chiplets", "mac_rate_hz",
                      "lambda_slot_energy_j")


@dataclasses.dataclass(frozen=True)
class Fabric:
    """One network design point, reduced to the Layer-B link model."""

    name: str
    cross_pod_bw_bytes_per_s: float
    intra_pod_bw_bytes_per_s: float
    hbm_bw_bytes_per_s: float = DEFAULT_HBM_BW
    peak_flops: float = DEFAULT_PEAK_FLOPS
    link_latency_s: float = 0.0       # fixed per-collective overhead
    energy_per_bit_j: float = 0.0     # network energy per wire bit
    source: Dict[str, float] = dataclasses.field(default_factory=dict)

    # ---- roofline terms -------------------------------------------------
    def compute_s(self, flops: float) -> float:
        return flops / self.peak_flops

    def memory_s(self, hbm_bytes: float) -> float:
        return hbm_bytes / self.hbm_bw_bytes_per_s

    def collective_s(self, wire_bytes: float, n_collectives: float = 0.0
                     ) -> float:
        """Serialization on the slow (cross-pod) link + fixed per-collective
        switching/arbitration overhead."""
        return (wire_bytes / self.cross_pod_bw_bytes_per_s
                + n_collectives * self.link_latency_s)

    def collective_energy_j(self, wire_bytes: float) -> float:
        return 8.0 * wire_bytes * self.energy_per_bit_j

    # ---- constructors ---------------------------------------------------
    @classmethod
    def from_network_model(
        cls,
        net: NetworkModel,
        name: Optional[str] = None,
        devices: Optional[DeviceLibrary] = None,
        *,
        hbm_bw_bytes_per_s: float = DEFAULT_HBM_BW,
        peak_flops: float = DEFAULT_PEAK_FLOPS,
        source: Optional[Mapping[str, float]] = None,
    ) -> "Fabric":
        """Reduce a Layer-A `NetworkModel` to fabric link numbers.

        Cross-pod bandwidth is the *effective* (contention-derated) network
        bandwidth — the shared stage every hierarchical collective must
        cross; intra-pod bandwidth is the aggregate (subnetworks/waveguides
        run in parallel for pod-local stages).  Energy per bit comes from
        the full Layer-A power model under a probe traffic, so laser sizing
        and trimming are amortized in, not just the dynamic term.
        """
        rep = evaluate_network(net, _PROBE, devices or DEFAULT_DEVICES)
        cross = net.effective_bw_bps / 8.0
        intra = max(net.aggregate_bw_bps / 8.0, cross)
        return cls(
            name=name or net.name,
            cross_pod_bw_bytes_per_s=cross,
            intra_pod_bw_bytes_per_s=intra,
            hbm_bw_bytes_per_s=hbm_bw_bytes_per_s,
            peak_flops=peak_flops,
            link_latency_s=net.per_transfer_s,
            energy_per_bit_j=rep.energy_per_bit_j,
            source=dict(source or {}),
        )

    @classmethod
    def from_config(
        cls,
        cfg: Mapping[str, object],
        name: Optional[str] = None,
        devices: Optional[DeviceLibrary] = None,
        **kwargs,
    ) -> "Fabric":
        """Build a Fabric from a config dict — the format `GridSpec.
        config_at`, `SweepResult.config_at` and `codesign_config_at` emit: a
        "topology" key plus swept-axis overrides (NetworkParams fields,
        dotted device leaves, "n_subnetworks").  Compute-side keys ("mix",
        "chiplets", "mac_rate_hz", "lambda_slot_energy_j") are ignored: they
        change the accelerator's compute, not the interposer link model."""
        from repro_torch.core.sweep import grid_spec  # local: import cycle

        cfg = dict(cfg)
        topology = str(cfg.pop("topology"))
        for key in _COMPUTE_SIDE_KEYS:
            cfg.pop(key, None)
        if topology not in TOPOLOGY_ARRAYS:
            raise KeyError(f"unknown topology {topology!r}")
        spec = grid_spec((topology,), devices=devices)
        cols = dict(spec.base)
        for k, v in cfg.items():
            if k not in cols:
                raise KeyError(f"unknown config column {k!r}")
            cols[k] = float(v)
        cols_arr = {k: np.float64(v) for k, v in cols.items()}
        net = model_from_row(TOPOLOGY_ARRAYS[topology](cols_arr), topology)
        src = {"topology": topology}
        src.update({k: float(v) for k, v in cfg.items()})
        return cls.from_network_model(
            net, name=name or f"{topology}-cfg", devices=devices,
            source=src, **kwargs)


def metallic_ici() -> Fabric:
    """The modelled chip's metallic baseline.  Link latency is 0 because
    that model lumps per-hop costs into the bandwidth term.  ~5 pJ/bit is a
    typical electrical SerDes + wire figure."""
    return Fabric(
        name="metallic_ici",
        cross_pod_bw_bytes_per_s=METALLIC_ICI_BW,
        intra_pod_bw_bytes_per_s=METALLIC_ICI_BW,
        hbm_bw_bytes_per_s=DEFAULT_HBM_BW,
        peak_flops=DEFAULT_PEAK_FLOPS,
        link_latency_s=0.0,
        energy_per_bit_j=5e-12,
    )


DEFAULT_FABRIC = metallic_ici()


def _preset(factory, name: str, topology: str) -> Fabric:
    # the topology key in `source` lets `degrade` rebuild the design point
    # exactly (the same columnar path `from_config` takes)
    return Fabric.from_network_model(factory(NetworkParams()), name=name,
                                     source={"topology": topology})


FABRIC_PRESETS = {
    "metallic_ici": metallic_ici,
    "trine_siph": lambda: _preset(trine_network, "trine_siph", "trine"),
    "tree_siph": lambda: _preset(tree_network, "tree_siph", "tree"),
    "sprint_siph": lambda: _preset(sprint_bus, "sprint_siph", "sprint"),
    "spacx_siph": lambda: _preset(spacx_bus, "spacx_siph", "spacx"),
    "elec_mesh": lambda: _preset(electrical_mesh, "elec_mesh", "elec"),
}


def get_fabric(fabric) -> Fabric:
    """Resolve a Fabric, a preset name, or pass through None -> default."""
    if fabric is None:
        return DEFAULT_FABRIC
    if isinstance(fabric, Fabric):
        return fabric
    if isinstance(fabric, str):
        if fabric not in FABRIC_PRESETS:
            raise KeyError(
                f"unknown fabric preset {fabric!r}; presets: "
                f"{sorted(FABRIC_PRESETS)}")
        return FABRIC_PRESETS[fabric]()
    raise TypeError(f"expected Fabric | preset name | None, got {fabric!r}")


def fabrics_from_front(
    front: "ParetoFront",
    spec: "GridSpec",
    mixes: Optional[Sequence] = None,
    devices: Optional[DeviceLibrary] = None,
    max_fabrics: Optional[int] = None,
    prefix: str = "pareto",
    **kwargs,
) -> List[Fabric]:
    """One Fabric per *distinct network design* on a Pareto frontier.

    Frontier rows from `codesign_pareto` encode (chiplet mix x network
    config); different mixes over the same network collapse to one fabric
    (the mix changes compute, not the link model).  Fabrics are named
    ``{prefix}:{topology}@{flat_index}`` so what-if artifacts trace back to
    the exact frontier row.  `max_fabrics` keeps what-if tables bounded
    (first-come in the front's canonical order)."""
    from repro_torch.core.search import frontier_configs  # local: import cycle

    out: List[Fabric] = []
    seen = set()
    for idx, cfg in zip(front.indices, frontier_configs(front, spec, mixes)):
        net_cfg = {k: v for k, v in cfg.items()
                   if k not in _COMPUTE_SIDE_KEYS}
        key = tuple(sorted((k, float(v) if k != "topology" else v)
                           for k, v in net_cfg.items()))
        if key in seen:
            continue
        seen.add(key)
        out.append(Fabric.from_config(
            net_cfg, name=f"{prefix}:{net_cfg['topology']}@{int(idx)}",
            devices=devices, **kwargs))
        if max_fabrics is not None and len(out) >= max_fabrics:
            break
    return out


# --------------------------------------------------------------------------
# Fault degradation (core.faults threaded into the Layer-B link model)
# --------------------------------------------------------------------------


def degrade(fabric, scenario, device="cuda") -> Fabric:
    """The Layer-B view of a fault scenario: re-derive a fabric's link
    numbers under `scenario` (a scalar `core.faults.FaultScenario`).

    Fabrics whose `source` names a topology (presets, `from_config`) take
    the exact columnar path: rebuild the design point's columns, degrade
    them through `core.faults` on the host, and reduce the degraded fields
    to cross/intra-pod bandwidth, per-hop latency, and energy/bit (the
    metric math on `device`) — so laser aging and thermal drift show up as
    a higher energy_per_bit_j, and dead banks/wavelengths as lower
    bandwidth.  Sourceless fabrics (the metallic baseline) only expose
    gateway ports to failure: bandwidth scales by the surviving-port
    fraction, and `device` is not used.

    Degradation composes from the *healthy* source design — pass cumulative
    scenarios rather than chaining degrade() calls.
    """
    from repro_torch.core import faults as F  # runtime: faults layers above
    from repro_torch.core.sweep import evaluate_columns, grid_spec

    fb = get_fabric(fabric)
    if scenario.batch_shape():
        raise ValueError("degrade takes one scalar scenario; fold batches "
                         "through core.faults.availability_search instead")
    name = f"{fb.name}|{scenario.name}"
    topology = fb.source.get("topology")
    if topology is None:
        surv = float(F.port_survival(scenario))
        return dataclasses.replace(
            fb, name=name,
            cross_pod_bw_bytes_per_s=fb.cross_pod_bw_bytes_per_s * surv,
            intra_pod_bw_bytes_per_s=fb.intra_pod_bw_bytes_per_s * surv,
            source=dict(fb.source, degraded=1.0))

    spec = grid_spec((str(topology),))
    cols = dict(spec.base)
    for k, v in fb.source.items():
        if k in cols:
            cols[k] = float(v)
    cols = {k: np.atleast_1d(np.float64(v)) for k, v in cols.items()}
    nets, dcols = F.degraded_network_columns(
        cols, np.zeros(1, np.int64), (str(topology),), scenario)
    eff = float(np.ravel(nets["effective_bw_bps"])[0])
    agg = float(np.ravel(nets["aggregate_bw_bps"])[0])
    cross = eff / 8.0
    if eff > 0:
        rep = evaluate_columns(nets, dcols, _PROBE.total_bits,
                               _PROBE.n_transfers, device=device)
        epb = float(np.ravel(rep["energy_per_bit_j"])[0])
    else:
        epb = float("inf")  # no surviving lanes: nothing can cross
    return dataclasses.replace(
        fb, name=name,
        cross_pod_bw_bytes_per_s=cross,
        intra_pod_bw_bytes_per_s=max(agg / 8.0, cross),
        link_latency_s=float(np.ravel(nets["per_transfer_s"])[0]),
        energy_per_bit_j=epb,
        source=dict(fb.source, degraded=1.0))


def overlapped_step_s(compute_s: float, wire_bytes: float, fabric,
                      channels: int) -> float:
    """Modeled train-step time when a `wire_bytes` collective overlaps a
    `compute_s` window through `channels` parallel chunks.  The first chunk
    has nothing to hide behind, so only (1 - 1/channels) of the compute
    window is usable cover — more channels on a degraded (slower) fabric
    recover throughput, which is what replanning buys."""
    fb = get_fabric(fabric)
    if fb.cross_pod_bw_bytes_per_s <= 0:
        return float("inf")
    channels = max(1, int(channels))
    comm = fb.collective_s(wire_bytes, n_collectives=channels)
    cover = compute_s * (1.0 - 1.0 / channels)
    return compute_s + max(0.0, comm - cover)
