"""Network power / latency / energy evaluation (paper Fig. 4 methodology).

Given a `NetworkModel` (topology) and a traffic summary (bytes moved, number
of transfers), produce the three quantities the paper reports: network power
(W), total network latency (s), and energy (J) — plus energy-per-bit.

Power breakdown (photonic):
  laser     — sized by worst-case path loss (exponential in dB loss; the
              paper's core argument for stage-minimal topologies)
  trimming  — static thermal tuning, ∝ total MR count (TRINE pays more here
              than SPACX/Tree; paper acknowledges this)
  switch    — MZI bias/driver static power
  dynamic   — modulator driver + SerDes + receiver energy per bit

Electrical: per-bit link+router energy, router static power.

The port's counterpart of the JAX package's `core/power.py`.  The scalar path
(`evaluate_network`) is host numpy, as there; the batched math
(`eval_network_math`) runs on float64 tensors, on any device.  There is no
counterpart of the reference's `engine_x64`: every tensor the engine makes is
float64 by construction, whatever the default dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.devices import DeviceLibrary, DEFAULT_DEVICES, laser_electrical_power_w
from repro_torch.core.topology import NetworkModel
from repro_torch.core.xp import TorchNS

# metric columns `eval_network_math` emits == NetworkReport fields — the
# network-side metric vocabulary.  `core.sweep.METRIC_FIELDS` aliases this.
EVAL_METRIC_FIELDS = ("power_w", "latency_s", "energy_j", "energy_per_bit_j",
                      "laser_power_w", "trimming_power_w")

# device leaves the batched metric kernel reads (the topology kernels consume
# the rest); `eval_network_math` expects exactly these keys in its `dev` dict
EVAL_DEVICE_FIELDS = (
    "pd.sensitivity_dbm", "pd.energy_per_bit_j",
    "laser.power_margin_db", "laser.coupling_loss_db",
    "laser.wall_plug_efficiency", "laser.bank_overhead_w",
    "mr.tuning_power_w",
    "mzi.static_power_w", "mzi.switch_energy_j",
    "driver.energy_per_bit_j", "driver.serdes_energy_per_bit_j",
    "elec.energy_per_bit_j", "elec.router_power_w",
)


@dataclasses.dataclass(frozen=True)
class Traffic:
    """Aggregate interposer traffic of one workload (from workloads.py)."""

    bytes_read: float       # memory -> compute (SWMR)
    bytes_written: float    # compute -> memory (SWSR)
    n_transfers: int        # distinct layer-level transfer events

    @property
    def total_bytes(self) -> float:
        return self.bytes_read + self.bytes_written

    @property
    def total_bits(self) -> float:
        return 8.0 * self.total_bytes


@dataclasses.dataclass(frozen=True)
class NetworkReport:
    name: str
    power_w: float          # static + average dynamic power
    latency_s: float
    energy_j: float
    energy_per_bit_j: float
    laser_power_w: float
    trimming_power_w: float


def eval_network_math(nets: Dict[str, torch.Tensor], dev: Dict[str, torch.Tensor],
                      total_bits: torch.Tensor, n_transfers: torch.Tensor,
                      active_fraction: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Branch-free batched mirror of `evaluate_network` on float64 tensors:
    both the photonic and the electrical formula evaluate on every lane and
    `is_electrical` selects.  All operands broadcast elementwise, so callers
    batch over configurations, workload traffics, per-layer traffic, or any
    combination.  Every operation is elementwise (no reduction over any
    axis), so each element comes out the same at any shape: the streaming
    engine's bitwise contracts rest on that.  `core.sweep` calls it as the
    grid kernel, `core.accelerator` per (chiplet-mix, network, layer) lane,
    and autograd differentiates through it (the round() wavelength/bank
    quantization is piecewise-constant — zero gradient).  `10**x` is
    `TorchNS.pow10`, which rounds the same on every element and device."""
    xp = TorchNS(nets["worst_path_loss_db"].device)
    # ---- photonic ----
    frac = xp.clip(active_fraction, 1e-3, 1.0)
    n_lambda_active = xp.maximum(1.0, torch.round(nets["n_wavelengths"] * frac))
    n_banks_active = xp.maximum(1.0, torch.round(nets["n_laser_banks"] * frac))
    p_tx_dbm = (dev["pd.sensitivity_dbm"] + dev["laser.power_margin_db"]
                + nets["worst_path_loss_db"] + dev["laser.coupling_loss_db"])
    per_lambda_w = 1e-3 * xp.pow10(p_tx_dbm / 10.0)
    laser_p = (n_lambda_active * per_lambda_w / dev["laser.wall_plug_efficiency"]
               + n_banks_active * dev["laser.bank_overhead_w"])
    trimming_p = nets["n_mr"] * dev["mr.tuning_power_w"] * frac
    switch_p = nets["n_mzi"] * dev["mzi.static_power_w"] * frac
    static_p = laser_p + trimming_p + switch_p

    bw = nets["effective_bw_bps"] * frac
    lat_ph = total_bits / bw + n_transfers * nets["per_transfer_s"]
    per_bit = (dev["driver.energy_per_bit_j"]
               + dev["driver.serdes_energy_per_bit_j"]
               + dev["pd.energy_per_bit_j"])
    dyn_e = total_bits * per_bit
    switch_e = n_transfers * nets["n_stages"] * dev["mzi.switch_energy_j"]
    energy_ph = static_p * lat_ph + dyn_e + switch_e
    power_ph = static_p + (dyn_e + switch_e) / xp.maximum(lat_ph, 1e-30)

    # ---- electrical ----
    lat_el = (total_bits / nets["effective_bw_bps"]
              + n_transfers * nets["per_transfer_s"])
    dyn_el = total_bits * dev["elec.energy_per_bit_j"] * nets["avg_hops"]
    static_el = nets["n_routers"] * dev["elec.router_power_w"]
    energy_el = dyn_el + static_el * lat_el
    power_el = static_el + dyn_el / xp.maximum(lat_el, 1e-30)

    is_el = nets["is_electrical"] > 0
    latency = torch.where(is_el, lat_el, lat_ph)
    energy = torch.where(is_el, energy_el, energy_ph)
    zero = xp.asarray(0.0)
    return {
        "power_w": torch.where(is_el, power_el, power_ph),
        "latency_s": latency,
        "energy_j": energy,
        "energy_per_bit_j": energy / xp.maximum(total_bits, 1.0),
        "laser_power_w": torch.where(is_el, zero, laser_p),
        "trimming_power_w": torch.where(is_el, zero, trimming_p),
    }


def broadcast_metrics(out: Dict[str, object], xp=np) -> Dict[str, object]:
    """Broadcast every metric column to the common (traffic x scenario x
    config) result shape.  `eval_network_math` leaves each metric at its
    natural broadcast shape (a workload-independent column stays (N,)); the
    streaming engine needs uniform shapes so padded lanes slice off with one
    ``[..., :valid]``.  `xp` is numpy (read-only views of host arrays, the
    engine's path: columns cross to the host at their natural shapes) or
    torch."""
    shape = np.broadcast_shapes(*(tuple(np.shape(v)) for v in out.values()))
    return {k: xp.broadcast_to(v, shape) for k, v in out.items()}


def evaluate_network(
    net: NetworkModel,
    traffic: Traffic,
    devices: Optional[DeviceLibrary] = None,
    active_fraction: float = 1.0,
) -> NetworkReport:
    """Evaluate one topology under one workload's traffic.

    `active_fraction` models 2.5D-CrossLight's PCMC gateway adaptation: only
    that fraction of wavelengths/gateways is lit (laser + trimming scale
    down); bandwidth scales with it too.
    """
    d = devices or DEFAULT_DEVICES

    if net.is_electrical:
        # latency: serialization at effective BW + per-transfer hop latency
        ser = traffic.total_bits / net.effective_bw_bps
        lat = ser + traffic.n_transfers * net.per_transfer_s
        dyn_e = traffic.total_bits * d.elec.energy_per_bit_j * net.avg_hops
        static_p = net.n_routers * d.elec.router_power_w
        energy = dyn_e + static_p * lat
        return NetworkReport(
            name=net.name,
            power_w=float(static_p + dyn_e / max(lat, 1e-30)),
            latency_s=float(lat),
            energy_j=float(energy),
            energy_per_bit_j=float(energy / max(traffic.total_bits, 1.0)),
            laser_power_w=0.0,
            trimming_power_w=0.0,
        )

    frac = float(np.clip(active_fraction, 1e-3, 1.0))
    n_lambda_active = max(1, int(round(net.n_wavelengths * frac)))

    n_banks_active = max(1, int(round(net.n_laser_banks * frac)))
    laser_p = float(
        laser_electrical_power_w(
            net.worst_path_loss_db, n_lambda_active, d, n_banks=n_banks_active
        )
    )
    trimming_p = net.n_mr * d.mr.tuning_power_w * frac
    switch_p = net.n_mzi * d.mzi.static_power_w * frac
    static_p = laser_p + trimming_p + switch_p

    bw = net.effective_bw_bps * frac
    ser = traffic.total_bits / bw
    lat = ser + traffic.n_transfers * net.per_transfer_s

    per_bit = (
        d.driver.energy_per_bit_j
        + d.driver.serdes_energy_per_bit_j
        + d.pd.energy_per_bit_j
    )
    dyn_e = traffic.total_bits * per_bit
    switch_e = traffic.n_transfers * net.n_stages * d.mzi.switch_energy_j
    energy = static_p * lat + dyn_e + switch_e

    return NetworkReport(
        name=net.name,
        power_w=float(static_p + (dyn_e + switch_e) / max(lat, 1e-30)),
        latency_s=float(lat),
        energy_j=float(energy),
        energy_per_bit_j=float(energy / max(traffic.total_bits, 1.0)),
        laser_power_w=laser_p,
        trimming_power_w=float(trimming_p),
    )
