"""Silicon-photonic device models for the TRINE / 2.5D-CrossLight analytical layer.

Every constant is a published device figure from the paper's own line of work
(TRINE [11], 2.5D-CrossLight [12], CrossLight [16], the survey [10]/[20]) or a
standard SiPh device-table value used by SPRINT/SPACX.  The analytical model in
`topology.py` / `power.py` composes these into loss chains -> laser power ->
energy, which is exactly the paper's evaluation methodology (there is no public
simulator for these works).

Units: losses in dB, powers in W, energies in J, rates in bit/s, lengths in cm.

This is the port's own copy of `repro.core.devices` (numpy only, no torch):
the port imports nothing of the JAX package, and the dataclasses, dotted
device-leaf vocabulary and dB helpers are the same, value for value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# dB helpers (vectorized; numpy float64 — the analytical layer needs 64-bit
# precision for dB<->linear round-trips; these serve the scalar host path)
# ---------------------------------------------------------------------------


def db_to_linear(db):
    """Power ratio from dB."""
    return 10.0 ** (np.asarray(db, dtype=np.float64) / 10.0)


def linear_to_db(lin):
    return 10.0 * np.log10(np.asarray(lin, dtype=np.float64))


def dbm_to_watt(dbm):
    return 1e-3 * db_to_linear(dbm)


def watt_to_dbm(w):
    return linear_to_db(np.asarray(w, dtype=np.float64) / 1e-3)


# ---------------------------------------------------------------------------
# Device parameter records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MRParams:
    """Microring resonator (modulator / filter / weight bank element).

    through_loss_db : loss seen by a *non-resonant* wavelength passing the MR.
    drop_loss_db    : loss for the resonant wavelength coupled to the drop port.
    modulation_loss_db : excess loss when used as a modulator (OOK ER penalty).
    tuning_power_w  : static thermal trimming power to hold resonance
                      (process/thermal variation compensation).
    switching_energy_j : energy to retune resonance (weight update / switch).
    max_rate_bps    : modulation cutoff.
    resolution_bits : achievable amplitude-weight resolution when used as a
                      weight bank element (CrossLight's cross-layer design
                      demonstrates robust 16-level..256-level operation; we
                      default to 8 bits and sweep 4..8 in the ablation).
    """

    through_loss_db: float = 0.02     # [16] per-MR through loss
    drop_loss_db: float = 0.7         # [16] drop-port insertion loss
    modulation_loss_db: float = 0.7   # OOK modulator insertion/ER penalty
    tuning_power_w: float = 275e-6    # 0.275 mW/MR thermal trimming (survey [20])
    switching_energy_j: float = 20e-15
    max_rate_bps: float = 12e9        # paper Sec. IV: 12 GHz modulation
    resolution_bits: int = 8


@dataclasses.dataclass(frozen=True)
class MZIParams:
    """Broadband 2x2 Mach-Zehnder switch (TRINE's tree stages).

    insertion_loss_db : per-stage broadband insertion loss.
    switch_time_s     : carrier-injection (electro-optic) broadband MZI
                        switching time, ns-class.  Stage count still sets the
                        reconfiguration latency and the accumulated loss --
                        why TRINE's 2 stages beat Tree's 5.
    static_power_w    : bias/driver power per MZI while active.
    switch_energy_j   : energy per reconfiguration event.
    """

    insertion_loss_db: float = 1.0
    switch_time_s: float = 20e-9
    static_power_w: float = 1.0e-3
    switch_energy_j: float = 1.0e-9


@dataclasses.dataclass(frozen=True)
class PCMCParams:
    """Phase-change-material coupler (2.5D-CrossLight adaptive gateways).

    Non-volatile: holds state at zero static power; pays write energy to
    reconfigure. Used to (de)activate gateways for bandwidth adaptation.
    """

    insertion_loss_db: float = 0.3
    write_energy_j: float = 1.0e-9
    write_time_s: float = 10e-6
    static_power_w: float = 0.0


@dataclasses.dataclass(frozen=True)
class PhotodiodeParams:
    """Receiver: photodiode + TIA.

    sensitivity_dbm : minimum received optical power for target BER at
                      max_rate_bps (typ. -26 dBm @ ~12 GHz, Ge-on-Si PD).
    energy_per_bit_j: receiver-side (PD+TIA+SA) energy.
    """

    sensitivity_dbm: float = -26.0
    responsivity_a_per_w: float = 1.1
    energy_per_bit_j: float = 40e-15


@dataclasses.dataclass(frozen=True)
class LaserParams:
    """Off-chip comb / DFB laser bank.

    bank_overhead_w: fixed electrical overhead per laser bank (TEC, bias,
    driver) independent of emitted optical power.  This is why TRINE -- with
    one laser bank per subnetwork -- spends *more* laser power than SPACX or
    Tree (paper Sec. IV) even though its per-wavelength optical power is the
    lowest of all topologies.
    """

    wall_plug_efficiency: float = 0.10
    coupling_loss_db: float = 1.5     # fiber->chip coupler
    power_margin_db: float = 1.0      # link budget margin
    bank_overhead_w: float = 20e-3


@dataclasses.dataclass(frozen=True)
class WaveguideParams:
    propagation_loss_db_per_cm: float = 1.0   # interposer SiN/Si waveguide
    crossing_loss_db: float = 0.05
    splitter_loss_db: float = 0.13            # Y-branch excess loss
    bend_loss_db: float = 0.01
    group_velocity_cm_per_s: float = 7.5e9    # ~c/4 in Si waveguide


@dataclasses.dataclass(frozen=True)
class ModulatorDriverParams:
    """Electrical driver + SerDes at the writer gateway."""

    energy_per_bit_j: float = 60e-15
    serdes_energy_per_bit_j: float = 150e-15


@dataclasses.dataclass(frozen=True)
class ElectricalLinkParams:
    """Electrical interposer wire + mesh router baseline ([21], Sec. V).

    State-of-the-art electrical interposer wires: "hundreds of Gb/s with a
    few pJ/bit" (paper Sec. I); mesh routers add per-hop latency and energy.
    """

    energy_per_bit_j: float = 1.8e-12       # ~2 pJ/bit per hop (wire+router)
    router_latency_s: float = 2.5e-9        # pipelined router @ ~2GHz, 5 cyc
    wire_latency_s_per_cm: float = 160e-12  # RC-limited repeated wire
    link_bandwidth_bps: float = 32e9        # 32-bit @ 1 GHz interposer link
                                            # (cm-scale global wires; paper
                                            # Sec. I: dispersion/attenuation
                                            # caps electrical rates ~40Gb/s)
    router_power_w: float = 6e-3
    hotspot_saturation: float = 0.3         # mesh saturation throughput under
                                            # memory-hotspot (gather/scatter)
                                            # traffic, classic ~30% of ingress


@dataclasses.dataclass(frozen=True)
class DeviceLibrary:
    """One bag of device parameters threaded through the whole model."""

    mr: MRParams = MRParams()
    mzi: MZIParams = MZIParams()
    pcmc: PCMCParams = PCMCParams()
    pd: PhotodiodeParams = PhotodiodeParams()
    laser: LaserParams = LaserParams()
    wg: WaveguideParams = WaveguideParams()
    driver: ModulatorDriverParams = ModulatorDriverParams()
    elec: ElectricalLinkParams = ElectricalLinkParams()

    def replace(self, **kw) -> "DeviceLibrary":
        return dataclasses.replace(self, **kw)


DEFAULT_DEVICES = DeviceLibrary()


def device_columns(d: Optional[DeviceLibrary] = None) -> dict:
    """Flatten a DeviceLibrary to ``{"mr.through_loss_db": 0.02, ...}``.

    The dotted leaf names are the sweep engine's device-axis vocabulary: any
    of them can be turned into a grid dimension (`core.sweep.build_grid`),
    and `replace_device_leaves` maps a row of such columns back to a concrete
    DeviceLibrary for the scalar reference path.
    """
    d = d or DEFAULT_DEVICES
    cols = {}
    for group in dataclasses.fields(d):
        rec = getattr(d, group.name)
        for leaf in dataclasses.fields(rec):
            v = getattr(rec, leaf.name)
            if isinstance(v, (int, float)):
                cols[f"{group.name}.{leaf.name}"] = float(v)
    return cols


def replace_device_leaves(d: DeviceLibrary, leaves: dict) -> DeviceLibrary:
    """Rebuild a DeviceLibrary with dotted-name overrides applied."""
    by_group: dict = {}
    for dotted, value in leaves.items():
        group, leaf = dotted.split(".", 1)
        by_group.setdefault(group, {})[leaf] = value
    repl = {}
    for group, kv in by_group.items():
        rec = getattr(d, group)
        cast = {k: type(getattr(rec, k))(v) for k, v in kv.items()}
        repl[group] = dataclasses.replace(rec, **cast)
    return dataclasses.replace(d, **repl) if repl else d


def laser_electrical_power_w(
    path_loss_db,
    n_wavelengths,
    devices: Optional[DeviceLibrary] = None,
    n_banks: int = 1,
):
    """Laser wall-plug power needed so each of `n_wavelengths` arrives at the
    photodiode above sensitivity after `path_loss_db` of worst-case loss,
    plus the fixed per-bank overhead for `n_banks` laser banks.

    This is the paper's central energy argument: loss in dB adds per device
    passed, so required laser power grows *exponentially* (in linear units)
    with the number of on-path devices -- the reason bus topologies scale
    badly and stage-minimal trees (TRINE) win.
    """
    d = devices or DEFAULT_DEVICES
    p_rx_req_dbm = d.pd.sensitivity_dbm + d.laser.power_margin_db
    p_tx_dbm = p_rx_req_dbm + path_loss_db + d.laser.coupling_loss_db
    per_lambda_w = dbm_to_watt(p_tx_dbm)
    emitted = np.asarray(n_wavelengths, np.float64) * per_lambda_w / d.laser.wall_plug_efficiency
    return emitted + n_banks * d.laser.bank_overhead_w
