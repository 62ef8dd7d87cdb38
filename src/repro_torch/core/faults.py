"""Physical fault model for the photonic interposer fabric.

The paper's case for 2.5D photonic interposers rests on links that are
physically fragile in ways metallic ICI is not: microring resonators drift
with temperature and process variation, laser banks age and fail, and a dead
gateway chiplet severs whatever sat behind it.  This module expresses those
failure modes as **columnar perturbations** over the same struct-of-arrays
columns the sweep engine already evaluates, so a batch of fault scenarios
composes with `sweep_chunked` for Monte-Carlo yield and availability
analysis over 1e5+-point grids.  This is the port's counterpart of the JAX
package's `core/faults.py`: the algebra is written once against an `xp`
namespace (numpy on the host, `core.xp.TorchNS` inside the device engine),
and `FaultModel.sample` draws from numpy's `default_rng(seed)`, so both
packages get the same scenarios from the same seed.

Fault modes and where they act
------------------------------

Input-column perturbations (seen by the topology kernels, so loss-dependent
laser sizing reacts):

  drift_db        thermal/process drift adds insertion loss per MZI stage
                  (``mzi.insertion_loss_db`` += drift_db)
  tuning_factor   drifted rings need more thermal trimming
                  (``mr.tuning_power_w`` *= tuning_factor, >= 1)
  wpe_factor      laser aging degrades wall-plug efficiency
                  (``laser.wall_plug_efficiency`` *= wpe_factor, <= 1)

Post-kernel survival derating (applied to the emitted MODEL_FIELDS — dead
hardware stays on the waveguide, so worst-path loss and ring counts do NOT
improve; only usable bandwidth shrinks):

  dead_lambda_frac     fraction of wavelengths lost to dead microrings:
                       scales usable bandwidth and active wavelength count.
  failed_laser_banks   ABSOLUTE count of dead laser banks.  A design with
                       one bank (Tree) dies outright at the first failure;
                       TRINE's K banks lose K-th fractions — the redundancy
                       argument made quantitative.
  failed_gateways      ABSOLUTE count of dead gateway chiplets.  TRINE loses
                       the whole subnetwork behind each dead gateway (blast
                       radius of its SWMR tree); bus topologies (SPACX /
                       SPRINT) and the electrical mesh lose ports
                       proportionally.

Monotonicity by construction: every knob can only raise loss, raise static
power, or shrink bandwidth, so latency / energy / EDP are monotone
non-improving in fault severity (the invariant resilience_bench checks).
Raw `power_w` is NOT monotone — a dead network has no dynamic power — so it
is deliberately excluded from the invariant.

Entry points
------------

  FaultScenario            one scenario (scalars) or a batch ((S, 1) arrays)
  FaultModel               failure *rates*; `.expected()` gives the
                           deterministic mean scenario for degradation
                           curves, `.sample(n)` draws a Monte-Carlo batch,
                           `.scale(severity)` scales every rate
  degraded_network_columns the fault-aware mirror of the sweep engine's
                           network-column builder (per-topology kernels +
                           survival derating); plugs into `sweep_chunked`
                           via `faulted_columns_fn`
  evaluate_degraded        batch-of-one convenience: metrics of one design
                           under one scenario (or a scenario batch)
  AvailabilityReducer /    chunked Monte-Carlo yield columns per design
  availability_search      point: expected-degraded-EDP and P(EPB <= budget)
  FabricUnusableError      the hard-fail signal: a degraded fabric that
                           cannot carry the collective at all
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.power import Traffic
from repro_torch.core.topology import (
    MODEL_FIELDS,
    NetworkParams,
    TOPOLOGY_ARRAYS,
    params_columns,
)
from repro_torch.core.sweep import (
    ChunkReducer,
    DEFAULT_TOPOLOGIES,
    GridSpec,
    SweepChunk,
    evaluate_columns,
    sweep_chunked,
)

__all__ = [
    "FaultScenario", "FaultModel", "FabricUnusableError", "HEALTHY",
    "degrade_device_columns", "degraded_network_columns",
    "FaultedColumns", "faulted_columns_fn", "evaluate_degraded",
    "AvailabilityReducer", "availability_search",
]


class FabricUnusableError(RuntimeError):
    """A degraded fabric cannot carry the collective at all (zero surviving
    bandwidth) — the hard-fail path for trainer/serving replans."""


# scenario fields, in one place so batching/broadcast helpers stay in sync
_SCENARIO_FIELDS = ("dead_lambda_frac", "failed_laser_banks",
                    "failed_gateways", "wpe_factor", "drift_db",
                    "tuning_factor")


@dataclasses.dataclass(frozen=True)
class FaultScenario:
    """One concrete fault state.  Every field is a scalar or an (S, 1) array
    (a batch of S scenarios — the extra trailing axis broadcasts against the
    config axis, giving (S, N) metrics from an N-point grid)."""

    dead_lambda_frac: object = 0.0   # in [0, 1]
    failed_laser_banks: object = 0.0  # absolute count (may be fractional mean)
    failed_gateways: object = 0.0     # absolute count
    wpe_factor: object = 1.0          # in (0, 1]
    drift_db: object = 0.0            # added per-MZI insertion loss, >= 0
    tuning_factor: object = 1.0       # trimming power multiplier, >= 1
    name: str = "fault"

    def batch_shape(self) -> Tuple[int, ...]:
        return np.broadcast_shapes(
            *(np.shape(getattr(self, f)) for f in _SCENARIO_FIELDS))

    @property
    def n_scenarios(self) -> int:
        shape = self.batch_shape()
        return int(shape[0]) if shape else 1

    def is_healthy(self) -> bool:
        return (np.all(np.asarray(self.dead_lambda_frac) == 0)
                and np.all(np.asarray(self.failed_laser_banks) == 0)
                and np.all(np.asarray(self.failed_gateways) == 0)
                and np.all(np.asarray(self.wpe_factor) == 1)
                and np.all(np.asarray(self.drift_db) == 0)
                and np.all(np.asarray(self.tuning_factor) == 1))


HEALTHY = FaultScenario(name="healthy")


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Failure *rates* (per-component probabilities / drift scales).  The
    reference counts (`n_*_ref`) anchor the absolute draws: a bank-failure
    probability of 0.1 over an 8-bank reference draws Binomial(8, 0.1) dead
    banks and applies that absolute count to every design — which is exactly
    what makes single-bank designs fragile and K-bank TRINE redundant."""

    p_lambda: float = 0.0        # per-wavelength (microring) death prob
    p_bank: float = 0.0          # per-laser-bank failure prob
    p_gateway: float = 0.0       # per-gateway-chiplet failure prob
    wpe_loss: float = 0.0        # mean fractional wall-plug-eff. degradation
    drift_sigma_db: float = 0.0  # thermal drift scale (dB per MZI)
    tuning_sigma: float = 0.0    # fractional trimming-power drift scale
    n_lambda_ref: int = 8
    n_banks_ref: int = 8
    n_gateways_ref: int = 32

    def scale(self, severity: float) -> "FaultModel":
        """Every rate scaled by `severity` (probabilities clipped to 1)."""
        s = float(severity)
        return dataclasses.replace(
            self,
            p_lambda=min(1.0, self.p_lambda * s),
            p_bank=min(1.0, self.p_bank * s),
            p_gateway=min(1.0, self.p_gateway * s),
            wpe_loss=min(0.95, self.wpe_loss * s),
            drift_sigma_db=self.drift_sigma_db * s,
            tuning_sigma=self.tuning_sigma * s,
        )

    def expected(self, name: Optional[str] = None) -> FaultScenario:
        """The deterministic mean scenario — what degradation curves sweep.
        Expected counts may be fractional (the survival algebra is
        continuous); drift uses the half-normal mean sigma*sqrt(2/pi)."""
        hn = math.sqrt(2.0 / math.pi)
        return FaultScenario(
            dead_lambda_frac=self.p_lambda,
            failed_laser_banks=self.p_bank * self.n_banks_ref,
            failed_gateways=self.p_gateway * self.n_gateways_ref,
            wpe_factor=max(0.05, 1.0 - self.wpe_loss),
            drift_db=self.drift_sigma_db * hn,
            tuning_factor=1.0 + self.tuning_sigma * hn,
            name=name or "expected",
        )

    def sample(self, n: int, rng=None,
               name: Optional[str] = None) -> FaultScenario:
        """Draw an (S=n, 1)-batched Monte-Carlo scenario."""
        rng = np.random.default_rng(rng)
        shp = (int(n), 1)
        dead = (rng.binomial(self.n_lambda_ref, min(1.0, self.p_lambda), shp)
                .astype(np.float64) / self.n_lambda_ref)
        banks = rng.binomial(self.n_banks_ref, min(1.0, self.p_bank),
                             shp).astype(np.float64)
        gws = rng.binomial(self.n_gateways_ref, min(1.0, self.p_gateway),
                           shp).astype(np.float64)
        wpe = np.clip(1.0 - rng.exponential(self.wpe_loss, shp), 0.05, 1.0)
        drift = np.abs(rng.normal(0.0, self.drift_sigma_db, shp))
        tuning = 1.0 + np.abs(rng.normal(0.0, self.tuning_sigma, shp))
        return FaultScenario(
            dead_lambda_frac=dead, failed_laser_banks=banks,
            failed_gateways=gws, wpe_factor=wpe, drift_db=drift,
            tuning_factor=tuning, name=name or f"mc{n}")


# --------------------------------------------------------------------------
# Columnar degradation
# --------------------------------------------------------------------------


def degrade_device_columns(cols: Mapping[str, np.ndarray],
                           scenario: FaultScenario,
                           xp=np) -> Dict[str, np.ndarray]:
    """Apply the input-side perturbations (drift, trimming, WPE) to a device
    column dict.  Batched scenario fields ((S, 1)) broadcast the perturbed
    columns to (S, N); untouched columns keep their shape and broadcast in
    the downstream kernels."""
    out = dict(cols)
    out["mzi.insertion_loss_db"] = (cols["mzi.insertion_loss_db"]
                                    + scenario.drift_db)
    out["mr.tuning_power_w"] = (cols["mr.tuning_power_w"]
                                * scenario.tuning_factor)
    out["laser.wall_plug_efficiency"] = (cols["laser.wall_plug_efficiency"]
                                         * scenario.wpe_factor)
    return out


def port_survival(scenario: FaultScenario, n_gateways=None, xp=np):
    """Surviving-port fraction for designs without subnetwork structure
    (buses, electrical mesh, metallic ICI): (G - failed) / G, clipped."""
    g = np.float64(NetworkParams().n_gateways) if n_gateways is None \
        else n_gateways
    return xp.clip((g - scenario.failed_gateways)
                   / xp.maximum(g, 1e-30), 0.0, 1.0)


def _degrade_fields(fields: Dict[str, np.ndarray],
                    n_gateways, scenario: FaultScenario,
                    topology: str, xp=np) -> Dict[str, np.ndarray]:
    """Post-kernel survival derating of one topology's MODEL_FIELDS.

    Dead hardware stays physically on the waveguide: worst-path loss, ring /
    MZI counts, and stage counts are untouched (trimming and laser sizing
    keep paying for the dead fraction — conservative and monotone).  Only
    the *usable* bandwidth, wavelength count, and bank count shrink.
    """
    lam = xp.clip(1.0 - scenario.dead_lambda_frac, 0.0, 1.0)
    banks = fields["n_laser_banks"]
    if topology == "trine":
        # a dead gateway severs the SWMR subnetwork (and its bank) behind it
        lost_banks = scenario.failed_laser_banks + scenario.failed_gateways
        port = 1.0
    else:
        lost_banks = scenario.failed_laser_banks
        port = port_survival(scenario, n_gateways, xp)
    bank = xp.clip((banks - lost_banks) / xp.maximum(banks, 1e-30), 0.0, 1.0)

    is_el = fields["is_electrical"] > 0
    surv = xp.where(is_el, port, lam * bank * port)
    out = dict(fields)
    out["aggregate_bw_bps"] = fields["aggregate_bw_bps"] * surv
    out["effective_bw_bps"] = fields["effective_bw_bps"] * surv
    out["n_wavelengths"] = xp.where(
        is_el, fields["n_wavelengths"], fields["n_wavelengths"] * lam * bank)
    out["n_laser_banks"] = xp.where(is_el, banks, banks * bank)
    return out


def degraded_network_columns(
    cols: Mapping[str, np.ndarray],
    topo_id: np.ndarray,
    topologies: Sequence[str],
    scenario: FaultScenario,
    xp=np,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Fault-aware mirror of the sweep engine's network-column builder:
    perturb the device columns, run each topology's kernel, derate the
    emitted fields by the survival factors.  Returns ``(net_fields,
    degraded_device_cols)``; with an (S, 1)-batched scenario the net fields
    come back (S, N)."""
    dcols = degrade_device_columns(cols, scenario, xp)
    topo_id = np.asarray(topo_id)
    n = int(topo_id.size)
    full = np.broadcast_shapes(scenario.batch_shape(), (n,))
    out = {f: np.zeros(full, np.float64) for f in MODEL_FIELDS}
    for ti, name in enumerate(topologies):
        mask = topo_id == ti
        if not mask.any():
            continue
        sub = {k: (np.asarray(v)[..., mask] if np.ndim(v) else v)
               for k, v in dcols.items()}
        fields = TOPOLOGY_ARRAYS[name](sub, xp)
        g = np.asarray(cols["n_gateways"])
        g_sub = g[..., mask] if np.ndim(g) else g
        fields = _degrade_fields(fields, g_sub, scenario, name, xp)
        for f in MODEL_FIELDS:
            out[f][..., mask] = fields[f]
    return out, dcols


@dataclasses.dataclass(frozen=True)
class FaultedColumns:
    """A scenario-carrying `columns_fn` hook for `sweep_chunked`: every
    chunk is evaluated under `scenario` instead of the healthy fabric.

    The streaming engine recognizes the ``scenario`` attribute and composes
    the degradation on the device — the six scenario fields become tensor
    inputs of its universal evaluation, so faulted sweeps keep the
    device-resident decode path and its prefetch pipeline.  Calling the
    hook directly runs the numpy reference path
    (`degraded_network_columns`), which is what legacy callers and the
    device-vs-host parity tests use."""

    scenario: FaultScenario
    xp: object = np

    def __call__(self, cols, topo_id, topologies):
        return degraded_network_columns(cols, topo_id, topologies,
                                        self.scenario, self.xp)


def faulted_columns_fn(scenario: FaultScenario, xp=np) -> FaultedColumns:
    """Build the fault hook for `sweep_chunked` (see `FaultedColumns`)."""
    return FaultedColumns(scenario, xp)


def evaluate_degraded(
    traffic: Traffic,
    scenario: FaultScenario,
    topology: str,
    params: Optional[NetworkParams] = None,
    devices=None,
    n_subnetworks: int = 0,
    active_fraction: float = 1.0,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Batch-of-one convenience: the full metric dict of one design point
    under `scenario`, the network columns built on the host and the metrics
    evaluated on `device`.  Metric shapes are (1,) for a scalar scenario and
    (S, 1) for a batch — a zero-bandwidth scenario yields inf latency /
    energy (the design is dead, not mis-modeled)."""
    cols = {k: np.atleast_1d(np.asarray(v, np.float64))
            for k, v in params_columns(params or NetworkParams(), devices,
                                       n_subnetworks).items()}
    topo_id = np.zeros(1, np.int64)
    nets, dcols = degraded_network_columns(cols, topo_id, (topology,),
                                           scenario)
    return evaluate_columns(nets, dcols, traffic.total_bits,
                            traffic.n_transfers, active_fraction,
                            device=device)


# --------------------------------------------------------------------------
# Chunked Monte-Carlo availability (yield columns over a design grid)
# --------------------------------------------------------------------------


class AvailabilityReducer(ChunkReducer):
    """Per-design-point Monte-Carlo yield columns from an (S, chunk) metric
    stream: expected degraded EDP/EPB and availability P(EPB <= budget).

    Output arrays are O(grid) (three float64 columns — ~2.4 MB per 1e5
    points); the (S x chunk) intermediates stay bounded by the chunk size.
    `finish` also reports the expected-EDP argmin among points meeting the
    availability floor — the "best survivable design"."""

    def __init__(self, epb_budget_j: float, min_availability: float = 0.9):
        self.epb_budget_j = float(epb_budget_j)
        self.min_availability = float(min_availability)

    def init(self, spec: GridSpec):
        n = spec.n
        return {"expected_edp": np.zeros(n), "expected_epb": np.zeros(n),
                "availability": np.zeros(n), "n_scenarios": 0}

    def step(self, carry, chunk: SweepChunk):
        lat = np.atleast_2d(chunk.metrics["latency_s"])
        en = np.atleast_2d(chunk.metrics["energy_j"])
        epb = np.atleast_2d(chunk.metrics["energy_per_bit_j"])
        sl = slice(chunk.start, chunk.stop)
        with np.errstate(invalid="ignore", over="ignore"):
            carry["expected_edp"][sl] = np.mean(lat * en, axis=0)
        carry["expected_epb"][sl] = np.mean(epb, axis=0)
        carry["availability"][sl] = np.mean(epb <= self.epb_budget_j, axis=0)
        carry["n_scenarios"] = int(epb.shape[0])
        return carry

    def finish(self, carry, spec: GridSpec):
        avail = carry["availability"]
        edp = carry["expected_edp"]
        ok = avail >= self.min_availability
        best = None
        if ok.any():
            cand = np.where(ok, edp, np.inf)
            i = int(np.argmin(cand))
            best = {"index": i, "config": spec.config_at(i),
                    "expected_edp": float(edp[i]),
                    "availability": float(avail[i])}
        return dict(carry, n=spec.n, best_survivable=best,
                    epb_budget_j=self.epb_budget_j,
                    min_availability=self.min_availability)


def availability_search(
    traffic: Traffic,
    scenarios: FaultScenario,
    topologies: Sequence[str] = DEFAULT_TOPOLOGIES,
    devices=None,
    epb_budget_j: float = 1e-9,
    min_availability: float = 0.9,
    chunk_size: int = 8192,
    materialize: str = "auto",
    prefetch: Optional[int] = None,
    device="cuda",
    **axes,
):
    """Chunked Monte-Carlo availability over a design grid: every chunk is
    evaluated under the (S, 1)-batched `scenarios`, and the reducer folds
    the scenario axis into per-point yield columns.  Peak memory is
    O(S * chunk_size) regardless of grid size.  `materialize` / `prefetch`
    / `device` pass through to `sweep_chunked` (device-resident decode +
    prefetch pipeline by default)."""
    return sweep_chunked(
        traffic, AvailabilityReducer(epb_budget_j, min_availability),
        topologies=topologies, devices=devices, chunk_size=chunk_size,
        columns_fn=faulted_columns_fn(scenarios),
        materialize=materialize, prefetch=prefetch, device=device, **axes)
