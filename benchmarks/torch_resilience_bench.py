"""Survivability benchmark: how gracefully does each interposer network
degrade as photonic faults accumulate — and does replanning recover what a
naive (healthy-plan) schedule loses?

Four views, all through `core.faults`:

  degradation   per-topology curves of latency / EDP / EPB vs. fault
                severity (deterministic expected scenarios from a scaled
                FaultModel).  Invariant: latency and EDP are monotone
                non-improving in severity for every topology.
  recovery      the TRINE preset fabric degraded at each severity, priced
                through the overlapped-step model with (a) the healthy
                channel plan and (b) a replanned channel count.  Invariant:
                replanned step time <= naive step time everywhere.
  redundancy    Monte-Carlo availability under laser-bank / gateway
                failures (common random draws across topologies): TRINE's K
                subnetwork banks lose K-th fractions where Tree's single
                bank dies outright and SPACX's fewer cluster banks lose
                larger fractions.  Availability is P(degraded EPB <= 2x the
                design's own healthy EPB) — "equal healthy EDP" budgets.
  yield grid    the chunked Monte-Carlo availability column over a
                >= 1e5-point design grid (even in smoke: chunking bounds
                memory, not grid size), plus a healthy reference pass
                asserting expected degraded EDP >= healthy EDP pointwise.

The PyTorch port's counterpart of `benchmarks/resilience_bench.py`: the same
views, fault models and checks from `repro_torch.core`, every evaluation in
float64 on ``device`` (default "cuda").  Writes
`artifacts/torch_resilience.json`.

    PYTHONPATH=src python benchmarks/torch_resilience_bench.py [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from repro_torch.core import (
    FaultModel,
    HEALTHY,
    Traffic,
    availability_search,
    degrade,
    evaluate_degraded,
    get_fabric,
    overlapped_step_s,
    plan_collective_channels,
)
from repro_torch.core.workloads import CNN_WORKLOADS
from repro_torch.env import prefetch_depth, smoke_mode

ARTIFACTS = Path(__file__).resolve().parent / "artifacts"

TOPOLOGIES = ("trine", "tree", "spacx", "sprint", "elec")

# baseline fault rates at severity 1.0 (scaled along the curve axis)
BASE_MODEL = FaultModel(p_lambda=0.15, p_bank=0.12, p_gateway=0.05,
                        wpe_loss=0.2, drift_sigma_db=0.5, tuning_sigma=0.3)

# bank/gateway-dominated model for the redundancy Monte-Carlo: large enough
# bank-failure rate that multi-bank redundancy separates from single-bank
MC_MODEL = FaultModel(p_bank=0.15, p_gateway=0.02, p_lambda=0.05)

SEVERITIES_FULL = (0.0, 0.25, 0.5, 1.0, 1.5, 2.0)
SEVERITIES_SMOKE = (0.0, 0.5, 2.0)

# gradient-collective sizing for the recovery view (~0.5B-param DP step)
RECOVERY_BYTES = 2.0 * 2**30
RECOVERY_WINDOW_S = 50e-3


def degradation_curves(traffic: Traffic, severities, device="cuda") -> list:
    rows = []
    for topo in TOPOLOGIES:
        for s in severities:
            scenario = BASE_MODEL.scale(s).expected(name=f"sev{s:g}")
            m = evaluate_degraded(traffic, scenario, topo, device=device)
            lat = float(m["latency_s"][0])
            en = float(m["energy_j"][0])
            rows.append({
                "topology": topo, "severity": float(s),
                "latency_s": lat, "energy_j": en, "edp": lat * en,
                "energy_per_bit_j": float(m["energy_per_bit_j"][0]),
            })
    return rows


def check_monotone(rows) -> bool:
    """Latency and EDP non-decreasing along each topology's severity curve.
    (power_w is intentionally excluded: a dead network has no dynamic
    power, so raw power is not monotone in severity.)"""
    ok = True
    for topo in TOPOLOGIES:
        curve = sorted((r for r in rows if r["topology"] == topo),
                       key=lambda r: r["severity"])
        for a, b in zip(curve, curve[1:]):
            ok &= b["latency_s"] >= a["latency_s"] * (1 - 1e-9)
            ok &= b["edp"] >= a["edp"] * (1 - 1e-9)
    return bool(ok)


def recovery_rows(severities, device="cuda") -> list:
    """Degraded-fabric step time with the healthy channel plan vs. a
    replanned channel count, per severity."""
    fb = get_fabric("trine_siph")
    ch_healthy = plan_collective_channels(
        RECOVERY_BYTES, RECOVERY_WINDOW_S, fabric=fb, max_channels=64)
    rows = []
    for s in severities:
        scenario = BASE_MODEL.scale(s).expected(name=f"sev{s:g}")
        fbd = degrade(fb, scenario, device=device)
        naive = overlapped_step_s(RECOVERY_WINDOW_S, RECOVERY_BYTES,
                                  fbd, ch_healthy)
        ch_re = plan_collective_channels(
            RECOVERY_BYTES, RECOVERY_WINDOW_S, fabric=fbd, max_channels=64)
        replanned = overlapped_step_s(RECOVERY_WINDOW_S, RECOVERY_BYTES,
                                      fbd, ch_re)
        rows.append({
            "severity": float(s), "fabric": fbd.name,
            "cross_pod_gbps": fbd.cross_pod_bw_bytes_per_s / 1e9,
            "channels_naive": int(ch_healthy), "channels_replanned": int(ch_re),
            "step_s_naive": float(naive), "step_s_replanned": float(replanned),
        })
    return rows


def redundancy_availability(traffic: Traffic, n_draws: int,
                            device="cuda") -> dict:
    """Common-random-draw Monte-Carlo availability per topology: a design is
    available when its degraded EPB stays within 2x its OWN healthy EPB
    (budgets normalized per design — "equal healthy EDP")."""
    scenarios = MC_MODEL.sample(n_draws, rng=7)
    out = {}
    for topo in ("trine", "tree", "spacx"):
        healthy_epb = float(evaluate_degraded(
            traffic, HEALTHY, topo, device=device)["energy_per_bit_j"][0])
        epb = evaluate_degraded(traffic, scenarios, topo,
                                device=device)["energy_per_bit_j"]
        out[topo] = float(np.mean(epb <= 2.0 * healthy_epb))
    return out


YIELD_AXES = {
    "n_lambda": (2.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0),
    "modulation_rate_bps": tuple(np.linspace(6e9, 20e9, 8)),
    "mem_bw_bytes_per_s": tuple(np.linspace(50e9, 400e9, 8)),
    "mzi.insertion_loss_db": (0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0),
    "interposer_side_cm": (2.0, 3.0, 4.0, 6.0, 8.0),
}


def yield_grid(traffic: Traffic, n_draws: int, chunk_size: int,
               device="cuda") -> dict:
    """Chunked Monte-Carlo availability columns over a >= 1e5-point grid,
    plus a healthy single-scenario pass for the pointwise EDP comparison."""
    scenarios = BASE_MODEL.sample(n_draws, rng=11)
    healthy = evaluate_degraded(traffic, HEALTHY, "trine",
                                device=device)  # budget anchor
    budget = 2.0 * float(healthy["energy_per_bit_j"][0])
    # device-materialized, prefetch-pipelined streaming (the engine default,
    # pinned + recorded here so the artifact states what was measured; any
    # (materialize, prefetch) combination is bit-identical by contract)
    depth = prefetch_depth()
    t0 = time.perf_counter()
    mc = availability_search(traffic, scenarios, topologies=TOPOLOGIES,
                             epb_budget_j=budget, chunk_size=chunk_size,
                             materialize="device", prefetch=depth,
                             device=device, **YIELD_AXES)
    mc_s = time.perf_counter() - t0
    ref = availability_search(traffic, HEALTHY, topologies=TOPOLOGIES,
                              epb_budget_j=budget, chunk_size=chunk_size,
                              materialize="device", prefetch=depth,
                              device=device, **YIELD_AXES)
    return {
        "n_points": int(mc["n"]),
        "n_scenarios": int(mc["n_scenarios"]),
        "chunk_size": int(chunk_size),
        "materialize": "device",
        "prefetch_depth": int(depth),
        "epb_budget_j": budget,
        "mc_seconds": mc_s,
        "availability_min": float(np.min(mc["availability"])),
        "availability_max": float(np.max(mc["availability"])),
        "availability_mean": float(np.mean(mc["availability"])),
        "best_survivable": mc["best_survivable"],
        "edp_ge_healthy": bool(np.all(
            mc["expected_edp"] >= ref["expected_edp"] * (1 - 1e-9))),
    }


def run(csv: bool = True, smoke: bool | None = None, device="cuda") -> dict:
    smoke = smoke_mode() if smoke is None else smoke
    severities = SEVERITIES_SMOKE if smoke else SEVERITIES_FULL
    n_draws_mc = 64 if smoke else 256
    n_draws_grid = 4 if smoke else 16
    chunk_size = 8192

    traffic = CNN_WORKLOADS["ResNet18"]().traffic()

    t0 = time.perf_counter()
    curves = degradation_curves(traffic, severities, device)
    recovery = recovery_rows(severities, device)
    avail = redundancy_availability(traffic, n_draws_mc, device)
    grid = yield_grid(traffic, n_draws_grid, chunk_size, device)
    wall_s = time.perf_counter() - t0

    checks = {
        "monotone_degradation": check_monotone(curves),
        "replan_recovers": all(
            r["step_s_replanned"] <= r["step_s_naive"] * (1 + 1e-9)
            for r in recovery),
        "trine_redundancy_beats_tree": avail["trine"] > avail["tree"],
        "trine_redundancy_at_least_spacx": avail["trine"] >= avail["spacx"],
        "availability_grid_at_least_1e5": grid["n_points"] >= 100_000,
        "availability_in_unit_interval": (
            0.0 <= grid["availability_min"]
            and grid["availability_max"] <= 1.0),
        "expected_edp_ge_healthy": grid["edp_ge_healthy"],
    }
    out = {
        "smoke": bool(smoke),
        "device": str(device),
        "wall_s": wall_s,
        "degradation": curves,
        "recovery": recovery,
        "availability": avail,
        "yield_grid": grid,
        "checks": checks,
        "required_checks": list(checks),
        "pass": all(checks.values()),
    }
    ARTIFACTS.mkdir(exist_ok=True)
    (ARTIFACTS / "torch_resilience.json").write_text(
        json.dumps(out, indent=1, default=float))
    if csv:
        for r in curves:
            print(f"torch_resilience/degradation/{r['topology']}/"
                  f"sev{r['severity']:g},0,edp={r['edp']:.3e}")
        for r in recovery:
            print(f"torch_resilience/recovery/sev{r['severity']:g},0,"
                  f"naive={r['step_s_naive']:.4f}s "
                  f"replanned={r['step_s_replanned']:.4f}s "
                  f"ch={r['channels_naive']}->{r['channels_replanned']}")
        for topo, a in avail.items():
            print(f"torch_resilience/availability/{topo},0,{a:.3f}")
        print(f"torch_resilience/yield_grid,0,n={grid['n_points']} "
              f"S={grid['n_scenarios']} mean_avail="
              f"{grid['availability_mean']:.3f} ({grid['mc_seconds']:.1f}s)")
        print(f"torch_resilience/pass,0,{'PASS' if out['pass'] else 'FAIL'}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args().device)
