"""Paper Fig. 6: CrossLight (monolithic) vs 2.5D-CrossLight-Elec-Interposer vs
2.5D-CrossLight-SiPh-Interposer — normalized power, latency, energy-per-bit
over six CNNs, plus the paper's headline average ratios:

  SiPh vs monolithic : 6.6x lower latency, 2.8x lower EPB
  SiPh vs electrical : 34x lower latency, 15.8x lower EPB
  LeNet5             : the stated exception (too small to use the platform)

The PyTorch port's counterpart of `benchmarks/fig6_crosslight.py`: the same
rows and checks from `repro_torch.core`, each (accelerator, workload) cell
evaluated on ``device`` (default "cuda") in float64.  Writes
`artifacts/torch_fig6_crosslight.json`.

    PYTHONPATH=src python benchmarks/torch_fig6_crosslight.py [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from repro_torch.core import (
    CNN_WORKLOADS,
    crosslight_25d_elec,
    crosslight_25d_siph,
    evaluate_accelerator_batch,
    monolithic_crosslight,
)

ARTIFACTS = Path(__file__).resolve().parent / "artifacts"

PAPER_CLAIMS = {
    "mono_over_siph_latency": 6.6,
    "mono_over_siph_epb": 2.8,
    "elec_over_siph_latency": 34.0,
    "elec_over_siph_epb": 15.8,
}


def run(csv: bool = True, device="cuda") -> dict:
    accels = [monolithic_crosslight(), crosslight_25d_elec(), crosslight_25d_siph()]
    rows = []
    t0 = time.perf_counter()
    for name, factory in CNN_WORKLOADS.items():
        wl = factory()
        # batched path: per-layer loop replaced by one struct-of-arrays
        # evaluation per (accelerator, workload) on the device
        reps = {a.name: evaluate_accelerator_batch(a, wl, device=device)
                for a in accels}
        m = reps["CrossLight"]
        e = reps["2.5D-CrossLight-Elec"]
        s = reps["2.5D-CrossLight-SiPh"]
        rows.append(
            {
                "cnn": wl.name,
                "latency_s": {k: r.latency_s for k, r in reps.items()},
                "power_w": {k: r.power_w for k, r in reps.items()},
                "epb_pj": {k: r.epb_j * 1e12 for k, r in reps.items()},
                "mono_over_siph_latency": m.latency_s / s.latency_s,
                "mono_over_siph_epb": m.epb_j / s.epb_j,
                "elec_over_siph_latency": e.latency_s / s.latency_s,
                "elec_over_siph_epb": e.epb_j / s.epb_j,
            }
        )
    us = (time.perf_counter() - t0) * 1e6 / max(1, len(rows))

    avg = {
        k: float(np.mean([r[k] for r in rows]))
        for k in PAPER_CLAIMS
    }
    # paper: averages include all six CNNs (LeNet5 drags the mean down; the
    # paper calls it out as the exception where the 2.5D platform is
    # inefficiently utilized)
    checks = {
        # within a factor-2 band of the paper's reported averages — the paper
        # used a cycle-accurate in-house simulator; ours is analytical
        k: (avg[k] >= PAPER_CLAIMS[k] / 2.0) and (avg[k] <= PAPER_CLAIMS[k] * 2.0)
        for k in PAPER_CLAIMS
    }
    lenet = next(r for r in rows if r["cnn"] == "LeNet5")
    checks["lenet5_monolithic_competitive"] = lenet["mono_over_siph_epb"] < 1.5

    out = {"rows": rows, "avg": avg, "paper": PAPER_CLAIMS, "checks": checks}
    ARTIFACTS.mkdir(exist_ok=True)
    (ARTIFACTS / "torch_fig6_crosslight.json").write_text(
        json.dumps(out, indent=2, default=float))

    if csv:
        for r in rows:
            print(
                f"torch_fig6/{r['cnn']},{us:.1f},"
                f"m/s_L={r['mono_over_siph_latency']:.2f};m/s_EPB={r['mono_over_siph_epb']:.2f};"
                f"e/s_L={r['elec_over_siph_latency']:.2f};e/s_EPB={r['elec_over_siph_epb']:.2f}"
            )
        for k in PAPER_CLAIMS:
            print(f"torch_fig6/avg/{k},{us:.1f},{avg[k]:.2f} (paper {PAPER_CLAIMS[k]})")
        for k, v in checks.items():
            print(f"torch_fig6/check/{k},{us:.1f},{'PASS' if v else 'FAIL'}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args().device)
