"""Sweep-engine throughput benchmark: configs/sec of the scalar per-config
dataclass loop vs the batched struct-of-arrays path (core.sweep), on the same
design-space grid, plus an element-for-element output parity check.  Also
times the device-pipelined streaming path (device mixed-radix decode +
depth-2 prefetch) and requires its running argmin to be bit-identical to the
monolithic sweep.

The acceptance bar for the batched engine is >= 20x configs/sec over the
scalar loop on a >= 4096-point grid.  REPRO_SMOKE=1 shrinks the grid (and the
scalar sample) so the CI smoke test finishes in a couple of seconds.

The PyTorch port's counterpart of `benchmarks/sweep_bench.py`: the same grid,
timings and checks from `repro_torch.core`, the batched and streaming paths
on ``device`` (default "cuda", float64), the scalar loop on the host.  The
streaming path's columns are decoded on the device.  Writes
`artifacts/torch_sweep_bench.json`.

    PYTHONPATH=src python benchmarks/torch_sweep_bench.py [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from repro_torch.core import CNN_WORKLOADS
from repro_torch.core.sweep import (MinReducer, sweep, sweep_chunked,
                                    sweep_scalar_reference)
from repro_torch.env import smoke_mode

ARTIFACTS = Path(__file__).resolve().parent / "artifacts"

TOPOLOGIES = ("sprint", "spacx", "tree", "trine")

# 4 topologies x 8 x 4 x 4 x 2 x 2 x 2 = 8192 configurations
FULL_AXES = dict(
    n_gateways=(8, 16, 24, 32, 40, 48, 56, 64),
    n_lambda=(2, 4, 8, 16),
    mem_bw_bytes_per_s=(25e9, 50e9, 100e9, 200e9),
    modulation_rate_bps=(10e9, 12e9),
    interposer_side_cm=(2.0, 4.0),
)
FULL_AXES["mzi.insertion_loss_db"] = (0.5, 1.0)

# large enough that dispatch overhead doesn't swamp the batched path,
# small enough that the scalar loop stays CI-cheap (~200 configs)
SMOKE_AXES = dict(
    n_gateways=(8, 16, 32, 64),
    n_lambda=(2, 4, 8, 16),
    mem_bw_bytes_per_s=(50e9, 100e9, 200e9),
)

SPEEDUP_BAR = 20.0
SMOKE_SPEEDUP_BAR = 2.0


def run(csv: bool = True, smoke: bool = None, device="cuda") -> dict:
    if smoke is None:
        smoke = smoke_mode()
    axes = SMOKE_AXES if smoke else FULL_AXES
    traffic = CNN_WORKLOADS["ResNet18"]().traffic()

    # warm up (allocator, device context) so the batched timing is
    # steady-state throughput; `sweep` returns host arrays, so it has
    # waited for the device when it returns
    res = sweep(traffic, topologies=TOPOLOGIES, device=device, **axes)
    n = res.grid.n

    t0 = time.perf_counter()
    res = sweep(traffic, topologies=TOPOLOGIES, device=device, **axes)
    batched_s = time.perf_counter() - t0
    batched_cps = n / batched_s

    # device-pipelined streaming over the same grid (device decode, depth-2
    # prefetch): bounded memory at batched-comparable throughput, and the
    # running argmin must be bit-identical to the monolithic sweep
    chunk = max(1, n // 8)

    def _stream():
        return sweep_chunked(traffic, MinReducer("energy_j"),
                             topologies=TOPOLOGIES, chunk_size=chunk,
                             materialize="device", prefetch=2,
                             device=device, **axes)

    best = _stream()  # warm up at the chunk shape
    t0 = time.perf_counter()
    best = _stream()
    pipelined_s = time.perf_counter() - t0
    pipelined_cps = n / pipelined_s

    # scalar loop over the identical grid (subsampled axes in smoke mode only)
    t0 = time.perf_counter()
    ref = sweep_scalar_reference(traffic, topologies=TOPOLOGIES, **axes)
    scalar_s = time.perf_counter() - t0
    scalar_cps = n / scalar_s

    speedup = batched_cps / scalar_cps
    max_rel = max(
        float(np.max(np.abs(res.metrics[k] - ref[k])
                     / np.maximum(np.abs(ref[k]), 1e-30)))
        for k in res.metrics)

    bar = SMOKE_SPEEDUP_BAR if smoke else SPEEDUP_BAR
    # every check reports the grid that actually ran; smoke mode is flagged
    # and exempts the grid-size expectation via `required_checks`, never by
    # rewriting the check itself
    checks = {
        "grid_at_least_4096": n >= 4096,
        "speedup_over_bar": speedup >= bar,
        "batched_matches_scalar": max_rel < 1e-4,
        # the streaming pipeline's argmin is bit-identical to the monolithic
        # sweep (required in both modes — scheduling never changes results)
        "pipelined_matches_batched": bool(
            best["value"] == res.metrics["energy_j"][best["index"]]
            and best["index"] == int(np.argmin(res.metrics["energy_j"]))),
    }
    required = [k for k in checks if not (smoke and k == "grid_at_least_4096")]
    out = {
        "n_configs": n,
        "batched_s": batched_s,
        "scalar_s": scalar_s,
        "batched_configs_per_s": batched_cps,
        "scalar_configs_per_s": scalar_cps,
        "pipelined_s": pipelined_s,
        "pipelined_configs_per_s": pipelined_cps,
        "pipeline_chunk_size": chunk,
        "speedup": speedup,
        "speedup_bar": bar,
        "max_rel_err": max_rel,
        "smoke": smoke,
        "checks": checks,
        "required_checks": required,
        "pass": all(checks[k] for k in required),
    }

    ARTIFACTS.mkdir(exist_ok=True)
    (ARTIFACTS / "torch_sweep_bench.json").write_text(
        json.dumps(out, indent=2, default=float))

    if csv:
        print(f"torch_sweep/batched,{batched_s * 1e6 / n:.2f},"
              f"{batched_cps:,.0f} cfg/s over {n} configs")
        print(f"torch_sweep/pipelined,{pipelined_s * 1e6 / n:.2f},"
              f"{pipelined_cps:,.0f} cfg/s streaming (chunk {chunk}, "
              f"depth 2)")
        print(f"torch_sweep/scalar,{scalar_s * 1e6 / n:.2f},"
              f"{scalar_cps:,.0f} cfg/s over {n} configs")
        print(f"torch_sweep/speedup,0,{speedup:.1f}x (bar {bar:.0f}x);"
              f"max_rel_err={max_rel:.2e}")
        for k, v in checks.items():
            flag = "PASS" if v else ("FAIL" if k in required
                                     else "SKIP(smoke)")
            print(f"torch_sweep/check/{k},0,{flag}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args().device)
