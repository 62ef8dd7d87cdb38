"""Collective-schedule benchmark (paper Layer-B validation): cross-pod bytes
of the flat (bus-analog) vs TRINE hierarchical vs TRINE+int8 gradient
all-reduce, on the production multi-pod mesh geometry.

Analytical on the (2,16,16) 512-chip mesh (ring-algorithm byte accounting,
`parallel.collectives.collective_bytes_estimate`), for representative
gradient sizes of the assigned archs.

Cross-pod serialization times are priced per fabric (`FABRIC_NAMES` presets
from `core.fabric`): the `*_time_s` columns price the metallic ICI
baseline (`DEFAULT_FABRIC`), and each schedule also gets
`{schedule}_time_{fabric}_s` columns including per-hop link latency, so
the schedule choice and the link design point can be traded off in one
table.  The fabrics are the reference's modelled TPU-class chip and links:
nothing here measures the card.

The PyTorch port's counterpart of `benchmarks/collectives_bench.py`: the
same rows from `repro_torch`.  The byte model and the pricing are host
arithmetic: nothing runs on a device, so the bench takes none and runs
anywhere.  Writes `artifacts/torch_collectives.json`.

    PYTHONPATH=src python benchmarks/torch_collectives_bench.py
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from repro_torch.core.fabric import DEFAULT_FABRIC, get_fabric
from repro_torch.parallel.collectives import MeshGeometry, collective_bytes_estimate

ARTIFACTS = Path(__file__).resolve().parent / "artifacts"


GRAD_SIZES = {
    "yi-6b": 6.1e9,
    "yi-34b": 34.4e9,
    "deepseek-67b": 67.4e9,
    "grok-1-314b": 314e9,
}

FABRIC_NAMES = ("metallic_ici", "trine_siph", "tree_siph")

# cross-pod hop count per schedule (for the fabric link-latency term):
# flat = one global AR; trine = the cross-pod AR stage; trine_int8 = the
# int8-payload + f32-scale gathers of the cross-pod stage.
_N_CROSS_HOPS = {"flat": 1, "trine": 1, "trine_int8": 2}


def run(csv: bool = True) -> dict:
    mesh = MeshGeometry((2, 16, 16), ("pod", "data", "model"))
    fabrics = [get_fabric(f) for f in FABRIC_NAMES]
    rows = []
    t0 = time.perf_counter()
    for arch, n in GRAD_SIZES.items():
        per_dev = n / 256  # FSDP-sharded grads within a pod (bf16)
        ests = {s: collective_bytes_estimate(int(per_dev), 2, mesh, s)
                for s in ("flat", "trine", "trine_int8")}
        row = {"arch": arch}
        for s, e in ests.items():
            row[f"{s}_cross_pod_gb"] = e["cross_pod_bytes"] / 1e9
            row[f"{s}_time_s"] = e["cross_pod_bytes"] / DEFAULT_FABRIC.cross_pod_bw_bytes_per_s
            for fb in fabrics:
                row[f"{s}_time_{fb.name}_s"] = fb.collective_s(e["cross_pod_bytes"],
                                                              _N_CROSS_HOPS[s])
        row["trine_speedup"] = (ests["flat"]["cross_pod_bytes"]
                                / max(ests["trine"]["cross_pod_bytes"], 1))
        row["int8_speedup"] = (ests["flat"]["cross_pod_bytes"]
                               / max(ests["trine_int8"]["cross_pod_bytes"], 1))
        rows.append(row)
    us = (time.perf_counter() - t0) * 1e6 / len(rows)

    out = {"rows": rows}
    ARTIFACTS.mkdir(exist_ok=True)
    (ARTIFACTS / "torch_collectives.json").write_text(json.dumps(out, indent=1))
    if csv:
        for r in rows:
            print(f"collectives/{r['arch']},{us:.1f},"
                  f"flat={r['flat_cross_pod_gb']:.3f}GB;"
                  f"trine={r['trine_cross_pod_gb']:.3f}GB;"
                  f"int8={r['trine_int8_cross_pod_gb']:.3f}GB;"
                  f"speedup={r['trine_speedup']:.1f}x/{r['int8_speedup']:.1f}x;"
                  f"int8_trine_siph={r['trine_int8_time_trine_siph_s']*1e3:.2f}ms")
    return out


if __name__ == "__main__":
    run()
