"""Fabric what-if: re-rank interposer-network design points by estimated
END-TO-END train/serve step time instead of raw network EDP.

This is the search -> system loop closed: `core.search.codesign_pareto`
finds the network-EDP frontier (Layer A), `core.fabric` converts each
frontier row into a link model, and this benchmark prices every
(arch x shape) roofline cell under every fabric through the same
`launch.hlo_analysis.roofline`, so that a network co-design choice
visibly moves a training/serving bottleneck.

Cells are analytic (arch x shape) workload estimates on the production
(2, 16, 16) 512-chip mesh: per-device MODEL_FLOPS (6ND train / 2ND
inference, `launch.dryrun.model_flops_per_device`), an HBM traffic model
(weights + optimizer state or KV cache), and collective wire bytes from
the ring-algorithm estimate (`parallel.collectives`).  The chip priced is
the reference's modelled TPU-class chip (197 TFLOP/s, 819 GB/s, its
metallic and photonic links): nothing here measures the card.

Emits artifacts/torch_fabric_whatif.json:
  fabrics   link model of every fabric evaluated (>= 3: metallic baseline,
            photonic presets, deduped co-design frontier points)
  cells     the per-(arch x shape) workload terms (fabric-independent)
  results   one row per cell x fabric: compute/memory/collective seconds,
            step time (max term), bottleneck, MFU bound, collective energy
  ranking   fabrics by geometric-mean step time across cells
  checks    schema/quality gates

The PyTorch port's counterpart of `benchmarks/fabric_whatif.py`, section by
section: the co-design search that yields the frontier fabrics runs in
float64 on ``device`` (default "cuda"); the pricing is host arithmetic.

    PYTHONPATH=src python benchmarks/torch_fabric_whatif.py [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import numpy as np

from repro_torch import configs as C
from repro_torch.core import ChipletSpec
from repro_torch.core.fabric import Fabric, fabrics_from_front, get_fabric
from repro_torch.core.search import codesign_pareto
from repro_torch.core.workloads import CNN_WORKLOADS
from repro_torch.env import smoke_mode
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.dryrun import model_flops_per_device
from repro_torch.parallel.collectives import MeshGeometry, collective_bytes_estimate

ARTIFACTS = Path(__file__).resolve().parent / "artifacts"

# production mesh geometry (pod, data, model): 512 chips
MESH_SHAPE = (2, 16, 16)


_MESH = MeshGeometry(MESH_SHAPE, ("pod", "data", "model"))
_N_DEV = int(np.prod(MESH_SHAPE))

ARCHS_FULL = ("yi_6b", "yi_34b", "deepseek_67b", "grok1_314b")
SHAPES_FULL = ("train_4k", "prefill_32k", "decode_32k")
ARCHS_SMOKE = ("yi_6b", "yi_34b")
SHAPES_SMOKE = ("train_4k", "prefill_32k", "decode_32k")


def analytic_cell(arch: str, shape_name: str) -> dict:
    """Fabric-independent workload terms of one (arch x shape) cell."""
    cfg = C.get(arch)
    shape = C.SHAPES[shape_name]
    n_params = cfg.param_count()
    flops = model_flops_per_device(cfg, shape, _N_DEV)
    w_bytes = 2.0 * n_params / _N_DEV              # bf16 weights, sharded

    n_pod, n_data, n_model = MESH_SHAPE
    if shape.kind == "train":
        # weights read + grads written (bf16) + Adam m/v read+written (f32)
        hbm = w_bytes * (1 + 1 + 2 * (4 / 2) * 2)
        # per-device gradient sync (bf16, FSDP over pod x data = 256 ranks)
        per_dev = n_params / (n_pod * n_data * n_model) * n_model
        est = collective_bytes_estimate(int(per_dev), 2, _MESH, "trine")
        coll_bytes = est["total_bytes"]
        n_coll = 3                                  # RS / cross-pod / AG
    else:
        b_local = max(1, shape.global_batch // n_data)
        seq = shape.seq_len if shape.kind == "prefill" else 1
        act_elems = b_local * seq * cfg.d_model
        # two TP all-reduces per layer over the model axis (ring factor),
        # plus the sampled-token logits all-reduce over the sharded vocab
        ring = 2.0 * (n_model - 1) / n_model
        coll_bytes = (cfg.n_layers * 2 * ring * act_elems * 2
                      + ring * b_local * cfg.vocab * 2)
        n_coll = cfg.n_layers * 2 + 1
        kv = (shape.global_batch * shape.seq_len * cfg.n_layers
              * 2 * cfg.n_kv_heads * cfg.head_dim_ * 2) / _N_DEV
        hbm = w_bytes + (kv if shape.kind == "decode" else act_elems * 2 * 4)
    return {
        "arch": arch, "shape": shape_name,
        "model_flops_per_device": flops,
        "hbm_bytes": hbm,
        "collective_bytes": coll_bytes,
        "n_collectives": n_coll,
    }


def cell_stats(cell: dict) -> H.HloStats:
    """A cell's analytic terms as HloStats, so that the same roofline
    function prices measured and analytic cells."""
    return H.HloStats(
        dot_flops=cell["model_flops_per_device"], dot_bytes=0.0,
        op_result_bytes=0.0, collective_bytes=cell["collective_bytes"],
        collective_op_bytes={},
        collective_op_counts={"all-reduce": int(cell["n_collectives"])},
        max_trip=1, collective_bytes_raw=cell["collective_bytes"])


def price_cell(cell: dict, fabric: Fabric) -> dict:
    rf = H.roofline(cell_stats(cell), {}, cell["model_flops_per_device"],
                    io_bytes=cell["hbm_bytes"], fabric=fabric)
    step_s = max(rf.compute_s, rf.memory_s, rf.collective_s)
    return {
        "arch": cell["arch"], "shape": cell["shape"], "fabric": fabric.name,
        "compute_s": rf.compute_s, "memory_s": rf.memory_s,
        "collective_s": rf.collective_s, "step_s": step_s,
        "bottleneck": rf.bottleneck,
        "mfu_bound": (rf.compute_s / step_s) if step_s > 0 else 0.0,
        "collective_energy_j": fabric.collective_energy_j(cell["collective_bytes"]),
    }


def frontier_fabrics(smoke: bool, device="cuda"):
    """Co-design Pareto frontier (searched on `device`) -> deduped Fabrics
    (the what-if inputs).  The grid spans slow (tree, few lambda) and fast
    (trine, wide WDM, high memory bandwidth) designs so the frontier
    brackets the metallic baseline from both sides."""
    wl = CNN_WORKLOADS["ResNet18"]()
    mixes = [[ChipletSpec(512, 32)]]
    if smoke:
        axes = dict(n_lambda=(2.0, 8.0), mem_bw_bytes_per_s=(6.25e9, 100e9))
        chunk = 16
    else:
        axes = dict(n_lambda=(2.0, 4.0, 8.0, 16.0),
                    mem_bw_bytes_per_s=(6.25e9, 25e9, 100e9, 200e9),
                    modulation_rate_bps=(8e9, 12e9))
        chunk = 4096
    front, spec = codesign_pareto(wl, mixes, topologies=("tree", "trine"),
                                  chunk_size=chunk, device=device, **axes)
    fabs = fabrics_from_front(front, spec, mixes=mixes, max_fabrics=4 if smoke else 8)
    return front, spec, fabs


def _geomean(xs) -> float:
    return float(math.exp(np.mean(np.log(np.maximum(xs, 1e-300)))))


def run(csv: bool = True, smoke: bool | None = None, device="cuda") -> dict:
    smoke = smoke_mode() if smoke is None else smoke
    archs = ARCHS_SMOKE if smoke else ARCHS_FULL
    shapes = SHAPES_SMOKE if smoke else SHAPES_FULL

    t0 = time.perf_counter()
    cells = [analytic_cell(a, s) for a in archs for s in shapes]

    front, spec, pareto_fabs = frontier_fabrics(smoke, device)
    presets = [get_fabric(n) for n in ("metallic_ici", "trine_siph", "tree_siph", "elec_mesh")]
    fabrics = presets + pareto_fabs

    results = [price_cell(c, f) for c in cells for f in fabrics]
    by_fab = {f.name: [r for r in results if r["fabric"] == f.name] for f in fabrics}
    ranking = sorted(
        ({"fabric": name, "geomean_step_s": _geomean([r["step_s"] for r in rows])}
         for name, rows in by_fab.items()),
        key=lambda r: r["geomean_step_s"])
    frontier_ranking = [r["fabric"] for r in ranking if r["fabric"].startswith("pareto:")]

    base = {(r["arch"], r["shape"]): r for r in by_fab["metallic_ici"]}

    def flips(rows):
        """(arch, shape, fabric, metallic bottleneck -> this bottleneck)."""
        return [
            (r["arch"], r["shape"], r["fabric"],
             base[(r["arch"], r["shape"])]["bottleneck"], r["bottleneck"])
            for r in rows
            if r["bottleneck"] != base[(r["arch"], r["shape"])]["bottleneck"]]

    preset_flips = [fl for f in presets[1:] for fl in flips(by_fab[f.name])]
    frontier_flips = [fl for f in pareto_fabs for fl in flips(by_fab[f.name])]

    # monotonicity spot check: trine_siph's cross-pod link is ~2x metallic's,
    # so its collective term must be strictly smaller on every cell
    trine = {(r["arch"], r["shape"]): r for r in by_fab["trine_siph"]}
    mono = all(trine[k]["collective_s"] < base[k]["collective_s"] for k in base)

    frontier_idx = {int(f.name.rsplit("@", 1)[1]) for f in pareto_fabs}
    subset = frontier_idx <= {int(i) for i in front.indices}

    checks = {
        "n_fabrics_ge_3": len(fabrics) >= 3,
        "has_frontier_fabric": len(pareto_fabs) >= 1,
        "bottleneck_flip_vs_metallic": len(preset_flips) + len(frontier_flips) >= 1,
        "bottleneck_flip_frontier_fabric": len(frontier_flips) >= 1,
        "collective_s_monotone_in_bw": mono,
        "ranked_frontier_subset_of_edp_front": subset,
        "all_terms_finite": all(
            np.isfinite([r["compute_s"], r["memory_s"], r["collective_s"]]).all()
            for r in results),
    }
    elapsed = time.perf_counter() - t0

    out = {
        "smoke": smoke,
        "mesh_shape": list(MESH_SHAPE),
        "fabrics": [{
            "name": f.name,
            "kind": "frontier" if f.name.startswith("pareto:") else "preset",
            "cross_pod_bw_bytes_per_s": f.cross_pod_bw_bytes_per_s,
            "intra_pod_bw_bytes_per_s": f.intra_pod_bw_bytes_per_s,
            "link_latency_s": f.link_latency_s,
            "energy_per_bit_j": f.energy_per_bit_j,
            "source": f.source,
        } for f in fabrics],
        "cells": cells,
        "results": results,
        "ranking": ranking,
        "frontier_ranking": frontier_ranking,
        "edp_front_size": front.size,
        "checks": checks,
        "required_checks": list(checks),
        "pass": all(checks.values()),
        "elapsed_s": elapsed,
    }
    ARTIFACTS.mkdir(exist_ok=True)
    (ARTIFACTS / "torch_fabric_whatif.json").write_text(json.dumps(out, indent=1))

    if csv:
        us = elapsed * 1e6 / max(1, len(results))
        for r in ranking:
            print(f"fabric_whatif/rank/{r['fabric']},{us:.1f},"
                  f"geomean_step={r['geomean_step_s'] * 1e3:.3f}ms")
        for a, s, fab, old, new in (preset_flips + frontier_flips)[:8]:
            print(f"fabric_whatif/flip/{a}/{s}/{fab},0,{old}->{new}")
        print(f"fabric_whatif/pass,0,{'PASS' if out['pass'] else 'FAIL'}")
    return out


def markdown_table(out: dict) -> str:
    """Per-cell summary: step time + bottleneck under each fabric."""
    fabs = [f["name"] for f in out["fabrics"]]
    by = {(r["arch"], r["shape"], r["fabric"]): r for r in out["results"]}
    rows = ["| arch | shape | " + " | ".join(fabs) + " |",
            "|---|---|" + "---|" * len(fabs)]
    for c in out["cells"]:
        vals = []
        for f in fabs:
            r = by[(c["arch"], c["shape"], f)]
            vals.append(f"{r['step_s'] * 1e3:.2f}ms ({r['bottleneck'][:4]})")
        rows.append(f"| {c['arch']} | {c['shape']} | " + " | ".join(vals) + " |")
    return "\n".join(rows)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    _out = run(device=ap.parse_args().device)
    print()
    print(markdown_table(_out))
