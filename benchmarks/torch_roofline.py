"""Roofline table: per (arch x shape x mesh) cell, the three terms of the
compiled dry-run, the dominant bottleneck, MFU bound, and the
MODEL_FLOPS/HLO_FLOPS useful-compute ratio; each measured cell re-priced
under the fabric presets in `FABRIC_NAMES` (metallic ICI baseline vs
photonic interposer designs); and the photonic-accelerator roofline (paper
Sec. V decomposition): per (accelerator variant x CNN) the compute /
interposer-network / memory terms and the dominant bottleneck, through the
batched accelerator evaluator (`core.accelerator.evaluate_accelerator_batch`).

The PyTorch port's counterpart of `benchmarks/roofline.py`, section by
section.  The dry-run cells are the port's own dry-run's
(`repro_torch.launch.dryrun`: one rank of the production mesh over a
fake process group), read from `artifacts/torch_dryrun/*.json` (`run(
artifacts=)` another directory); the repository holds none, so on a fresh
checkout `n_ok` is 0 until `python -m repro_torch.launch.dryrun` writes
them.  The photonic roofline runs in float64 on ``device`` (default
"cuda"); the fabric pricing is host arithmetic over the reference's
modelled TPU-class chip, not a measurement of the card.  Writes
`artifacts/torch_roofline.json` (the run's output).

    PYTHONPATH=src python benchmarks/torch_roofline.py [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.core import (
    CNN_WORKLOADS,
    crosslight_25d_elec,
    crosslight_25d_siph,
    evaluate_accelerator_batch,
    get_fabric,
    monolithic_crosslight,
)
from repro_torch.launch.hlo_analysis import PEAK_FLOPS

ARTIFACTS = Path(__file__).resolve().parent / "artifacts" / "torch_dryrun"
OUT = Path(__file__).resolve().parent / "artifacts" / "torch_roofline.json"

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_cells(mesh: str | None = None, include_tagged: bool = False, artifacts=None):
    """Baseline cells are `<arch>__<shape>__<mesh>.json`; variants carry an
    extra `__<tag>` suffix and are left out unless `include_tagged`.
    `artifacts`: the directory (default `ARTIFACTS`)."""
    cells = []
    for f in sorted(Path(artifacts or ARTIFACTS).glob("*.json")):
        parts = f.stem.split("__")
        tag = parts[3] if len(parts) > 3 else ""
        if tag and not include_tagged:
            continue
        r = json.loads(f.read_text())
        r["tag"] = tag
        if mesh and r.get("mesh") != mesh:
            continue
        cells.append(r)
    cells.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])
                              if r["shape"] in SHAPE_ORDER else 9,
                              r["mesh"], r.get("tag", "")))
    return cells


def mfu_bound(r) -> float:
    """Fraction of chip peak the cell could reach if the step ran at its
    dominant roofline term: useful_time / bound_time."""
    rf = r["roofline"]
    bound = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
    useful = rf["model_flops"] / PEAK_FLOPS
    return useful / bound if bound > 0 else 0.0


def summarize(r) -> dict:
    rf = r["roofline"]
    return {
        "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
        "tag": r.get("tag", ""),
        "compute_ms": rf["compute_s"] * 1e3,
        "memory_ms": rf["memory_s"] * 1e3,
        "collective_ms": rf["collective_s"] * 1e3,
        "bottleneck": rf["bottleneck"],
        "mfu_bound": mfu_bound(r),
        "useful_flops_frac": rf["useful_flops_frac"],
        "args_gib": (r["memory"]["argument_size_in_bytes"] or 0) / 2 ** 30,
        "compile_s": r.get("compile_s", 0),
    }


def markdown_table(mesh="single") -> str:
    rows = ["| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
            "bottleneck | MFU bound | useful-FLOPs | args GiB/dev |",
            "|---|---|---:|---:|---:|---|---:|---:|---:|"]
    for r in load_cells(mesh):
        if r["status"] == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"SKIP ({r['skip_reason'][:40]}…) | — | — | — |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | ERROR | — | — | — |")
            continue
        s = summarize(r)
        rows.append(
            f"| {s['arch']} | {s['shape']} | {s['compute_ms']:.1f} | "
            f"{s['memory_ms']:.1f} | {s['collective_ms']:.1f} | "
            f"**{s['bottleneck']}** | {s['mfu_bound']:.3f} | "
            f"{s['useful_flops_frac']:.2f} | {s['args_gib']:.2f} |")
    return "\n".join(rows)


FABRIC_NAMES = ("metallic_ici", "trine_siph", "tree_siph")


def fabric_terms(r, fabric) -> dict:
    """Re-price one measured dry-run cell under a different fabric: the same
    FLOPs and bytes, the three roofline denominators from the fabric's link
    model.  `fabric` is anything `core.fabric.get_fabric` accepts."""
    fb = get_fabric(fabric)
    rf = r["roofline"]
    n_coll = float(sum(r.get("collective_op_counts", {}).values()))
    compute_s = rf["flops"] / fb.peak_flops
    memory_s = rf["hbm_bytes"] / fb.hbm_bw_bytes_per_s
    collective_s = fb.collective_s(rf["collective_bytes"], n_coll)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bound = max(terms.values())
    useful = rf["model_flops"] / fb.peak_flops
    return {
        "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
        "fabric": fb.name,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s,
        "bottleneck": max(terms, key=terms.get),
        "mfu_bound": useful / bound if bound > 0 else 0.0,
    }


def fabric_cells(cells=None, fabrics=FABRIC_NAMES) -> list:
    """Fabric what-if rows for every ok dry-run cell: cell x fabric terms.
    Empty when no dry-run artifacts exist (`torch_fabric_whatif` covers
    that case with analytic cells)."""
    if cells is None:
        cells = [c for c in load_cells() if c["status"] == "ok"]
    return [fabric_terms(r, f) for r in cells
            if r.get("status", "ok") == "ok" for f in fabrics]


def fabric_markdown_table(rows=None) -> str:
    rows = fabric_cells() if rows is None else rows
    out = ["| arch | shape | fabric | compute (ms) | memory (ms) | "
           "collective (ms) | bottleneck | MFU bound |",
           "|---|---|---|---:|---:|---:|---|---:|"]
    for s in rows:
        out.append(
            f"| {s['arch']} | {s['shape']} | {s['fabric']} | "
            f"{s['compute_s'] * 1e3:.1f} | {s['memory_s'] * 1e3:.1f} | "
            f"{s['collective_s'] * 1e3:.1f} | **{s['bottleneck']}** | "
            f"{s['mfu_bound']:.3f} |")
    return "\n".join(out)


def photonic_roofline(device="cuda") -> list:
    """Per (accelerator variant x CNN): compute / network / memory seconds
    and the dominant term, via the batched accelerator evaluator on
    `device`."""
    accels = [monolithic_crosslight(), crosslight_25d_elec(), crosslight_25d_siph()]
    rows = []
    for name, factory in CNN_WORKLOADS.items():
        wl = factory()
        for a in accels:
            r = evaluate_accelerator_batch(a, wl, device=device)
            terms = {"compute": r.compute_s, "network": r.network_s, "memory": r.memory_s}
            rows.append({
                "accel": a.name, "cnn": wl.name,
                "compute_s": r.compute_s, "network_s": r.network_s,
                "memory_s": r.memory_s, "latency_s": r.latency_s,
                "bottleneck": max(terms, key=terms.get),
            })
    return rows


def photonic_markdown_table(photonic) -> str:
    rows = ["| accelerator | cnn | compute (ms) | network (ms) | memory (ms) | bottleneck |",
            "|---|---|---:|---:|---:|---|"]
    for r in photonic:
        rows.append(
            f"| {r['accel']} | {r['cnn']} | {r['compute_s'] * 1e3:.3f} | "
            f"{r['network_s'] * 1e3:.3f} | {r['memory_s'] * 1e3:.3f} | "
            f"**{r['bottleneck']}** |")
    return "\n".join(rows)


def run(csv: bool = True, device="cuda", artifacts=None) -> dict:
    cells = load_cells(artifacts=artifacts)
    ok = [c for c in cells if c["status"] == "ok"]
    skip = [c for c in cells if c["status"] == "skip"]
    err = [c for c in cells if c["status"] not in ("ok", "skip")]
    photonic = photonic_roofline(device)
    fabric = fabric_cells(ok)
    out = {"n_ok": len(ok), "n_skip": len(skip), "n_err": len(err),
           "photonic": photonic, "fabric": fabric}
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(out, indent=1))
    if csv:
        for s in fabric:
            print(f"roofline/fabric/{s['arch']}/{s['shape']}/{s['fabric']},0,"
                  f"col={s['collective_s'] * 1e3:.1f}ms;"
                  f"bot={s['bottleneck']};mfu_bound={s['mfu_bound']:.3f}")
        for r in photonic:
            print(f"roofline/photonic/{r['accel']}/{r['cnn']},0,"
                  f"cmp={r['compute_s'] * 1e3:.3f}ms;"
                  f"net={r['network_s'] * 1e3:.3f}ms;"
                  f"mem={r['memory_s'] * 1e3:.3f}ms;bot={r['bottleneck']}")
        for r in ok:
            s = summarize(r)
            cell = f"{s['arch']}/{s['shape']}/{s['mesh']}"
            if s["tag"]:
                cell += f"+{s['tag']}"
            print(f"roofline/{cell},"
                  f"{s['compile_s']*1e6:.0f},"
                  f"cmp={s['compute_ms']:.1f}ms;mem={s['memory_ms']:.1f}ms;"
                  f"col={s['collective_ms']:.1f}ms;bot={s['bottleneck']};"
                  f"mfu_bound={s['mfu_bound']:.3f}")
        for r in skip:
            print(f"roofline/{r['arch']}/{r['shape']}/{r['mesh']},0,SKIP")
        for r in err:
            print(f"roofline/{r['arch']}/{r['shape']}/{r['mesh']},0,ERROR")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    _out = run(device=ap.parse_args().device)
    print()
    print(markdown_table("single"))
    if _out["fabric"]:
        print()
        print(fabric_markdown_table(_out["fabric"]))
    print()
    print(photonic_markdown_table(_out["photonic"]))
