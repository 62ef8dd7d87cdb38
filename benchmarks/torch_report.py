"""Render the port's dry-run records (`artifacts/torch_dryrun/*.json`, written
by `python -m repro_torch.launch.dryrun`) as the tables of the reference's
`benchmarks/report.py`, into `artifacts/torch_experiments.md` (never into
`EXPERIMENTS.md`, which holds the JAX package's tables).

  PYTHONPATH=src python -m benchmarks.torch_report

The terms are counts of what one rank dispatches under `FakeTensorMode`,
priced on `core/fabric.py`'s modelled TPU-class chip: `PEAK` is that
chip's rate, not an H100's, and no number here is a time of a card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.torch_roofline import ARTIFACTS, load_cells, mfu_bound, summarize  # noqa: E402
from repro_torch.launch.hlo_analysis import PEAK_FLOPS as PEAK  # noqa: E402,F401  (197e12)

TARGET = Path(__file__).resolve().parent / "artifacts" / "torch_experiments.md"
MARK = "<!-- GENERATED TABLES (python -m benchmarks.torch_report) -->"
HEADER = (
    "# The port's dry-run tables\n\n"
    "Regenerated from the port's dry-run records (`benchmarks/artifacts/"
    "torch_dryrun/`) by `python -m benchmarks.torch_report`.  Each term counts "
    "what one rank of the production mesh dispatches under `FakeTensorMode`, "
    "priced on the modelled TPU-class chip of `src/repro_torch/core/fabric.py` "
    "(PEAK = 197e12 FLOP/s is that chip's rate, not the H100's).  No number "
    "below is a time measured on a card.\n\n")


def table(mesh: str, include_tagged=False, artifacts=None) -> str:
    rows = [
        "| arch | shape | strategy | compute (s) | memory (s) | collective (s) "
        "| bottleneck | MFU bound | useful-FLOPs | args GiB/dev |",
        "|---|---|---|---:|---:|---:|---|---:|---:|---:|",
    ]
    for r in load_cells(mesh, include_tagged=include_tagged, artifacts=artifacts):
        tag = r.get("tag", "")
        strat = r.get("strategy", "") + (f"+{tag}" if tag else "")
        if r["status"] == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                        f"SKIP (sub-quadratic attn required) | — | — | — |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {strat} | — | — | — | "
                        f"**ERROR** | — | — | — |")
            continue
        s = summarize(r)
        rows.append(
            f"| {s['arch']} | {s['shape']} | {strat} | {s['compute_ms']/1e3:.3f} | "
            f"{s['memory_ms']/1e3:.3f} | {s['collective_ms']/1e3:.3f} | "
            f"**{s['bottleneck']}** | {mfu_bound(r):.3f} | "
            f"{s['useful_flops_frac']:.2f} | {s['args_gib']:.2f} |")
    return "\n".join(rows)


def perf_table(artifacts=None) -> str:
    """The tag variants of the three hill-climbed cells."""
    cells = [
        ("deepseek_67b", ["", "fsdp_all", "fsdp_all_dots", "fsdp_all_dots_w8"]),
        ("yi_34b", ["", "fsdp_all", "fsdp_all_dots", "fsdp_all_dots_w8"]),
        ("zamba2_1p2b", ["", "fsdp_all", "fsdp_all_dots", "fsdp_all_dots_w8",
                         "fsdp_all_dotsall_w8"]),
    ]
    rows = ["| cell | variant | compute (s) | memory (s) | collective (s) | "
            "bottleneck | MFU bound | useful-FLOPs |",
            "|---|---|---:|---:|---:|---|---:|---:|"]
    for arch, tags in cells:
        for tag in tags:
            name = f"{arch}__train_4k__single" + (f"__{tag}" if tag else "")
            p = Path(artifacts or ARTIFACTS) / f"{name}.json"
            if not p.exists():
                continue
            r = json.loads(p.read_text())
            if r["status"] != "ok":
                continue
            rf = r["roofline"]
            label = tag or "baseline (tp_fsdp)"
            rows.append(
                f"| {arch}/train_4k | {label} | {rf['compute_s']:.3f} | "
                f"{rf['memory_s']:.3f} | {rf['collective_s']:.3f} | "
                f"**{rf['bottleneck']}** | {mfu_bound(r):.3f} | "
                f"{rf['useful_flops_frac']:.2f} |")
    return "\n".join(rows)


def main(path: Path = None, artifacts=None):
    """Regenerate the generated-tables section of `path` (default
    `TARGET`) from the records in `artifacts` (default `ARTIFACTS`).  A
    missing target is created with `HEADER` and `MARK`; prose above the
    mark is kept, and with no records the tables render header-only."""
    target = TARGET if path is None else Path(path)
    body = [MARK, ""]
    body.append("### §Perf final table — the three hillclimbed cells "
                "(single pod, 256 ranks)\n")
    body.append(perf_table(artifacts))
    body.append("\n### §Roofline — single-pod baselines (paper-faithful "
                "strategy per arch)\n")
    body.append(table("single", artifacts=artifacts))
    body.append("\n### §Roofline — multi-pod (2×16×16 = 512 ranks), "
                "pod-axis proof\n")
    body.append(table("multi", artifacts=artifacts))
    text = target.read_text() if target.exists() else HEADER + MARK + "\n"
    head = text.split(MARK)[0].rstrip()
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(head + "\n\n" + "\n".join(body) + "\n")
    print(f"wrote generated tables into {target}")


if __name__ == "__main__":
    main()
