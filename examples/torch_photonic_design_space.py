"""Design-space exploration of the TRINE interposer network (beyond-paper):
sweep the subnetwork count K and wavelength count per waveguide, and find the
energy-delay-product-optimal configuration for each CNN workload — the
quantitative version of the paper's 'tailor the subnetworks to the memory
bandwidth' argument, plus the MR-resolution (photonic MAC bits) trade-off.

All sections run on the batched sweep engine (repro_torch.core.sweep) in
float64 on ``--device``: the grids below are struct-of-arrays columns
evaluated as tensors, not per-config Python loops.  The closing sections use
the search engine (repro_torch.core.search): a streaming per-workload Pareto
front over the full (topology x gateways x lambda x memory x rate x geometry)
space — evaluated in fixed-size chunks so memory stays bounded no matter the
grid size — a joint network x chiplet-mix co-design front, autograd
refinement of the best frontier point through the continuous columns, and
joint accelerator + network refinement of the co-design frontier
(`refine_codesign`: relaxed descent over per-chiplet n_units/vector_size,
mac_rate_hz and lambda_slot_energy_j alongside the network axes, snapped back
to feasible integer designs and round-tripped into a `core.fabric.Fabric`),
a six-CNN joint trust-region refinement (`refine_trust_region`: second-order
descent + coordinate-wise integer line search against the weighted-geomean
EDP of all six paper CNNs at once), and a fabric what-if that prices one
decode cell's roofline (`launch.hlo_analysis.roofline`) under the metallic
baseline and the frontier's fabrics.

The PyTorch port's counterpart of `examples/photonic_design_space.py`,
section by section and line by line.

  PYTHONPATH=src python examples/torch_photonic_design_space.py [--device cpu]
  REPRO_SMOKE=1 PYTHONPATH=src python examples/torch_photonic_design_space.py  # tiny grids
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import CNN_WORKLOADS, ChipletSpec, NetworkParams, choose_subnetworks
from repro_torch.core.search import (
    codesign_config_at,
    codesign_pareto,
    pareto_search,
    refine_front_point,
)
from repro_torch.core.sweep import grid_spec, sweep
from repro_torch.env import smoke_mode

SMOKE = smoke_mode()


def sweep_subnetworks(device):
    print("=" * 72)
    print("K-sweep: energy-delay product vs subnetwork count (ResNet18)")
    t = CNN_WORKLOADS["ResNet18"]().traffic()
    kstar = choose_subnetworks(NetworkParams())
    ks = (1, 2, 4, 8, 16, 32)
    res = sweep(t, topologies=("trine",), n_subnetworks=ks, device=device)
    edp = res.metrics["energy_j"] * res.metrics["latency_s"]
    for i, k in enumerate(ks):
        tag = " <= paper's choice" if k == kstar else ""
        print(f"  K={k:3d}: latency {res.metrics['latency_s'][i] * 1e3:8.3f} ms  "
              f"energy {res.metrics['energy_j'][i] * 1e3:7.3f} mJ  "
              f"EDP {edp[i] * 1e6:9.4f}{tag}")
    print(f"  EDP-optimal K = {ks[int(np.argmin(edp))]} (bandwidth matching: K*={kstar})")


def sweep_wavelengths(device):
    print("=" * 72)
    print("WDM sweep: wavelengths/waveguide at fixed aggregate bandwidth")
    t = CNN_WORKLOADS["VGG16"]().traffic()
    lams = (4, 8, 16)
    res = sweep(t, topologies=("trine",), n_lambda=lams, device=device)
    for i, n_lambda in enumerate(lams):
        print(f"  {n_lambda:2d} lambda x {int(res.nets['n_laser_banks'][i])} subnets: "
              f"loss {res.nets['worst_path_loss_db'][i]:5.2f} dB, "
              f"laser {res.metrics['laser_power_w'][i] * 1e3:7.1f} mW, "
              f"latency {res.metrics['latency_s'][i] * 1e3:7.3f} ms, "
              f"EPB {res.metrics['energy_per_bit_j'][i] * 1e12:5.2f} pJ/bit")


def sweep_trimming_sensitivity(device):
    print("=" * 72)
    print("Device sensitivity: MR trimming power x2 / MZI loss x2 (TRINE)")
    t = CNN_WORKLOADS["DenseNet121"]().traffic()
    # device leaves are grid axes too: a 2x2 corner sweep in one call
    res = sweep(t, topologies=("trine",), device=device,
                **{"mr.tuning_power_w": (275e-6, 550e-6),
                   "mzi.insertion_loss_db": (1.0, 2.0)})
    p = res.metric("power_w")[0] * 1e3      # (tuning, mzi_loss)
    e = res.metric("energy_j")[0] * 1e3
    print(f"  baseline      : {p[0, 0]:7.1f} mW, {e[0, 0]:7.3f} mJ")
    print(f"  2x trimming   : {p[1, 0]:7.1f} mW, {e[1, 0]:7.3f} mJ")
    print(f"  2x MZI loss   : {p[0, 1]:7.1f} mW, {e[0, 1]:7.3f} mJ "
          f"(loss compounds per stage -> laser grows exponentially)")


def sweep_full_design_space(device):
    print("=" * 72)
    topos = ("sprint", "spacx", "tree", "trine")
    if SMOKE:
        axes = dict(n_gateways=(16, 32), n_lambda=(4, 8))
    else:
        axes = dict(
            n_gateways=(8, 16, 24, 32, 48, 64),
            n_lambda=(2, 4, 8, 16),
            mem_bw_bytes_per_s=(25e9, 50e9, 100e9, 200e9),
            modulation_rate_bps=(8e9, 10e9, 12e9),
            interposer_side_cm=(2.0, 3.0, 4.0),
        )
    n_grid = len(topos) * int(np.prod([len(v) for v in axes.values()]))
    print(f"Full design-space search: {n_grid} configs/workload, batched")
    for name in ("ResNet18", "VGG16") if not SMOKE else ("ResNet18",):
        t = CNN_WORKLOADS[name]().traffic()
        res = sweep(t, topologies=topos, device=device, **axes)
        edp = res.metrics["energy_j"] * res.metrics["latency_s"]
        i = int(np.argmin(edp))
        cfg = res.config_at(i)
        axes_str = ", ".join(
            f"{k}={v:g}" for k, v in cfg.items() if k != "topology")
        print(f"  {name:10s}: EDP-optimal {res.model_at(i).name:9s} "
              f"({axes_str})")
        print(f"  {'':10s}  latency {res.metrics['latency_s'][i] * 1e3:.3f} ms, "
              f"energy {res.metrics['energy_j'][i] * 1e3:.3f} mJ, "
              f"laser {res.metrics['laser_power_w'][i] * 1e3:.1f} mW")


def pareto_and_refine(device):
    """Streaming Pareto frontier + gradient refinement (core.search)."""
    print("=" * 72)
    topos = ("sprint", "spacx", "tree", "trine")
    if SMOKE:
        axes = dict(n_gateways=(16, 32, 64), n_lambda=(4, 8))
        chunk = 8
    else:
        axes = dict(
            n_gateways=(8, 16, 24, 32, 40, 48, 56, 64),
            n_lambda=(2, 4, 8, 16),
            mem_bw_bytes_per_s=(25e9, 50e9, 100e9, 200e9),
            modulation_rate_bps=(8e9, 10e9, 12e9),
            interposer_side_cm=(2.0, 3.0, 4.0),
        )
        chunk = 4096
    spec = grid_spec(topos, **axes)
    names = ("ResNet18",) if SMOKE else ("ResNet18", "VGG16")
    traffics = [CNN_WORKLOADS[n]().traffic() for n in names]
    fronts = pareto_search(traffics, topologies=topos, chunk_size=chunk,
                           device=device, **axes)
    print(f"Streaming Pareto search: {spec.n} configs/workload in "
          f"{chunk}-config chunks (bounded memory)")
    for name, front in zip(names, fronts):
        edp = front.points[:, 0] * front.points[:, 1]  # latency * energy
        i = int(np.argmin(edp))
        cfg = front.configs(spec)[i]
        axes_str = ", ".join(f"{k}={v:g}" for k, v in cfg.items()
                             if k != "topology")
        print(f"  {name:10s}: {front.size:3d} frontier points; best-EDP "
              f"{cfg['topology']} ({axes_str})")
        print(f"  {'':10s}  latency {front.points[i, 0] * 1e3:.3f} ms, "
              f"energy {front.points[i, 1] * 1e3:.3f} mJ, "
              f"power {front.points[i, 2]:.2f} W")

    # descend from the ResNet18 best-EDP point through the continuous axes
    front = fronts[0]
    edp = front.points[:, 0] * front.points[:, 1]
    best = int(front.indices[int(np.argmin(edp))])
    r = refine_front_point(spec, traffics[0], best,
                           steps=8 if SMOKE else 48, lr=0.1, device=device)
    moved = {k: f"{r['start'][k]:.3g}->{v:.3g}"
             for k, v in r["refined"].items()
             if abs(v - r["start"][k]) / r["start"][k] > 1e-3}
    print(f"Gradient refinement (autograd through the {r['topology']} "
          f"kernel): EDP {r['start_value']:.3e} -> {r['refined_value']:.3e} "
          f"({100 * r['improvement']:.1f}% better)")
    print(f"  moved axes: {moved or 'none (already locally optimal)'}")


def codesign_search(device):
    """Joint network x chiplet-mix frontier (paper Sec. V co-design)."""
    print("=" * 72)
    wl = CNN_WORKLOADS["ResNet18"]()
    C = ChipletSpec
    mixes = [
        [C(512, 32)],                                      # homogeneous
        [C(512, 9), C(512, 27), C(512, 49), C(512, 128)],  # paper Fig. 5
        [C(256, 16), C(256, 64), C(256, 256)],
    ]
    if SMOKE:
        axes = dict(n_gateways=(16, 64), n_lambda=(4, 8))
    else:
        axes = dict(n_gateways=(16, 32, 48, 64), n_lambda=(2, 4, 8, 16),
                    mem_bw_bytes_per_s=(50e9, 100e9, 200e9),
                    modulation_rate_bps=(8e9, 12e9))
    front, spec = codesign_pareto(wl, mixes, topologies=("trine", "elec"),
                                  chunk_size=16 if SMOKE else 4096,
                                  device=device, **axes)
    n_joint = spec.n * len(mixes)
    edp = front.points[:, 0] * front.points[:, 1]
    cfg = codesign_config_at(spec, mixes, int(front.indices[int(np.argmin(edp))]))
    vecs = "+".join(str(c.vector_size) for c in cfg["chiplets"])
    print(f"Co-design search (ResNet18): {n_joint} joint (network x "
          f"chiplet-mix) points -> {front.size} frontier points")
    print(f"  best-EDP: {cfg['topology']} interposer, chiplet vecs [{vecs}], "
          f"G={cfg['n_gateways']:g}, lambda={cfg['n_lambda']:g}")
    return front, spec, mixes


def codesign_refine(front, spec, mixes, device):
    """Joint accelerator + network gradient refinement of the co-design
    frontier (core.search.refine_codesign): relax the discrete accelerator
    axes, descend, snap back to feasible integer designs, and round-trip
    the refined winner into a `core.fabric.Fabric` link model."""
    print("=" * 72)
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.search import refine_front

    wl = CNN_WORKLOADS["ResNet18"]()
    out = refine_front(front, spec, mixes, wl, top_k=3,
                       steps=8 if SMOKE else 32, lr=0.1, device=device)
    print("Co-design refinement: top-3 EDP seeds descended jointly over "
          "accelerator + network axes, then round-and-rescored")
    for r in out["results"]:
        seed_v, ref_v = r["seed"]["value"], r["refined"]["value"]
        vecs = "+".join(str(c.vector_size) for c in r["refined"]["chiplets"]
                        if c.n_units > 0)
        print(f"  seed #{r['flat_index']}: EDP {seed_v:.3e} -> {ref_v:.3e} "
              f"({100 * r['improvement']:.1f}% better), "
              f"chiplet vecs [{vecs}]")
    print(f"  merged front: {out['seed_front'].size} -> "
          f"{out['front'].size} points "
          f"({out['n_improved']}/{len(out['results'])} seeds improved)")
    top = sorted(out["sensitivity"].items(), key=lambda kv: -kv[1])[:3]
    print("  most-binding axes (mean |grad| at seed): "
          + ", ".join(f"{k}={v:.3f}" for k, v in top))
    # the refined config dicts round-trip straight into the Fabric bridge
    # (compute-side keys are ignored; network axes override the preset)
    best = min(out["results"], key=lambda r: r["refined"]["value"])
    fb = Fabric.from_config(best["refined"]["config"], name="refined-best")
    print(f"  refined best as Fabric: cross-pod "
          f"{fb.cross_pod_bw_bytes_per_s / 1e9:.1f} GB/s, "
          f"link latency {fb.link_latency_s * 1e9:.0f} ns")


def codesign_refine_six_cnn(front, spec, mixes, device):
    """Trust-region multi-workload refinement: one design, all six CNNs.

    The second-order engine (`refine_trust_region`) refines the best-EDP
    frontier seed against the weighted-geomean EDP of ALL six paper CNNs at
    once — log-space trust-region descent on the relaxed objective, then a
    coordinate-wise integer line search over the discrete axes (per-chiplet
    n_units/vector_size and n_gateways) — so the refined interposer serves
    the whole workload portfolio instead of overfitting one network.  The
    final integer design round-trips into a `core.fabric.Fabric`."""
    print("=" * 72)
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.search import refine_trust_region

    wls = [CNN_WORKLOADS[n]() for n in
           ("DenseNet121", "ResNet18", "LeNet5", "VGG16", "MobileNetV2",
            "EfficientNetB0")]
    edp = front.points[:, 0] * front.points[:, 1]
    seed = int(front.indices[int(np.argmin(edp))])
    r = refine_trust_region(
        spec, mixes, wls, seed, steps=4 if SMOKE else 24,
        refine_axes=("modulation_rate_bps", "mem_bw_bytes_per_s",
                     "interposer_side_cm", "n_gateways"), device=device)
    names = "+".join(w.name for w in wls)
    print(f"Six-CNN joint refinement ({names}):")
    print(f"  geomean EDP {r['seed']['value']:.3e} -> "
          f"{r['refined']['value']:.3e} "
          f"({100 * r['improvement']:.1f}% better), trust region "
          f"{r['tr_stats']['accepted']} accepted / "
          f"{r['tr_stats']['rejected']} rejected steps, line search scored "
          f"{r['line_search']['n_scored']} integer designs")
    for w, m in zip(wls, r["refined"]["per_workload"]):
        print(f"    {w.name:16s} latency {m['latency_s']:.3e} s, "
              f"energy {m['energy_j']:.3e} J")
    fb = Fabric.from_config(r["refined"]["config"], name="six-cnn-best")
    print(f"  six-CNN best as Fabric: cross-pod "
          f"{fb.cross_pod_bw_bytes_per_s / 1e9:.1f} GB/s, "
          f"link latency {fb.link_latency_s * 1e9:.0f} ns")


def fabric_whatif(front, spec, mixes):
    """Frontier -> Fabric link models -> Layer-B roofline what-if: price one
    LLM serving cell (yi_34b decode) under the metallic ICI baseline and
    each deduped frontier design (core.fabric closes the search->system
    loop)."""
    print("=" * 72)
    from repro_torch.core import fabrics_from_front, metallic_ici
    from repro_torch.launch.hlo_analysis import HloStats, roofline

    fabs = [metallic_ici()] + fabrics_from_front(
        front, spec, mixes=mixes, max_fabrics=3)
    # a decode step on the (2,16,16) mesh: TP all-reduces dominate the wire
    stats = HloStats(dot_flops=1.7e10, dot_bytes=0.0, op_result_bytes=0.0,
                     collective_bytes=25.8e6, collective_op_bytes={},
                     collective_op_counts={"all-reduce": 121}, max_trip=1,
                     collective_bytes_raw=25.8e6)
    print(f"Fabric what-if (yi_34b decode cell): {len(fabs)} fabrics from "
          f"{front.size} frontier points")
    for fb in fabs:
        rf = roofline(stats, {}, stats.dot_flops, io_bytes=2.15e9, fabric=fb)
        step = max(rf.compute_s, rf.memory_s, rf.collective_s)
        print(f"  {fb.name:24s} cross-pod {fb.cross_pod_bw_bytes_per_s / 1e9:6.1f} GB/s: "
              f"step {step * 1e3:6.2f} ms, collective {rf.collective_s * 1e3:6.2f} ms "
              f"-> {rf.bottleneck}-bound")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    sweep_subnetworks(device)
    sweep_wavelengths(device)
    sweep_trimming_sensitivity(device)
    sweep_full_design_space(device)
    pareto_and_refine(device)
    front, spec, mixes = codesign_search(device)
    codesign_refine(front, spec, mixes, device)
    codesign_refine_six_cnn(front, spec, mixes, device)
    fabric_whatif(front, spec, mixes)


if __name__ == "__main__":
    main()
