"""Quickstart: the paper in five minutes.

1. Evaluate the TRINE photonic interposer against SPRINT/SPACX/Tree (Fig. 4).
2. Evaluate 2.5D-CrossLight vs monolithic / electrical interposer (Fig. 6).
3. Run five training steps of an assigned architecture (reduced scale) with
   the photonic-MAC (broadcast-and-weight) numerics enabled, on ``--device``.

The PyTorch port's counterpart of `examples/quickstart.py`.  Sections 1 and
2 are the analytic models' scalar golden path (host numpy, float64);
section 3 runs eagerly on the device.  `main` returns the numbers it printed
and the paper's qualitative claims they show (`checks`).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import configs as C
from repro_torch import tree as T
from repro_torch.core import (
    CNN_WORKLOADS, NetworkParams, choose_subnetworks, crosslight_25d_siph,
    evaluate_accelerator, evaluate_network, monolithic_crosslight,
    sprint_bus, tree_network, trine_network,
)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import model as M


def photonic_network_demo() -> dict:
    print("=" * 70)
    print("TRINE photonic interposer (paper Sec. IV)")
    p = NetworkParams()
    k_star = choose_subnetworks(p)
    print(f"  bandwidth matching: memory {p.mem_bw_bytes_per_s/1e9:.0f} GB/s, "
          f"waveguide {p.n_lambda * p.modulation_rate_bps/8e9:.0f} GB/s "
          f"-> K* = {k_star} subnetworks (paper: 8)")
    trine = trine_network(p)
    tree = tree_network(p)
    print(f"  TRINE: {trine.n_stages} MZI stages, "
          f"{trine.worst_path_loss_db:.1f} dB worst path "
          f"(Tree: {tree.n_stages} stages, {tree.worst_path_loss_db:.1f} dB)")
    wl = CNN_WORKLOADS["ResNet18"]()
    t = wl.traffic()
    reports = {}
    for net in (sprint_bus(p), tree, trine):
        r = evaluate_network(net, t)
        reports[net.name] = r
        print(f"  {net.name:10s} ResNet18 traffic: {r.latency_s*1e3:7.3f} ms, "
              f"{r.energy_j*1e3:6.3f} mJ, {r.energy_per_bit_j*1e12:6.2f} pJ/bit")
    others = [r for name, r in reports.items() if name != trine.name]
    ours = reports[trine.name]
    return {"k_star": k_star, "trine_stages": trine.n_stages, "tree_stages": tree.n_stages,
            "resnet18": {name: {"latency_s": r.latency_s, "energy_j": r.energy_j}
                         for name, r in reports.items()},
            "checks": {"k_star_is_8": k_star == 8,
                       "trine_fewer_stages_than_tree": trine.n_stages < tree.n_stages,
                       "trine_lowest_latency": all(ours.latency_s < r.latency_s
                                                   for r in others),
                       "trine_lowest_energy": all(ours.energy_j < r.energy_j for r in others)}}


def accelerator_demo() -> dict:
    print("=" * 70)
    print("2.5D-CrossLight (paper Sec. V)")
    mono = monolithic_crosslight()
    siph = crosslight_25d_siph()
    speedup = {}
    for wl_name in ("VGG16", "LeNet5"):
        wl = CNN_WORKLOADS[wl_name]()
        rm = evaluate_accelerator(mono, wl)
        rs = evaluate_accelerator(siph, wl)
        speedup[wl_name] = rm.latency_s / rs.latency_s
        print(f"  {wl_name:8s}: monolithic {rm.latency_s*1e3:8.3f} ms "
              f"-> 2.5D-SiPh {rs.latency_s*1e3:8.3f} ms "
              f"({speedup[wl_name]:4.1f}x)  EPB "
              f"{rm.epb_j*1e12:5.2f} -> {rs.epb_j*1e12:5.2f} pJ/bit")
    return {"speedup": speedup,
            "checks": {f"siph_faster_{k.lower()}": v > 1.0 for k, v in speedup.items()}}


def photonic_mac_training_demo(device) -> list:
    print("=" * 70)
    print("Training with photonic-MAC numerics (broadcast-and-weight QAT)")
    cfg = dataclasses.replace(C.get_reduced("yi_6b"),
                              use_photonic_mac=True, photonic_bits=8)
    params = M.init(cfg, seed=0, device=device)
    # one batch of token ids and next-token labels, drawn from a seed
    batch = {k: torch.as_tensor(v).to(device) for k, v in
             SyntheticLM(cfg, DataConfig(global_batch=2, seq_len=64)).batch_at(0).items()}
    leaves = T.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    losses = []
    for i in range(5):
        loss, _ = M.loss_fn(cfg, params, batch, device=device)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                t.sub_(5e-2 * g)
        losses.append(float(loss.detach()))
        print(f"  step {i}: loss = {losses[-1]:.4f}  "
              f"(8-bit MR weight banks, f32 photodetector accumulation)")
    return losses


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    net = photonic_network_demo()
    acc = accelerator_demo()
    losses = photonic_mac_training_demo(args.device)
    return {"network": net, "accelerator": acc, "losses": losses,
            "checks": {**net["checks"], **acc["checks"]}}


if __name__ == "__main__":
    main()
