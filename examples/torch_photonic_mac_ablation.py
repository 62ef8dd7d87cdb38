"""Photonic-MAC resolution ablation (DESIGN.md §6, paper §V).

The 2.5D-CrossLight weight banks imprint weights onto optical amplitudes
through MR tuning — the achievable resolution (4..8 bits in the CrossLight
line of work) bounds the numerics of every MAC.  This ablation sweeps the
resolution and reports:

  1. weight-quantization error (the per-tile MR-bank model in
     `kernels/photonic_mac.py`),
  2. end-task effect: a reduced-config LM trained for a few dozen steps with
     `use_photonic_mac=True` (QAT straight-through) at each resolution,
  3. the interposer implication: parameter wire bytes scale linearly with
     resolution (`parallel/wire.py`) — 8-bit banks mean 4x fewer collective
     bytes than f32 masters on the same SWMR traffic.

The PyTorch port's counterpart of `examples/photonic_mac_ablation.py`, on
``--device``; its weight is drawn from a numpy seed.  `main` returns the
errors and losses it printed.

  PYTHONPATH=src python examples/torch_photonic_mac_ablation.py [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.env import smoke_mode
from repro_torch.kernels import ref
from repro_torch.kernels.photonic_mac import quantize_weights
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import make_train_step

# REPRO_SMOKE=1: one resolution, a few steps — the CI smoke-mode contract
# shared with the benchmark layer
_SMOKE = smoke_mode()
STEPS = 4 if _SMOKE else 30
BITS = (8,) if _SMOKE else (8, 6, 5, 4, 3, 2)


def bank_weight(k: int = 512, n: int = 512, seed: int = 0) -> np.ndarray:
    """The ablation's weight: standard normal, f32, from a numpy seed."""
    return np.random.default_rng(seed).standard_normal((k, n), dtype=np.float32)


def quant_rel_error(w: torch.Tensor, bits: int) -> float:
    """Relative Frobenius error of the per-bank quantization of `w`."""
    wq, sc = quantize_weights(w, bits=bits)
    deq = ref.dequantize_ref(wq, sc)
    return float(torch.linalg.vector_norm(deq - w) / torch.linalg.vector_norm(w))


def quant_error(device) -> dict:
    print("== MR weight-bank quantization error (per-tile scale, 128x128) ==")
    w = torch.as_tensor(bank_weight()).to(device)
    out = {}
    for bits in BITS:
        out[bits] = quant_rel_error(w, bits)
        print(f"  bits={bits}:  rel-frobenius-error={out[bits]:.5f}  "
              f"(amplitude levels={2 ** (bits - 1) - 1})")
    return out


def train_at(bits, device) -> float:
    cfg = C.get_reduced("yi_6b")
    if bits:
        cfg = dataclasses.replace(cfg, use_photonic_mac=True,
                                  photonic_bits=bits, use_kernels=False)
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=5, total_steps=STEPS)
    params = M.init(cfg, seed=0, device=device)
    state = adamw.init_state(opt, params)
    step = make_train_step(cfg, opt, device=device)
    src = SyntheticLM(cfg, DataConfig(global_batch=4, seq_len=64))
    for i in range(STEPS):
        batch = {k: torch.as_tensor(v).to(device) for k, v in src.batch_at(i).items()}
        state, metrics = step(state, batch)
    return float(metrics["loss"])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    errors = quant_error(args.device)
    print(f"\n== QAT training, reduced yi-6b, {STEPS} steps ==")
    base = train_at(None, args.device)
    print(f"  f32 MAC         : final loss {base:.4f}")
    losses = {}
    for bits in BITS:
        losses[bits] = train_at(bits, args.device)
        print(f"  photonic {bits}-bit : final loss {losses[bits]:.4f}  "
              f"(gap {losses[bits] - base:+.4f})")
    print("\n== interposer wire implication ==")
    wire = {}
    for bits in (32, 16, 8, 4):
        wire[bits] = 32 / bits
        print(f"  {bits:>2}-bit weights on the SWMR wire: "
              f"{wire[bits]:.0f}x fewer collective bytes than f32 masters")
    print("\n(The 8-bit row is the paper-faithful operating point: CrossLight"
          "\n demonstrates robust 256-level MR operation; below 4 bits the QAT"
          "\n gap grows quickly — matching the paper line's design choice.)")
    return {"quant_rel_error": errors, "f32_loss": base, "photonic_loss": losses,
            "wire_reduction": wire, "steps": STEPS}


if __name__ == "__main__":
    main()
