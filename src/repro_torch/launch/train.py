"""Training from the command line.

  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --reduced --device cpu --steps 20 --batch 4 --seq 128 --ckpt ckpt

Runs on the card unless `--device cpu` is given (`--reduced` makes that
practical).  The trainer checkpoints atomically and auto-resumes from the
newest valid checkpoint in `--ckpt`.  The flags are the reference's, plus
`--kernels` (the hand-written CUDA kernels in the forward) and `--device`.
`--wire-bits` other than 0 and `--mesh` other than `none` raise
`NotImplementedError`: the parameter wire format and the sharded step are
not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch import configs as C
from repro_torch import require_device
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv: Optional[Sequence[str]] = None,
         opt: Optional[OptConfig] = None, fabric=None,
         fault_at: Optional[int] = None, fault_scenario=None) -> Tuple[Trainer, dict]:
    """Parse the flags, build the trainer, run it to `--steps`.  Returns the
    trainer (its `state` and `history`) and the run's summary.  `opt`
    replaces the schedule the flags give (warmup min(20, steps // 5), total
    `--steps`, as in the reference), so that runs of different lengths can
    share one schedule.  `fabric`, `fault_at` and `fault_scenario` go to
    the trainer's modelled fabric (`Trainer(fabric=)`, `Trainer.run`); like
    the reference's launcher, the command line sets none of them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--photonic-mac", action="store_true",
                    help="route linears through the photonic-MAC QAT numerics")
    ap.add_argument("--wire-bits", type=int, default=0,
                    help="int8/bf16 parameter wire format (not ported: only 0)")
    ap.add_argument("--moe-dispatch", choices=["einsum", "index"], default=None)
    ap.add_argument("--data-file", default=None,
                    help="mmap token corpus (.bin uint16); default synthetic")
    ap.add_argument("--mesh", choices=["none", "single", "multi"], default="none",
                    help="device mesh (not ported: only none)")
    ap.add_argument("--kernels", action="store_true",
                    help="use the hand-written CUDA kernels (needs --device cuda)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.wire_bits:
        raise NotImplementedError("--wire-bits: the parameter wire format is not ported "
                                  "(ROADMAP.md, Queue 1 item 11)")
    if args.mesh != "none":
        raise NotImplementedError("--mesh: the sharded train step is not ported "
                                  "(ROADMAP.md, Queue 1 items 11 and 12)")
    device = require_device(args.device)
    cfg = C.get_reduced(args.arch) if args.reduced else C.get(args.arch)
    cfg = dataclasses.replace(cfg, use_photonic_mac=args.photonic_mac or cfg.use_photonic_mac,
                              use_kernels=args.kernels)
    if args.moe_dispatch:
        cfg = dataclasses.replace(cfg, moe_dispatch=args.moe_dispatch)

    data = DataConfig(global_batch=args.batch, seq_len=args.seq)
    source = None
    if args.data_file:
        from repro_torch.data.filesource import TokenFileSource
        source = TokenFileSource(cfg, data, args.data_file)

    if opt is None:
        opt = OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                        total_steps=args.steps)
    trainer = Trainer(cfg, opt, data, TrainerConfig(ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every),
                      resume=not args.no_resume, source=source, fabric=fabric,
                      device=device)
    out = trainer.run(args.steps, fault_at=fault_at, fault_scenario=fault_scenario)
    print(f"done: {out}")
    return trainer, out


if __name__ == "__main__":
    main()
