"""End-to-end training driver: train a ~100M-parameter dense LM for a few
hundred steps with the full production stack — synthetic pipeline, AdamW,
atomic checkpointing, failure injection + auto-resume.

The PyTorch port's counterpart of `examples/train_e2e.py`, on ``--device``.
Checkpoints go to ``--ckpt``, by default a fresh temporary directory that
is removed at the end.  As the reference's supervisor does,
`run_with_restarts` loses the failed step's history row where the failure
falls on a checkpoint step: the restored trainer starts after that step
(`ROADMAP.md`, Queue 3).

  PYTHONPATH=src python examples/torch_train_e2e.py [--steps 300] [--fail-at 150] [--device cpu]

--tiny (the default) trains the 2-layer LM_TINY; --full-100m the ~100M
LM_100M.
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile

from repro_torch.data.pipeline import DataConfig
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig, run_with_restarts

# ~100M-parameter llama-style config (d=768, 12L, vocab 32k ≈ 110M params)
LM_100M = ModelConfig(
    name="lm-100m", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
    d_ff=2048, vocab=32000, rope_theta=1e4, loss_chunk=128,
    dtype="float32", remat="none",
)

LM_TINY = dataclasses.replace(
    LM_100M, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=1024, name="lm-tiny")


def main(argv=None) -> dict:
    """Train, and return the run's result with its per-step `history`
    (merged across restarts) and, with --fail-at, the restarts made."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a node failure at this step (0=off); the "
                         "supervisor restarts from the latest checkpoint")
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--full-100m", dest="tiny", action="store_false")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one, removed after)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = LM_TINY if args.tiny else LM_100M
    print(f"training {cfg.name}: ~{cfg.param_count()/1e6:.0f}M params, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq}")
    ckpt = args.ckpt or tempfile.mkdtemp(prefix="repro_torch_e2e_")
    made = []

    def make():
        tr = Trainer(
            cfg,
            OptConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps),
            DataConfig(global_batch=args.batch, seq_len=args.seq),
            TrainerConfig(ckpt_dir=ckpt, ckpt_every=20, log_every=10),
            device=args.device,
        )
        made.append(tr.start_step)
        return tr

    try:
        if args.fail_at:
            print(f"(failure will be injected at step {args.fail_at}; "
                  f"watch the auto-resume)")
            tr = run_with_restarts(make, args.steps, fail_at=(args.fail_at,))
            out = {"last_loss": tr.history[-1]["loss"] if tr.history else None}
        else:
            tr = make()
            out = tr.run(args.steps)
    finally:
        if args.ckpt is None:
            shutil.rmtree(ckpt, ignore_errors=True)
    print("done:", out)
    losses = [h["loss"] for h in tr.history]
    print("loss trajectory proves optimization:",
          " -> ".join(f"{x:.3f}" for x in losses[::max(1, len(losses) // 6)]))
    return {**out, "history": tr.history, "restarts": len(made) - 1,
            "resumed_from": made[1:]}


if __name__ == "__main__":
    main()
