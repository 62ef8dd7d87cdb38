"""Batched serving example: prefill + greedy decode with KV cache across a
request batch, with per-phase throughput — the serving-path counterpart of
the decode_32k / long_500k dry-run cells.

The PyTorch port's counterpart of `examples/serve_batched.py`: it calls the
port's serving launcher, `python -m repro_torch.launch.serve`, as an
operator would, on ``--device``.

  PYTHONPATH=src python examples/torch_serve_batched.py --arch mixtral-8x7b [--device cpu]

REPRO_SMOKE=1 shrinks the run (reduced model, batch 2, 16-token prompts,
4 new tokens).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro_torch.env import smoke_mode  # noqa: E402

SMOKE = smoke_mode()


def main(argv=None) -> subprocess.CompletedProcess:
    """Run the launcher in its own process; returns it, its output captured
    and echoed, and raises if it failed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=2 if SMOKE else 4)
    ap.add_argument("--prompt-len", type=int, default=16 if SMOKE else 64)
    ap.add_argument("--max-new", type=int, default=4 if SMOKE else 16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO / "src"), os.environ.get("PYTHONPATH", "")) if p))
    proc = subprocess.run([
        sys.executable, "-m", "repro_torch.launch.serve",
        "--arch", args.arch, "--reduced",
        "--batch", str(args.batch),
        "--prompt-len", str(args.prompt_len),
        "--max-new", str(args.max_new),
        "--device", args.device,
    ], env=env, capture_output=True, text=True)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    proc.check_returncode()
    return proc


if __name__ == "__main__":
    main()
