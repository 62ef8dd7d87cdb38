#!/usr/bin/env python3
"""Serving tokens/s of models at published width on one card, for holding
two trees of the port against each other (run each tree in its own
process, in the order a, b, b, a, and compare within one call).

    python3 tools/torch_serve_rate.py [--src path/to/src] --arch yi-6b \\
        --arch zamba2-1.2b [--tag parent]

Imports `repro_torch` from `--src` (default: this checkout's `src`),
initialises each model from seed 0 (f32 masters, photonic numerics,
kernels on) and runs `launch/serve.py`'s path at batch 128 x prompt 128
with 16 new tokens (15 decode steps): one warm-up call, then 3 timed calls.
Prints one JSON line per model with every call's prefill and decode
tokens/s (host clock around a synchronize, as the launcher times them) and
their medians, then the card's name and power limit.  Needs one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

BATCH, PROMPT_LEN, MAX_NEW, REPS = 128, 128, 16, 3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--arch", action="append", required=True)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, args.src)
    from repro_torch import configs as C
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    for arch in args.arch:
        cfg = dataclasses.replace(C.get(arch), use_photonic_mac=True, use_kernels=True)
        params = M.init(cfg, seed=0, device="cuda")
        argv = ["--arch", arch, "--batch", str(BATCH), "--prompt-len", str(PROMPT_LEN),
                "--max-new", str(MAX_NEW), "--seed", "0", "--photonic", "--kernels"]
        serve.main(argv, params=params, cfg=cfg)                      # warm-up
        prefill, decode = [], []
        for _ in range(REPS):
            res = serve.main(argv, params=params, cfg=cfg)
            prefill.append(res["prefill_tokens"] / res["prefill_s"])
            decode.append(res["decode_tokens"] / res["decode_s"])
        print(json.dumps({"tag": args.tag, "src": args.src, "arch": arch,
                          "batch": BATCH, "prompt_len": PROMPT_LEN,
                          "max_new": MAX_NEW, "prefill_tokens_per_s": prefill,
                          "decode_tokens_per_s": decode,
                          "median_prefill_tokens_per_s": statistics.median(prefill),
                          "median_decode_tokens_per_s": statistics.median(decode)}), flush=True)
        del params
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
