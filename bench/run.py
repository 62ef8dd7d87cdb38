"""The benchmark's command: one run of one cell of `BENCHMARK.json`.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  It pins every build and kernel cache
inside the checkout (`build/`), exits non-zero without a result when the
card is missing, and prints the result as the last line of standard
output; the compared numbers and their limits are the last lines of
standard error.  `--control 1` also computes the check's control (the
reference in float8), for setting limits; the benchmark's runs leave it
off.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _paths() -> None:
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(build / "bench_cache" / sub)
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()

    from bench import harness
    import torch

    cell = harness.load(ROOT, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {chips} CUDA device(s), this process sees {have}",
              file=sys.stderr)
        return 2
    out = harness.execute(cell, args.seed, args.seconds, bool(args.trace), T0,
                          control=bool(args.control),
                          log=lambda s: print(s, flush=True))
    bad = harness.loaded_forbidden()        # the window has closed
    if bad:
        print(f"bench: the process holds {', '.join(bad)} after the window", file=sys.stderr)
        return 3
    for name, v in out["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
