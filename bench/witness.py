"""A second witness for a cell's check: the cell run as `run.py` runs it,
but with the program computing in another dtype and with another number
of slots, its check's readings printed (`readings: ...`).  In float32 the
program and the reference compute the same arithmetic in other orders, so
at the cell's widths their readings show what bf16 alone moves.  Not one
of the benchmark's runs.

    python3 bench/witness.py --workload <cell> --seed <n> --seconds <s> \
        --dtype float32 --slots <n>
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402  (bench/run.py: the paths and caches of a run)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--slots", type=int, required=True)
    args = ap.parse_args(argv)
    run._paths()

    from bench import harness

    cell = harness.load(run.ROOT, args.workload)
    cell = dataclasses.replace(cell, conf=dict(cell.conf, dtype=args.dtype),
                               mix=dataclasses.replace(cell.mix, n_slots=args.slots))
    out = harness.execute(cell, args.seed, args.seconds, False, T0,
                          log=lambda s: print(s, flush=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
