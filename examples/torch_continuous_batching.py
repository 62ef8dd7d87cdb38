"""Continuous-batching serving demo: ragged requests stream through a fixed
pool of cache slots (vLLM-style iteration-level scheduling) — the serving
counterpart of the paper's bandwidth-matching argument: keep the provisioned
lanes (batch slots) busy under ragged load.

The PyTorch port's counterpart of `examples/continuous_batching.py`: the
same requests (numpy seed 0) through `repro_torch.serve.engine`'s
`ContinuousBatcher` on ``--device``.  `main` returns the finished requests
and the run's numbers.

  PYTHONPATH=src python examples/torch_continuous_batching.py --arch yi-6b [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import configs as C
from repro_torch.models import model as M
from repro_torch.serve.engine import ContinuousBatcher


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = C.get_reduced(args.arch)
    params = M.init(cfg, seed=0, device=args.device)
    eng = ContinuousBatcher(cfg, params, n_slots=args.slots, max_len=args.max_len,
                            device=args.device)

    rng = np.random.default_rng(0)
    total_new = 0
    reqs = []
    for _ in range(args.requests):
        plen = int(rng.integers(4, 24))
        max_new = int(rng.integers(4, 16))
        prompt = [int(t) for t in rng.integers(2, cfg.vocab, size=plen)]
        reqs.append(eng.submit(prompt, max_new))
        total_new += max_new

    t0 = time.perf_counter()
    finished = eng.run()
    dt = time.perf_counter() - t0
    print(f"{len(finished)} requests, {total_new} new tokens through "
          f"{args.slots} slots in {dt:.2f}s ({total_new/dt:.0f} tok/s)")
    for r in finished[:4]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")
    return {"requests": reqs, "finished": finished, "new_tokens": total_new, "seconds": dt,
            "stats": dict(eng.stats)}


if __name__ == "__main__":
    main()
