"""The end-to-end metrics of a window, from the loop's stamps (host clock).

  out_tok_s    every token appended in the window over the window's seconds
  ttft_p90_ms  90th percentile, over every request whose first token came
               in the window, of the time from its submission to that token
  tpot_p90_ms  90th percentile, over every request finished in the window,
               of (last stamp - first stamp) / (tokens - 1)

The window holds whole iterations (`loop.ClosedLoop`), so its seconds and
its tokens are the same iterations' work.  Percentiles interpolate
linearly between order statistics (numpy's default).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def p90(values: List[float]) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 90))


def window_samples(loop) -> Dict[str, List[float]]:
    """The samples of each metric: token stamps, TTFTs and TPOTs (s)."""
    stamps, ttft, tpot = [], [], []
    for s in loop.served:
        stamps += [t for t, it in zip(s.stamps, s.iters) if loop.in_window(it)]
        if s.iters and loop.in_window(s.iters[0]):
            ttft.append(s.stamps[0] - s.submitted)
        if (s.finished and loop.in_window(s.iters[-1]) and s.max_new > 1):
            tpot.append((s.stamps[-1] - s.stamps[0]) / (s.max_new - 1))
    return {"tokens": stamps, "ttft": ttft, "tpot": tpot}


def metrics(loop) -> Dict[str, float]:
    smp = window_samples(loop)
    seconds = loop.t_stop - loop.t_start
    return {"out_tok_s": len(smp["tokens"]) / seconds,
            "ttft_p90_ms": p90(smp["ttft"]) * 1e3,
            "tpot_p90_ms": p90(smp["tpot"]) * 1e3}


def sample_counts(loop) -> Dict[str, int]:
    smp = window_samples(loop)
    return {"out_tok_s": len(smp["tokens"]), "ttft_p90_ms": len(smp["ttft"]),
            "tpot_p90_ms": len(smp["tpot"])}
