"""Environment flags shared by benchmarks, examples, and tests.

Two knobs are recognized:

  REPRO_SMOKE     truthy -> tiny-grid / few-step CI smoke runs.
  REPRO_PREFETCH  integer >= 0 -> streaming-pipeline prefetch depth for the
                  chunked sweep/search engine (how many chunks may be in
                  flight on the device ahead of the reducer fold).  0 means
                  fully serial (enqueue, block, fold); the default of 2 keeps
                  one chunk computing while the previous one folds —
                  double-buffering.  Any depth produces bit-identical reducer
                  states; the knob only trades memory for overlap.
"""

from __future__ import annotations

import os

_TRUTHY = ("1", "true", "yes", "on")

DEFAULT_PREFETCH = 2


def smoke_mode(default: bool = False) -> bool:
    """True when REPRO_SMOKE requests tiny-grid / few-step CI smoke runs.

    The single source of truth for the flag's accepted values — benchmarks
    and examples must not re-parse the variable themselves, so the contract
    cannot silently diverge between entry points.
    """
    raw = os.environ.get("REPRO_SMOKE")
    if raw is None:
        return default
    return raw.strip().lower() in _TRUTHY


def prefetch_depth(default: int = DEFAULT_PREFETCH) -> int:
    """Streaming-pipeline prefetch depth from REPRO_PREFETCH (clamped >= 0).

    Single source of truth for the flag, mirroring `smoke_mode`: the engine
    (`core.sweep.sweep_chunked` and everything layered on it) consults this
    when no explicit ``prefetch=`` argument is given.  Unparseable values
    fall back to the default rather than erroring — a misconfigured shell
    must not change results, only scheduling.
    """
    raw = os.environ.get("REPRO_PREFETCH")
    if raw is None:
        return default
    try:
        return max(0, int(raw.strip()))
    except ValueError:
        return default
