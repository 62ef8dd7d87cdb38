"""Small cells for the CPU tests: the cells of `BENCHMARK.json` with their
widths cut so that a test run holds them (128-wide products, so that the
banked quantisation and both kernels' paths are taken), and a small mix."""

from __future__ import annotations

import dataclasses
import itertools
from pathlib import Path

from bench import harness
from bench.generator import Mix

ROOT = Path(__file__).resolve().parent.parent
WIDTHS = dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64, d_ff=256,
              vocab=512)


def mix(n_slots: int = 4, **kw) -> Mix:
    d = dict(name="tiny", n_slots=n_slots, max_len=176, prompt_bucket=16, block=8,
             prompt={"dist": "lognormal", "median": 24, "sigma": 0.5, "min": 8, "max": 100},
             output={"dist": "lognormal", "median": 6, "sigma": 0.5, "min": 2, "max": 20})
    d.update(kw)
    return Mix(**d)


def cell(name: str = "yi6b.chat", n_slots: int = 4, root: Path = ROOT, **conf) -> harness.Cell:
    c = harness.load(root, name)
    widths = dict(WIDTHS, **({"n_experts": 4} if c.conf["family"] == "moe" else {}))
    return dataclasses.replace(c, conf=dict(c.conf, **widths, **conf), mix=mix(n_slots))


def ticks(step: float = 1e-3):
    """A clock that advances `step` seconds a call: a window of whole
    iterations that does not depend on how busy the machine is."""
    n = itertools.count()
    return lambda: next(n) * step
