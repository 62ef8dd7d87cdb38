"""Timing on the card: the H100's peak rates, a `photonic_mac` product's
bound, a device timer and the card's name and power limit.  Shared by
`chip_smoke.py`, `benchmarks/torch_kernels_bench.py` and the plan sweeps
under `tools/`; nothing on the serving or training path imports it."""

from __future__ import annotations

import functools
import subprocess

import torch

# published dense peaks of one H100 SXM (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def mac_bound_ms(m: int, k: int, n: int, dtype: torch.dtype) -> dict:
    """The least time the card could take for an (M,K) x (K,N) product with
    `dtype` activations: x, the int8 levels and the scales read once and
    the f32 output written once, or the product's operations at the
    activations' peak rate, whichever is longer."""
    nbytes = (m * k * (2 if dtype == torch.bfloat16 else 4) + k * n
              + 4 * (-(-k // 128)) * (-(-n // 128)) + 4 * m * n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * k * n / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_ms(fn) -> float:
    """Mean device time of `fn` in ms, by CUDA events around a run of calls
    (3 to 50, about 20 ms of work), after two warm calls.  The device is
    first kept busy with a spin kernel while the host enqueues the whole
    run, so the events bracket back-to-back device work and not the host's
    cost of launching it.  Inputs stay warm in L2 between calls, as they are
    on the serving path, where each is produced just before use."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    fn()
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    iters = max(3, min(50, int(20.0 / max(e0.elapsed_time(e1), 1e-3))))
    torch.cuda._sleep(10_000_000)          # a few ms of spinning
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


@functools.lru_cache(maxsize=1)
def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them (queried
    once a process)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
