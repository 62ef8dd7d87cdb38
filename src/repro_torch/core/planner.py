"""Bandwidth-matching planners.

TRINE's quantitative core (paper Sec. IV): "The number of subnetworks can be
tailored to match the bandwidth that the memory can provide, ensuring that the
network bandwidth of memory aligns with the memory bandwidth.  This approach
maximizes performance without wasting network resources."

The same matching principle drives two planners here:

  * `choose_subnetworks`     -- Layer A: pick K tree subnetworks so
                                K * waveguide_BW ~= memory_BW.
  * `plan_collective_channels` -- Layer B: pick how many parallel collective
                                chunks (channels) to launch per layer so the
                                collective time matches the compute time it
                                can hide under (the TPU-mesh analog: ICI
                                bandwidth is the "memory", overlap window is
                                the "network").
  * `plan_gateway_activation` -- 2.5D-CrossLight's PCMC adaptation: fraction
                                of gateways to keep lit given a layer's
                                traffic demand.

The port's counterpart of the JAX package's `core/planner.py`: the array
forms take ``xp=numpy`` (host, the default) or a `core.xp.TorchNS` (float64
tensors on a device).
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

import numpy as np

__all__ = [
    "choose_subnetworks", "choose_subnetworks_arr",
    "plan_gateway_activation", "plan_gateway_activation_arr",
    "plan_collective_channels", "ceil_log2",
]

from repro_torch.core.xp import pow2

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.topology import NetworkParams


def _asx(xp, v):
    """float64 on the numpy path and on the torch namespace alike."""
    return np.asarray(v, np.float64) if xp is np else xp.asarray(v)


def ceil_log2(v, xp=np):
    """Exact elementwise ceil(log2(v)) for v > 0, with zero gradient.

    A `log2` that is not correctly rounded at exact powers of two (log2(16)
    evaluating to 4.000000000000001) would make `ceil(log2(v))` overshoot by
    a whole stage precisely at the integral points the topology kernels care
    about.  frexp is exact by construction: v = m * 2**e with m in [0.5, 1),
    hence ceil(log2 v) = e, except at exact powers of two where m == 0.5 and
    ceil(log2 v) = e - 1.  The torch path detaches the input — the result
    is piecewise constant, so its gradient is zero exactly like
    ceil(log2(.)) would give.
    """
    if xp is np:
        m, e = np.frexp(np.asarray(v, np.float64))
    else:
        m, e = xp.frexp(xp.detach(v))
    return _asx(xp, xp.where(m == 0.5, e - 1, e))


def choose_subnetworks_arr(n_lambda, modulation_rate_bps, n_mem_chiplets,
                           mem_bw_bytes_per_s, n_gateways, xp=np,
                           round_mode: str = "paper"):
    """Vectorized K*: elementwise over struct-of-arrays parameter columns
    (the sweep-engine path; `choose_subnetworks` is the scalar wrapper).
    Pass a `TorchNS` to run it on tensors inside the engine or under
    autograd; the round/ceil quantization is piecewise-constant (zero
    gradient).

    `round_mode` picks the power-of-two snap for the raw K = ceil(mem/wg):
      "paper"  geometrically (log-space) nearest power of two — the paper's
               9 -> 8 choice, implemented as 2**round(log2 K).  This differs
               from the arithmetically nearest power of two (k=6 ->
               2**round(2.585) = 8, though |6-4| = |6-8|) and may round DOWN
               below the memory bandwidth,
      "cover"  next power of two up — the smallest pow2 K that actually
               covers mem_bw (never under-provisions).
    Both are clamped to the gateway count."""
    wg_bw = _asx(xp, n_lambda) * _asx(xp, modulation_rate_bps)
    mem_bw = _asx(xp, n_mem_chiplets) * _asx(xp, mem_bw_bytes_per_s) * 8.0
    k = xp.maximum(1.0, xp.ceil(mem_bw / wg_bw))
    # power-of-two so subnet trees stay balanced (paper uses 8)
    if round_mode == "paper":
        k_pow2 = pow2(xp, xp.round(xp.log2(k)))
    elif round_mode == "cover":
        k_pow2 = pow2(xp, ceil_log2(k, xp))
    else:
        raise ValueError(
            f"round_mode must be 'paper' or 'cover', got {round_mode!r}")
    return xp.minimum(k_pow2, _asx(xp, n_gateways))


def choose_subnetworks(p: "NetworkParams", round_mode: str = "paper") -> int:
    """Subnetwork count K for TRINE, a power of two clamped to the gateway
    count.

    With the paper's numbers (the TRINE eval provisions against one
    100 GB/s memory interface per subnet group): 100 GB/s = 800 Gb/s,
    waveguide = 8 lambda * 12 Gb/s = 96 Gb/s  =>  raw K = ceil(800/96) = 9.
    The default ``round_mode="paper"`` reproduces the paper's choice — the
    GEOMETRICALLY (log-space) nearest power of two, 2**round(log2 K)
    (9 -> 8: "we opted for 8 subnetworks to use the maximum bandwidth
    offered by memory chiplets").  Note this is not the arithmetically
    nearest power of two (k=6 snaps up to 8, not down to 4) and it can
    round DOWN below the memory bandwidth it nominally matches.  Pass
    ``round_mode="cover"`` for the smallest power-of-two K with
    K * wg_bw >= mem_bw (next power of two up; 9 -> 16), which never
    under-provisions.
    """
    return int(choose_subnetworks_arr(
        p.n_lambda, p.modulation_rate_bps, p.n_mem_chiplets,
        p.mem_bw_bytes_per_s, p.n_gateways, round_mode=round_mode))


def plan_gateway_activation_arr(demand_bytes_per_s, max_bw_bytes_per_s,
                                n_gateways, xp=np):
    """Vectorized PCMC gateway-activation fraction (sweep/batched path).
    A `TorchNS` runs it on tensors inside the co-design grid kernel."""
    demand = _asx(xp, demand_bytes_per_s)
    maxbw = _asx(xp, max_bw_bytes_per_s)
    n = _asx(xp, n_gateways)
    frac = xp.clip(demand / xp.where(maxbw > 0, maxbw, np.inf), 0.0, 1.0)
    steps = xp.maximum(1.0, xp.ceil(frac * n))
    return xp.where(maxbw > 0, steps / n, 1.0)


def plan_gateway_activation(
    demand_bytes_per_s: float,
    max_bw_bytes_per_s: float,
    n_gateways: int,
) -> float:
    """2.5D-CrossLight PCMC gateway activation: keep the smallest fraction of
    gateways lit that still covers the traffic demand.  Returns the active
    fraction in {1/n, 2/n, ..., 1}.  Deactivated gateways are power-gated and
    their PCMC couplers divert laser power (laser scales with the fraction).
    """
    return float(plan_gateway_activation_arr(
        demand_bytes_per_s, max_bw_bytes_per_s, n_gateways))


def plan_collective_channels(
    collective_bytes: float,
    overlap_window_s: float,
    link_bw_bytes_per_s: float = None,
    max_channels: int = 8,
    min_chunk_bytes: float = 1 << 20,
    fabric=None,
) -> int:
    """Layer B bandwidth matching: number of parallel collective channels
    (chunks in flight) so transfer time ~= the compute window it hides under.

    channels = ceil(bytes / (window * bw)) -- i.e. provision exactly enough
    parallelism, never more (TRINE: "without wasting network resources").
    Clamped so chunks stay large enough to amortize per-collective latency.

    The link bandwidth may be given directly (`link_bw_bytes_per_s`) or
    derived from a network design point (`fabric` — a `core.fabric.Fabric`,
    a preset name like "trine_siph", or anything with a
    ``cross_pod_bw_bytes_per_s`` attribute); `fabric` wins when both are
    passed, since it reflects the design under evaluation.
    """
    if fabric is not None:
        link_bw_bytes_per_s = getattr(fabric, "cross_pod_bw_bytes_per_s", None)
        if link_bw_bytes_per_s is None:
            from repro_torch.core.fabric import get_fabric  # runtime: no cycle
            link_bw_bytes_per_s = get_fabric(fabric).cross_pod_bw_bytes_per_s
    if link_bw_bytes_per_s is None:
        raise ValueError("pass link_bw_bytes_per_s or fabric")
    if link_bw_bytes_per_s <= 0:
        # a fully-degraded fabric: no channel count can carry the collective
        from repro_torch.core.faults import FabricUnusableError  # runtime: no cycle
        raise FabricUnusableError(
            "collective cannot be scheduled: link bandwidth is zero "
            "(fabric degraded beyond use)")
    if collective_bytes <= 0:
        return 1
    need = collective_bytes / max(overlap_window_s * link_bw_bytes_per_s, 1e-30)
    ch = max(1, math.ceil(need))
    ch = min(ch, max_channels, max(1, int(collective_bytes // min_chunk_bytes)))
    return int(ch)
