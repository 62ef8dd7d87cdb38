"""GPipe-style pipeline parallelism over a mesh axis.

The counterpart of the JAX package's `parallel/pipeline.py` (a shard_map
program whose activations hop stage to stage with `ppermute`).  TRINE's
stage-count argument applies to pipelines too: each pipeline hop is one
interposer crossing, so the schedule keeps exactly S-1 nearest-neighbour
hops per microbatch (a ring over the `pipe` axis), never an all-to-all.

  * the layer stack is split into S contiguous stages (`split_stages`);
    rank s of the `pipe` group runs stage s;
  * the batch is split into M microbatches; M + S - 1 clock ticks drive
    the staircase: stage s works on microbatch t - s at tick t;
  * after each tick the activation hops to rank (s + 1) mod S
    (`batch_isend_irecv`), a `torch.autograd.Function` whose backward
    sends the gradient along the reverse ring, as `ppermute`'s transpose
    does, so autograd runs the backward staircase and the gradients equal
    the sequential oracle's;
  * the last stage's outputs are replicated along `pipe` with an
    all-reduce of the masked outputs (backward: the gradient as it is,
    since every rank holds the same loss);
  * bubble fraction (S-1)/(M+S-1), reported by `pipeline_cost`, picks M
    (`choose_microbatches`).

Every rank holds the whole (S, ...) stage-stacked tree and runs its own
slice, so its gradient is zero outside slice s.  `stage_fn(stage_params,
x)` is any per-stage function.  At S = 1 the hop is a local copy.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import tree as T

__all__ = ["split_stages", "pipeline_cost", "choose_microbatches", "pipelined_apply",
           "sequential_reference"]


def split_stages(stacked_params, n_stages: int):
    """(L, ...) stacked layer params -> (S, L/S, ...) stage-stacked."""
    def f(x):
        n = x.shape[0]
        assert n % n_stages == 0, (n, n_stages)
        return x.reshape(n_stages, n // n_stages, *x.shape[1:])
    return T.map_structure(f, stacked_params)


def pipeline_cost(n_stages: int, n_micro: int, step_flops: float,
                  hop_bytes: float, peak_flops: float, link_bw: float):
    """Napkin model used by tests and the planner: total ticks, bubble
    fraction, and the per-tick compute/communication times."""
    ticks = n_micro + n_stages - 1
    bubble = (n_stages - 1) / ticks
    compute_tick = step_flops / max(n_micro, 1) / peak_flops
    comm_tick = hop_bytes / link_bw
    return {"ticks": ticks, "bubble_frac": bubble,
            "tick_s": max(compute_tick, comm_tick),
            "total_s": ticks * max(compute_tick, comm_tick)}


def choose_microbatches(n_stages: int, target_bubble: float = 0.1,
                        max_micro: int = 64) -> int:
    """Bandwidth matching for the pipe: smallest M with bubble <= target."""
    m = 1
    while (n_stages - 1) / (m + n_stages - 1) > target_bubble and m < max_micro:
        m *= 2
    return m


def _ring_shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Every rank of `group` sends `x` to group rank (r + step) mod n and
    returns what it receives from (r - step) mod n."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (me + step) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (me - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Hop(torch.autograd.Function):
    """One tick's activation hop to the next stage; backward: the gradient
    hops to the previous stage."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ring_shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _ring_shift(g, ctx.group, -1), None


class _Replicate(torch.autograd.Function):
    """Sum over `group` of outputs that one rank holds (the others zeros);
    backward: the gradient as it is, each rank holding the same loss."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipelined_apply(stage_fn: Callable, stage_params, x: torch.Tensor, mesh,
                    axis: str = "pipe") -> torch.Tensor:
    """Run `x` (M, mb, ...) microbatches through the S stages of
    `stage_params` (leaves (S, ...)) over the `axis` ranks of `mesh`;
    returns the (M, mb, ...) outputs on every rank.

    Correctness contract (tested): equals `sequential_reference`, forward
    and gradients."""
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    n_micro = x.shape[0]
    ticks = n_micro + n_stages - 1
    local = T.map_structure(lambda a: a[stage], stage_params)
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)

    # `where` keeps every tick's hop and output in the graph on every stage,
    # so that every rank runs the same backward hops in the same order
    buf = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    outs = []
    for t in range(ticks):
        x_in = torch.where(first, x[min(t, n_micro - 1)].to(buf.dtype), buf)
        h = stage_fn(local, x_in)
        if t >= n_stages - 1:      # microbatch t - (S - 1) leaves the last stage
            outs.append(torch.where(last, h, torch.zeros((), dtype=h.dtype, device=h.device)))
        if t < ticks - 1:          # the last tick's hop would carry nothing used
            buf = _Hop.apply(h, group)
    return _Replicate.apply(torch.stack(outs), group)


def sequential_reference(stage_fn: Callable, stage_params, x: torch.Tensor) -> torch.Tensor:
    """Oracle: the same stages applied back to back on each microbatch."""
    n_stages = T.leaves(stage_params)[0].shape[0]

    def one_micro(xm):
        h = xm
        for s in range(n_stages):
            h = stage_fn(T.map_structure(lambda a: a[s], stage_params), h)
        return h

    return torch.stack([one_micro(x[m]) for m in range(x.shape[0])])
