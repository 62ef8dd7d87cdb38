"""The port's profiler ranges: one helper, `span(name)`, for every layer.

A range is a `torch.profiler.record_function` while a profiler runs, so it
shares the profiler's clock with the device trace (its device-side span
holds the kernels launched inside it); with no profiler running, `span`
returns `contextlib.nullcontext()` and constructs nothing else.

Readers: `bench/trace.py` (each range's device seconds, `SpanResult.ranges`,
and the names of the idle gaps) and `chip_smoke.py --profile` (the device
time under each of its `SPANS`).  The ranges:

  attention, cross_attention      the product and the cache (`models/layers.py`)
  attention.decode                a decode step's `decode_attention`, inside
                                  `attention`, the cache writes outside it
  moe.route / .dispatch /         the MoE block's parts
    .experts / .combine
  encode                          the encoder's blocks (`models/model.py`)
  photonic.quantize               a miss's weight quantisation in the
                                  photonic linear (`kernels/ops.py`): the
                                  per-column path's and a banked weight's
                                  whose levels are not kept; not a hit,
                                  not the product
  batcher.admit / .decode / .emit an admission, a decode step and the
                                  token loop after it (`serve/engine.py`)
  loss, backward, optimizer,      the train step's parts (`runtime/trainer.py`)
    gather, grad_reduce

This module imports only `torch`, so that every layer of the port can use it.
"""

from __future__ import annotations

import contextlib

import torch


def span(name: str):
    """A named range in a `torch.profiler` trace; nothing at all when no
    profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
