"""Activation-sharding context.

The counterpart of the JAX package's `parallel/actx.py`.  There, GSPMD
propagates parameter shardings into activations, and model code pins
activations to batch-over-DP at stable points through this context (a
`with_sharding_constraint`).  Here the context says how a rank's
activations are laid out: `constrain` redistributes a `DTensor` to the
resolved placements and returns a plain tensor, which holds the rank's
shard already, as it is.  No model code of the port calls a constraint
yet, and the sharded train step (`runtime.trainer`) opens no context: it
runs the model on plain tensors that ARE the rank's batch shard.  The
first caller is the tensor-parallel split of the compute (ROADMAP.md).
Without the context (one device, the unit tests) every call is a no-op,
as in the reference.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.parallel.sharding import P, PartitionSpec, placements

__all__ = ["activation_sharding", "active", "resolve", "constrain", "constrain_batch",
           "constrain_seq", "constrain_unseq"]

_STATE: dict = {"mesh": None, "dp": None, "tp": None, "seq_tp": False}


@contextlib.contextmanager
def activation_sharding(mesh, dp_axes: Optional[Tuple[str, ...]],
                        tp_axis: Optional[str] = "model",
                        seq_tp: bool = False):
    prev = dict(_STATE)
    _STATE.update(mesh=mesh, dp=dp_axes, tp=tp_axis, seq_tp=seq_tp)
    try:
        yield
    finally:
        _STATE.update(prev)


def active() -> bool:
    return _STATE["mesh"] is not None


def resolve(spec: Tuple) -> PartitionSpec:
    """spec entries: 'dp' -> the context's data-parallel axes, 'tp' -> the
    tensor axis, None -> unsharded; a mesh axis is used at most once."""
    resolved = []
    used: set = set()
    for s in spec:
        ax = _STATE["dp"] if s == "dp" else _STATE["tp"] if s == "tp" else None
        if ax is not None:
            axes = (ax,) if isinstance(ax, str) else tuple(ax)
            axes = tuple(a for a in axes if a not in used)
            used.update(axes)
            ax = axes if len(axes) > 1 else (axes[0] if axes else None)
        resolved.append(ax)
    return P(*resolved)


def constrain(x: torch.Tensor, spec: Tuple) -> torch.Tensor:
    """`x` laid out as `spec` says: a DTensor redistributed to it, a plain
    tensor (the rank's own shard) as it is.  A no-op without the context or
    when `x.ndim` differs from `len(spec)`."""
    if not active() or x.ndim != len(spec):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = _STATE["mesh"]
    return x.redistribute(mesh, placements(mesh, resolve(spec), x.ndim))


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Batch-leading activation: (B, ...) -> B over DP axes."""
    return constrain(x, ("dp",) + (None,) * (x.ndim - 1))


def constrain_seq(x: torch.Tensor) -> torch.Tensor:
    """seq_tp (context-parallel attention): (B, S, M) -> S over the TP axis.
    No-op unless the context enables sequence-TP."""
    if not active() or not _STATE["seq_tp"] or x.ndim != 3:
        return x
    return constrain(x, ("dp", "tp", None))


def constrain_unseq(x: torch.Tensor) -> torch.Tensor:
    """Megatron-SP transition back: gather S, hand the TP axis to the MLP."""
    if not active() or not _STATE["seq_tp"] or x.ndim != 3:
        return x
    return constrain(x, ("dp", None, None))
