"""Activation-sharding context, and the tensor-parallel split's operators.

The counterpart of the JAX package's `parallel/actx.py`.  There, GSPMD
propagates parameter shardings into activations and splits the compute,
and model code pins activations at stable points through this context (a
`with_sharding_constraint`).  Here the sharded train step
(`runtime.trainer`) opens the context, and the model code splits its
compute itself, Megatron-style, with the operators below: autograd
Functions whose forward and backward issue their own c10d calls over the
tensor-parallel (`model`) axis.

  * `tp_copy` (identity forward, sum over `model` backward) where a
    replicated activation enters a split computation, and `tp_sum` (sum
    forward, identity backward) where its partial results leave it;
  * `tp_max` (an in-place MAX over `model`, no gradient): the photonic
    numerics' bank scales of a weight split across ranks;
  * `constrain_seq` / `constrain_unseq` (`seq_tp`): a rank's slice of the
    sequence, and the slices gathered back; `gather_seq` gathers K and V
    along the sequence with a reduce-scatter backward.

The model code reads the split from the shapes it is handed (a rank's
heads, `ffn` columns, experts or vocabulary rows) and the rank from here.
`global_rows` gives the rows of a batch-leading activation across the
ranks, so that `kernels.ops` decides the photonic path on the global
batch, as the reference's `jit` does.

The split is active only when the mesh has a `model` axis of size > 1
that the batch does not span (`fsdp_all` spans it: no split).  Without the
context (one device, serving, the unit tests) every call is a no-op, as in
the reference.  `constrain` and `constrain_batch` keep the reference's
API: on the plain tensors the port's model runs on they are no-ops.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.collectives import _ALL_GATHER, _REDUCE_SCATTER
from repro_torch.parallel.sharding import P, PartitionSpec, placements

__all__ = ["activation_sharding", "active", "resolve", "constrain", "constrain_batch",
           "constrain_seq", "constrain_unseq", "tp_size", "tp_rank", "seq_split", "seq_rows",
           "global_rows", "tp_copy", "tp_sum", "tp_max", "gather_seq", "seq_slice"]

_STATE: dict = {"mesh": None, "dp": None, "tp": None, "seq_tp": False, "rows": 1.0}


@contextlib.contextmanager
def activation_sharding(mesh, dp_axes: Optional[Tuple[str, ...]],
                        tp_axis: Optional[str] = "model",
                        seq_tp: bool = False, rows: float = 1.0):
    """Within the context the model runs as one rank of `mesh`: `dp_axes`
    split the batch, `tp_axis` the compute, `seq_tp` the attention's
    sequence; `rows` is the global batch's rows over this rank's."""
    prev = dict(_STATE)
    _STATE.update(mesh=mesh, dp=dp_axes, tp=tp_axis, seq_tp=seq_tp, rows=float(rows))
    try:
        yield
    finally:
        _STATE.update(prev)


def active() -> bool:
    return _STATE["mesh"] is not None


def _tp_axis() -> Optional[str]:
    """The tensor-parallel axis when the split is active, else None."""
    mesh, tp = _STATE["mesh"], _STATE["tp"]
    if tp is None or tp not in (getattr(mesh, "mesh_dim_names", None) or ()):
        return None
    dp = _STATE["dp"]
    if tp in ((dp,) if isinstance(dp, str) else tuple(dp or ())):
        return None
    return tp if mesh.size(mesh.mesh_dim_names.index(tp)) > 1 else None


def tp_size() -> int:
    """The ranks the compute is split over (1 without a split)."""
    tp = _tp_axis()
    return 1 if tp is None else _STATE["mesh"].size(_STATE["mesh"].mesh_dim_names.index(tp))


def tp_rank() -> int:
    tp = _tp_axis()
    if tp is None:
        return 0
    mesh = _STATE["mesh"]
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(tp)]


def _group():
    return _STATE["mesh"].get_group(_tp_axis())


def seq_split() -> bool:
    """True when attention runs on a slice of the sequence (`seq_tp`)."""
    return bool(_STATE["seq_tp"]) and tp_size() > 1


def global_rows(m: int) -> int:
    """The rows across the ranks of a batch-leading activation of `m` rows
    on this rank (`m` itself without the context)."""
    return int(round(m * _STATE["rows"])) if active() else m


@contextlib.contextmanager
def seq_rows():
    """Within it, activations hold a slice of the sequence as well
    (`seq_split`): `global_rows` counts the other slices."""
    prev = _STATE["rows"]
    _STATE["rows"] = prev * tp_size()
    try:
        yield
    finally:
        _STATE["rows"] = prev


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


# ---------------------------------------------------------------------------
# the split's collectives: c10d calls inside autograd Functions
# ---------------------------------------------------------------------------


def _sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the split's ranks, in f32 (exact for two ranks' bf16
    values), back in `x`'s dtype."""
    out = x.to(torch.float32, copy=True, memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=_group())
    return out.to(x.dtype)


def _gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The split's slices of `x` concatenated along `dim`, in rank order
    (bf16 moved as its bits)."""
    n = tp_size()
    moved = x.movedim(dim, 0).contiguous()
    src = moved.view(torch.int16) if moved.dtype == torch.bfloat16 else moved
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _ALL_GATHER(out, src, group=_group())
    if moved.dtype == torch.bfloat16:
        out = out.view(torch.bfloat16)
    return out.movedim(0, dim)


def _slice(x: torch.Tensor, dim: int) -> torch.Tensor:
    size = x.shape[dim] // tp_size()
    return x.narrow(dim, tp_rank() * size, size)


def _reduce_scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's slice along `dim` of the split's sum of `x`, in f32,
    back in `x`'s dtype."""
    n = tp_size()
    moved = x.movedim(dim, 0).to(torch.float32, copy=True,
                                 memory_format=torch.contiguous_format)
    out = torch.empty((moved.shape[0] // n,) + tuple(moved.shape[1:]), dtype=torch.float32,
                      device=x.device)
    _REDUCE_SCATTER(out, moved, group=_group())
    return out.movedim(0, dim).to(x.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _sum(g)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _sum(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _slice(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim), None


class _Unsplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim), None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim), None


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    """A replicated activation entering a split computation: the same
    tensor forward, its gradient summed over the split's ranks backward."""
    return _Copy.apply(x) if tp_size() > 1 else x


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the split's ranks of their partial results; the
    gradient passes as it is."""
    return _Sum.apply(x) if tp_size() > 1 else x


@torch.no_grad()
def tp_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise MAX over the split's ranks (no gradient), in `x`'s
    dtype (through f32, exact)."""
    if tp_size() == 1:
        return x
    out = x.to(torch.float32, copy=True, memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_group())
    return out.to(x.dtype)


def gather_seq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """K or V of every slice of the sequence, concatenated along `dim`; the
    backward sums the ranks' gradients and keeps this rank's slice."""
    return _GatherSum.apply(x, dim) if seq_split() else x


def seq_slice(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's slice of the sequence of a tensor that takes no
    gradient (positions).  A no-op unless `seq_split`."""
    return _slice(x, dim) if seq_split() else x


def constrain_seq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """seq_tp (context-parallel attention): this rank's slice of the
    sequence (`dim` of a (B, S, ...) activation or its positions); the
    backward gathers the slices' gradients.  A no-op unless `seq_split`."""
    return _Split.apply(x, dim) if seq_split() else x


def constrain_unseq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Megatron-SP's transition back: the slices gathered into the whole
    sequence; the backward keeps this rank's slice.  A no-op unless
    `seq_split`."""
    return _Unsplit.apply(x, dim) if seq_split() else x
