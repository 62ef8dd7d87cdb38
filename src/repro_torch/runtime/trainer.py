"""Fault-tolerant training runtime, on one device or over a device mesh.

Builds the train step, wires the data pipeline, checkpoints step-atomically
and resumes bitwise-identically, injects failures, and accounts stragglers
by the deadline policy (under a mesh the ranks drop a step together).

train_step = forward (chunked CE, `models.model.loss_fn`) -> backward
(autograd) -> AdamW update; each part runs inside a `spans.span` range
(`loss`, `backward`, `optimizer`) for a profiler.  Autograd runs the
backward's device work on its own thread, outside the `backward` range's
device span, so the step's device time splits as `loss`, `optimizer` and
the rest.  The kernels run in the forward and again in its recomputation
under `cfg.remat`; the backward is plain PyTorch (`kernels/ops.py`).

With `fabric=` (a `core.fabric.Fabric` or a preset name) the trainer also
models the photonic fabric under the data-parallel gradient collective: a
channel plan and the exposed network seconds a step (`net_s` in each
history row), replanned when `inject_fault` (or `run(fault_at=,
fault_scenario=)`) degrades the fabric, and `FabricUnusableError` when
nothing survives.  The model changes no numerics.

`make_train_step(param_wire=)` trains under the parameter wire format
(`parallel.wire`) on one device.  `build_sharded_step` and
`Trainer(mesh=)` train over a `DeviceMesh`: DTensor-sharded state, the
batch split over the data-parallel ranks, the compute split over `model`
(Megatron-style tensor parallelism, `parallel.actx`), each weight
gathered where the forward uses it and its gradient reduce-scattered
straight into the rank's shard (`parallel.collectives`), additional
`gather` and `grad_reduce` ranges.  As in the reference, the trainer
without a mesh builds its step with no wire, whatever `cfg.wire_bits`
says; under a mesh `cfg.wire_bits` puts the wire on the step's gathers
(`wire.make_param_wire(cfg, mesh, rules, param_specs)`).

What a rank holds under a mesh of N ranks (a leaf sharded N ways; a leaf
a mesh axis does not split is held whole along that axis): 16/N bytes a
parameter for its shards of the f32 parameters, m, v and gradient (the
update is written into the shards in place), plus one layer's parameters
and their gradient as the gather makes them while that layer runs
forward, is recomputed or runs backward (`cfg.remat` "full", every
config's default, and "dots", which recomputes in full here): the leaves
the tensor-parallel split keeps split at 1/model of their bytes (the
attention's by heads, the MLP's by `ffn`, the experts), the others whole;
plus the gathered embedding and head (split by vocabulary where it
divides) and zamba2's shared attention block while they are in use, plus
the activations.  Under `cfg.remat="none"` autograd keeps each layer's
gathered weights for the backward, so a rank holds them all through the
backward (ROADMAP.md, Deviations).
"""
from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import require_device
from repro_torch import tree as T
from repro_torch.checkpoint import store
from repro_torch.core.fabric import degrade, get_fabric, overlapped_step_s
from repro_torch.core.faults import FabricUnusableError, FaultScenario
from repro_torch.core.planner import plan_collective_channels
from repro_torch.data.pipeline import DataConfig, DeadlineMonitor, SyntheticLM
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.parallel import actx
from repro_torch.parallel import collectives as CC
from repro_torch.parallel import sharding as S
from repro_torch.parallel import wire as W
from repro_torch.spans import span


class FailureInjected(RuntimeError):
    """Raised by the failure hook to simulate a node loss mid-run."""


def _split_microbatches(batch: Dict[str, torch.Tensor], accum: int) -> Dict[str, torch.Tensor]:
    """(B, ...) leaves -> (accum, B/accum, ...); the (3,B,S) M-RoPE positions
    leaf splits on axis 1."""
    def leaf(x):
        if x.ndim >= 3 and x.shape[0] == 3:          # M-RoPE positions
            return x.reshape(3, accum, -1, *x.shape[2:]).movedim(1, 0)
        return x.reshape(accum, -1, *x.shape[1:])
    return {k: leaf(v) for k, v in batch.items()}


def check_masters(params) -> None:
    """Raise `ValueError` unless every master weight is f32 (an optimizer
    steps f32 masters; serving may store MoE experts in the compute dtype,
    `layers.init_moe`)."""
    bad = [name for name, p in T.leaves_with_path(params) if p.dtype != torch.float32]
    if bad:
        raise ValueError(f"training needs f32 masters; not f32: {bad[:4]}"
                         + (f" and {len(bad) - 4} more" if len(bad) > 4 else ""))


def _accumulate(cfg: ModelConfig, leaves, params_of, batch: Dict[str, torch.Tensor],
                accum_steps: int, device: torch.device):
    """(loss, metrics {ce, aux}, gradients of `leaves`) of one batch, the
    loss taken on `params_of()`'s tree, over `accum_steps` microbatches run
    in turn (gradients summed in f32 and averaged)."""
    def grads_of(mb):
        with span("loss"):
            loss, metrics = M.loss_fn(cfg, params_of(), mb, device=device)
        with span("backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    if accum_steps == 1:
        return grads_of(batch)
    mbs = _split_microbatches(batch, accum_steps)
    g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    l_sum = torch.zeros((), dtype=torch.float32, device=device)
    mets = []
    for i in range(accum_steps):
        l, m, g = grads_of({k: v[i] for k, v in mbs.items()})
        g_sum = [a + b for a, b in zip(g_sum, g)]
        l_sum = l_sum + l
        mets.append(m)
    metrics = {k: torch.mean(torch.stack([m[k] for m in mets])) for k in mets[0]}
    return l_sum / accum_steps, metrics, [g / accum_steps for g in g_sum]


def _loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], param_wire,
                    accum_steps: int, device: torch.device):
    """(loss, metrics {ce, aux}, gradients in `T.leaves(params)` order) of
    one batch, as `make_train_step` describes."""
    if param_wire is None:
        diff_var = params
    else:
        qtree = param_wire.quantize(params)     # outside autograd, once
        diff_var = param_wire.carrier(params)
    diff_var = T.map_structure(lambda p: p.detach().requires_grad_(True), diff_var)
    leaves = T.leaves(diff_var)

    def params_of():       # the loss's tree, built anew for each microbatch
        return diff_var if param_wire is None else param_wire.graft(qtree, diff_var)

    return _accumulate(cfg, leaves, params_of, batch, accum_steps, device)


def make_train_step(cfg: ModelConfig, opt: adamw.OptConfig, param_wire=None,
                    accum_steps: int = 1, device="cuda"):
    """`step(state, batch) -> (new_state, metrics)`, metrics {ce, aux, loss,
    grad_norm} as f32 scalar tensors; `batch` holds tensors on `device`.

    `param_wire` (`parallel.wire.ParamWire`) runs the loss on the wire's
    tree: the layer-stacked masters quantized once per step outside
    autograd into int8 pairs, dequantized inside each layer body, and the
    other weights quantized (or cast) in place; the differentiated leaves
    are the wire's carrier, so the gradients come back as the master
    tree's, straight through.

    `accum_steps` > 1 runs gradient accumulation: the batch is split into
    microbatches run in turn, gradients summed in f32 and averaged, ONE
    optimizer update."""
    device = require_device(device)

    def step_fn(state: adamw.TrainState, batch: Dict[str, torch.Tensor]):
        loss, metrics, grads = _loss_and_grads(cfg, state.params, batch, param_wire,
                                               accum_steps, device)
        with span("optimizer"):
            grad_tree = T.unflatten(state.params, grads)
            new_state = adamw.apply_updates(opt, state, grad_tree)
            metrics = dict(metrics, loss=loss, grad_norm=adamw.global_norm(grad_tree))
        return new_state, metrics
    return step_fn


# ---------------------------------------------------------------------------
# the sharded step over a device mesh
# ---------------------------------------------------------------------------


def _as_dtensor(mesh, local: torch.Tensor, spec, shape):
    """This rank's shard `local` of a tensor of `shape` laid out as `spec`."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, S.placements(mesh, spec, len(shape)),
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _is_sharded(sh) -> bool:
    """True when a leaf laid out by the `NamedSharding` `sh` is split (held
    as a DTensor); a leaf whose spec names no axis stays a plain tensor."""
    return any(a is not None for a in sh.spec)


def _to_local(t):
    """A DTensor's local shard (its storage), any other leaf as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def distribute(mesh, tree, shardings, device=None):
    """Full tensors (the same on every rank) -> DTensors holding copies of
    this rank's shards, laid out as `shardings` (a tree of `NamedSharding`s
    of the same structure; a leaf whose spec is empty, such as the step,
    stays a plain tensor, also a copy), moved to `device` when given.  No
    communication.  The copies are the state's own: the sharded step
    updates them in place."""
    def leaf(t, sh):
        dev = t.device if device is None else torch.device(device)
        if not _is_sharded(sh):
            return t.to(dev, copy=True)
        local = S.local_shard(mesh, sh.spec, t)
        local = local.to(dev, copy=True, memory_format=torch.contiguous_format)
        return _as_dtensor(mesh, local, sh.spec, t.shape)

    return T.map_structure(leaf, tree, shardings)


def sharded_init(mesh, opt: adamw.OptConfig, cfg: ModelConfig, state_sh, seed: int = 0,
                 device="cuda") -> adamw.TrainState:
    """A fresh state over `mesh`, laid out as `state_sh`, built shard by
    shard: every rank draws `M.init(cfg, seed)`'s leaves in its order, on
    `device`, with f32 experts, and keeps only its shard of each as soon as
    it is drawn (`M.init(keep=)`), so that a rank holds at most one whole
    leaf; the moments are made as the rank's shards.  Its shards equal
    those `distribute` cuts from `M.init`'s state, bit for bit."""
    rules = S.rules_for(cfg, mesh)

    def keep(axes, t):
        spec = S.fix_pspec_for_shape(mesh, S.spec_to_pspec(axes, rules), tuple(t.shape))
        local = S.local_shard(mesh, spec, t)
        if local.numel() == t.numel():
            return t
        return local.clone(memory_format=torch.contiguous_format)   # frees the whole leaf

    local = adamw.init_state(opt, M.init(cfg, seed=seed, device=device,
                                         expert_dtype=torch.float32, keep=keep))
    shapes, _ = M.init_abstract(cfg)

    def wrap(z, like, sh):
        return _as_dtensor(mesh, z, sh.spec, like.shape) if _is_sharded(sh) else z

    return local._replace(**{k: T.map_structure(wrap, getattr(local, k), shapes,
                                                getattr(state_sh, k))
                             for k in ("params", "m", "v")})


def gather(tree, device=None):
    """Every DTensor leaf as its full tensor (a collective: every rank of its
    mesh calls it; `collectives.gather_shards`), moved to `device` when
    given; other leaves as they are.  A helper for tests and
    `Trainer.full_state`: the step gathers layer by layer."""
    from torch.distributed.tensor import DTensor

    def leaf(t):
        if isinstance(t, DTensor):
            t = CC.gather_shards(t.to_local(), t.device_mesh, t.placements)
        return t if device is None else t.to(device)

    return T.map_structure(leaf, tree)


def _batch_reduce(mesh, axes):
    """The sum over the ranks the batch is split on: the TRINE schedule when
    they are the mesh's (pod, data), or its `data` alone on a mesh without
    `pod`; one flat all-reduce over any other split; none when the batch
    is not split."""
    if axes is None:
        return lambda t: t
    if axes == tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names):
        return lambda t: CC.trine_all_reduce(t, mesh)
    return lambda t: CC.flat_all_reduce(t, mesh, axes=axes)


class _Gather(torch.autograd.Function):
    """A weight made whole from this rank's shard (`collectives.gather_shards`);
    its gradient goes straight into the rank's gradient shard, summed over
    the batch ranks and weighted by the rank's tokens
    (`collectives.reduce_to_shard`).  The backward runs once per gather, so
    a weight gathered once and used twice sums its whole gradient first."""

    @staticmethod
    def forward(ctx, local, mesh, placements, axes, share):
        ctx.args = (mesh, placements, axes, share)
        with span("gather"):
            return CC.gather_shards(local, mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        with span("grad_reduce"):
            return (CC.reduce_to_shard(grad, *ctx.args),) + (None,) * 4


class _BatchMean(torch.autograd.Function):
    """The batch ranks' mean of a per-rank mean, each rank's weighted by its
    tokens (`share`): a flat all-reduce of `x * share`.  Its backward is the
    transpose, `share` times the all-reduced gradient; with the step's
    equal shares (`S.local_shard` splits the batch evenly) and its weighting
    of each rank's gradient by `share`, the gradient is the global batch's."""

    @staticmethod
    def forward(ctx, x, mesh, axes, share):
        ctx.args = (mesh, axes, share)
        return CC.flat_all_reduce(x * share, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        mesh, axes, share = ctx.args
        return (CC.flat_all_reduce(grad, mesh, axes) * share, None, None, None)


class _WireGather(torch.autograd.Function):
    """`_Gather` under the parameter wire (`parallel.wire.MeshStep`): the
    shard crosses as int8 levels (`levels`, a pair's, or the master shard
    `local` quantized here with `scale`) or in bf16 (`scale` None), and is
    dequantized after the gather in `dtype`, with the scales of what the
    gather made (`whole_scale`); the gradient goes straight through to the
    master shard (for a pair, the `~d` carrier `local`), reduced as
    `_Gather`'s."""

    @staticmethod
    def forward(ctx, local, levels, scale, whole_scale, dtype, mesh, placements, axes, share):
        ctx.args = (mesh, placements, axes, share)
        with span("gather"):
            if scale is None:
                return CC.gather_shards(local.to(dtype), mesh, placements)
            if levels is None:
                levels = W._levels(local.to(torch.float32), scale)
            return CC.gather_shards(levels, mesh, placements).to(dtype) * whole_scale.to(dtype)

    @staticmethod
    def backward(ctx, grad):
        with span("grad_reduce"):
            return (CC.reduce_to_shard(grad.to(torch.float32), *ctx.args),) + (None,) * 8


class _ShardGather:
    """The sharded step's parameter gather (`models.model.param_gather`):
    for the leaves of this step's local tree (known by identity), `_Gather`
    of the leaf, or of its layer `i`, whose placements lose the layer
    dimension (never sharded: the rules map "layers" to no axis); any other
    tensor as it is (a replicated leaf, or a weight gathered already).
    A leaf in `tp_local` keeps its `model` slice (the tensor-parallel
    split): gathered and reduced over the other axes only.  A leaf in
    `wired` crosses under the parameter wire (`_WireGather`)."""

    def __init__(self, mesh, axes, share: float, leaves, shardings, tp_local, wired=None):
        from torch.distributed.tensor import Replicate, Shard

        self.mesh, self.axes, self.share = mesh, axes, share
        self.wired = wired or {}
        self.placements = {}          # id -> (the leaf's placements, a layer's)
        for t, sh, keep in zip(leaves, shardings, tp_local):
            if _is_sharded(sh):
                pl = S.placements(mesh, sh.spec, t.ndim)
                if keep:
                    pl = [Replicate() if name == "model" else p
                          for name, p in zip(mesh.mesh_dim_names, pl)]
                self.placements[id(t)] = (pl, [Shard(p.dim - 1) if p.is_shard() else p
                                               for p in pl])

    def __call__(self, tree, i=None):
        def leaf(t):
            x = t if i is None else t[i]
            pl = self.placements.get(id(t))
            if pl is None:
                return x
            args = (self.mesh, pl[i is not None], self.axes, self.share)
            wire = self.wired.get(id(t))
            if wire is None:
                return _Gather.apply(x, *args)
            kind, levels, scale, whole, dtype = wire
            if i is not None and kind == "pair":
                levels, scale, whole = levels[i], scale[i], whole[i]
            elif scale is not None and scale.ndim > x.ndim:
                # a stack's layer under its one per-tensor scale
                scale, whole = (t.reshape((1,) * x.ndim) for t in (scale, whole))
            return _WireGather.apply(x, levels, scale, whole, dtype, *args)

        return T.map_structure(leaf, tree)


def tp_split_leaves(cfg: ModelConfig, mesh, batch_axes, param_sh, param_specs=None) -> list:
    """Per parameter leaf (in `T.leaves` order, `param_sh` their
    `NamedSharding`s over `mesh`, a `DeviceMesh` or a geometry): True when
    the tensor-parallel split keeps the leaf's `model` slice (the mesh's
    `model` axis, of size > 1 and not among `batch_axes`, lies on a
    dimension whose logical axis `M.tp_split_specs` names), else False
    (the leaf is gathered whole over `model` as well)."""
    sizes = CC.mesh_axis_sizes(mesh)
    batch_axes = (batch_axes,) if isinstance(batch_axes, str) else tuple(batch_axes or ())
    if sizes.get("model", 1) == 1 or "model" in batch_axes:
        return [False] * len(param_sh)

    def boxed(specs):
        return T.leaves(S._map_specs(lambda a: SimpleNamespace(axes=a or ()), specs))

    logical = boxed(M.param_specs(cfg) if param_specs is None else param_specs)
    split = boxed(M.tp_split_specs(cfg))

    def keeps(sh, lg, sp):
        for ax, name in zip(sh.spec, lg.axes):
            if "model" in ((ax,) if isinstance(ax, str) else tuple(ax or ())):
                return name in sp.axes
        return False

    return [keeps(sh, lg, sp) for sh, lg, sp in zip(param_sh, logical, split)]


def shard_global_norm(mesh, shards, shardings) -> torch.Tensor:
    """The global norm of the tensors whose shards on this rank are
    `shards`, laid out as `shardings` (a collective over the whole mesh):
    each rank sums the squares of the blocks it owns (`S.owns_shard`: a
    block several ranks hold counts once), in the leaves' order, and one
    all-reduce adds the ranks' sums."""
    sq = adamw.sum_of_squares(g for g, sh in zip(shards, shardings)
                              if S.owns_shard(mesh, sh.spec))
    sq = torch.as_tensor(sq, dtype=torch.float32, device=shards[0].device)
    return torch.sqrt(CC.flat_all_reduce(sq, mesh, mesh.mesh_dim_names))


def _make_sharded_step(cfg: ModelConfig, opt: adamw.OptConfig, mesh, state_sh, batch_sh,
                       accum_steps: int, device: torch.device, param_specs, param_wire=None):
    axes = batch_sh["tokens"].spec[0]
    axes = (axes,) if isinstance(axes, str) else axes
    reduce = _batch_reduce(mesh, axes)
    param_sh = T.leaves(state_sh.params)
    replicated = [j for j, sh in enumerate(param_sh) if not _is_sharded(sh)]
    tp_local = tp_split_leaves(cfg, mesh, axes, param_sh, param_specs)
    seq_tp = cfg.parallel_strategy == "seq_tp"

    def step_fn(state: adamw.TrainState, batch: Dict[str, torch.Tensor]):
        local = {k: S.local_shard(mesh, batch_sh[k].spec, v) for k, v in batch.items()}
        share = local["tokens"].numel() / batch["tokens"].numel()   # this rank's tokens
        if param_wire is None:
            leaves = [_to_local(p).detach().requires_grad_(True) for p in T.leaves(state.params)]
            params = T.unflatten(state.params, leaves)
            params_of, wired = (lambda: params), None
        else:
            wire = param_wire.mesh_step(T.map_structure(_to_local, state.params),
                                        state_sh.params, tp_local)
            leaves, params_of, wired = wire.leaves, wire.tree, wire.wired
        gather_fn = _ShardGather(mesh, axes, share, leaves, param_sh, tp_local, wired)
        mean_fn = None if axes is None else (lambda x: _BatchMean.apply(x, mesh, axes, share))
        with M.param_gather(gather_fn), L.batch_mean(mean_fn), actx.activation_sharding(
                mesh, axes, "model", seq_tp=seq_tp, rows=1 / share):
            loss, metrics, grads = _accumulate(cfg, leaves, params_of, local,
                                               accum_steps, device)
        with span("grad_reduce"):
            # the sharded leaves' gradients came back as this rank's shards
            # of the global batch's; the replicated leaves' (norm scales and
            # the like) are summed here, in one all-reduce
            if replicated and axes:
                flat = torch.cat([grads[j].reshape(-1) for j in replicated])
                if share != 1:
                    flat.mul_(share)
                flat = reduce(flat)
                sizes = [grads[j].numel() for j in replicated]
                for j, f in zip(replicated, torch.split(flat, sizes)):
                    grads[j] = f.view(grads[j].shape)
            scalars = torch.stack([loss, metrics["ce"], metrics["aux"]])
            scalars = CC.flat_all_reduce(scalars * share, mesh, axes) if axes else scalars
        with span("optimizer"):
            gn = shard_global_norm(mesh, grads, param_sh)
            local_state = T.map_structure(_to_local, state)
            new_local = adamw.apply_updates(opt, local_state, T.unflatten(state.params, grads),
                                            grad_norm=gn, inplace=True)
            new_state = state._replace(step=new_local.step)
        metrics = {"ce": scalars[1], "aux": scalars[2], "loss": scalars[0], "grad_norm": gn}
        return new_state, metrics
    return step_fn


def state_shardings(cfg: ModelConfig, mesh, param_specs=None):
    """The train state's layout over `mesh`: `enforce_divisibility(
    tree_shardings(mesh, state_specs(param_specs), rules_for(cfg, mesh)))`
    on `init_abstract`'s shapes (`param_specs` defaults to `cfg`'s)."""
    shapes, specs = M.init_abstract(cfg)
    abstract = adamw.TrainState(step=torch.empty((), dtype=torch.int32, device="meta"),
                                params=shapes, m=shapes, v=shapes)
    return S.enforce_divisibility(S.tree_shardings(
        mesh, adamw.state_specs(specs if param_specs is None else param_specs),
        S.rules_for(cfg, mesh)), abstract)


def build_sharded_step(cfg: ModelConfig, opt: adamw.OptConfig, mesh, param_specs,
                       batch_example, device="cuda", accum_steps: int = 1):
    """The train step over `mesh` (a `DeviceMesh`): returns (step,
    state_shardings, batch_shardings); `mesh=None` returns the one-device
    step alone, as the reference's does.

    The state (params, m, v) lives as DTensors laid out by
    `state_shardings` (`distribute` puts a copy of a full state there,
    `sharded_init` draws a fresh one shard by shard).
    `step(state, batch)` takes the GLOBAL batch on every rank and runs on
    the rank's shard of it (`train_batch_shardings`).  The forward and
    backward are `make_train_step`'s, on plain local tensors: each weight is
    gathered where the forward uses it (`model.param_gather`: a layer's
    weights at its body's entry, inside the checkpoint, so that the
    recomputation gathers them again), and the kernels see plain,
    contiguous tensors, never a DTensor.  On a mesh whose `model` axis the
    batch does not span, the compute splits over it (the reference's GSPMD
    split, here explicit: `parallel.actx`, `models.layers`): the gather
    keeps the `model` slice of the leaves `tp_split_leaves` names (the
    attention's heads, the MLP's `ffn`, the experts, the vocabulary), the
    blocks compute on their slices and sum their partial results over
    `model`, and the other leaves (mamba's, xLSTM's, an attention whose
    heads do not divide, so that `head_dim` carries the axis) are gathered
    whole and computed the same on every `model` rank.  Under `seq_tp`
    attention runs on a slice of the sequence.  The photonic numerics
    choose their path on the global batch's rows and the whole weight's
    shape, as the reference's compiled step does (`kernels.ops.Shard`).
    Each gather's backward turns the weight's gradient straight into the
    rank's gradient shard, each rank's weighted by its share of the
    tokens and summed over the ranks the batch is split on
    (`collectives.reduce_to_shard`); the replicated leaves' gradients are
    summed in one all-reduce (`trine_all_reduce` over (pod, data),
    `flat_all_reduce` otherwise).  MoE layers average their load-balance
    statistics over the batch ranks inside the forward
    (`layers.batch_mean`).  The clipping norm comes from the shards (each
    block counted on one rank, one all-reduce), and AdamW updates each
    rank's shards in place: the state passed in is the one returned, with
    its step advanced.  The loss, its parts and the clipping norm are the
    global batch's.  The module docstring counts what a rank holds.

    `cfg.wire_bits` puts the parameter wire on the gathers
    (`wire.MeshStep`): int8 levels (or bf16) cross, dequantized after the
    gather, the gradient straight through to the f32 master shards."""
    device = require_device(device)
    if mesh is None:
        return make_train_step(cfg, opt, accum_steps=accum_steps, device=device)
    specs = M.param_specs(cfg) if param_specs is None else param_specs
    pw = (W.make_param_wire(cfg, mesh, S.rules_for(cfg, mesh), specs) if cfg.wire_bits
          else None)
    state_sh = state_shardings(cfg, mesh, specs)
    batch_sh = S.train_batch_shardings(cfg, mesh, batch_example)
    step = _make_sharded_step(cfg, opt, mesh, state_sh, batch_sh, accum_steps, device, specs, pw)
    return step, state_sh, batch_sh


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = "ckpt"
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    straggler_deadline_s: float = 1e9
    seed: int = 0
    overlap_window_s: float = 50e-3   # compute window the gradient collective
                                      # hides under (channel planning)


def _to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class Trainer:
    """Trains `cfg` on `device` from `state` (default: `model.init` at
    `tcfg.seed`, with f32 experts, and a fresh optimizer state), restoring
    the newest valid checkpoint in `tcfg.ckpt_dir` when `resume`.  A state
    with any non-f32 master raises `ValueError`.

    With `mesh` (a `DeviceMesh`; every rank of it builds a trainer with the
    same arguments) the step is `build_sharded_step`'s: a given state (the
    same on every rank) is cut into each rank's DTensor shards, a fresh one
    is drawn shard by shard (`sharded_init`), and each rank draws the
    global batch and trains on its shard of it.  A checkpoint is written
    by every rank, each its own slices (`store.save_sharded`), in the
    one-device format; a restore is verified on rank 0 and each rank reads
    its slices alone (`store.read_slices`), so no rank holds a whole leaf
    on its device or the whole state on its host, and a checkpoint
    written at one mesh (or on one device) restores at another.
    `full_state()` gives the whole state on every rank.  The straggler
    deadline drops a step on every rank when any rank's delivery missed it
    (`_admit`)."""

    def __init__(self, cfg: ModelConfig, opt: adamw.OptConfig, data: DataConfig,
                 tcfg: TrainerConfig, mesh=None, resume: bool = True, source=None,
                 fabric=None, device="cuda", state: Optional[adamw.TrainState] = None):
        self.cfg, self.opt, self.data_cfg, self.tcfg = cfg, opt, data, tcfg
        self.mesh = mesh
        self.device = require_device(device)
        self.source = source if source is not None else SyntheticLM(cfg, data)
        self.state_sh = None
        if mesh is None:
            self._step = make_train_step(cfg, opt, device=self.device)
            if state is None:
                state = adamw.init_state(opt, M.init(cfg, seed=tcfg.seed, device=self.device,
                                                     expert_dtype=torch.float32))
        else:
            self._step, self.state_sh, _ = build_sharded_step(
                cfg, opt, mesh, M.param_specs(cfg), self.source.batch_at(0), device=self.device)
            state = (sharded_init(mesh, opt, cfg, self.state_sh, seed=tcfg.seed,
                                  device=self.device) if state is None
                     else distribute(mesh, state, self.state_sh, device=self.device))
        check_masters(state.params)
        self.state = state

        self.start_step = 0
        self.restore_s = None
        if resume:
            # corrupt/truncated latest checkpoints (bad SHA1, missing
            # manifest) are dropped and the previous retained step restored
            t0 = time.perf_counter()
            restored = self._restore()
            if restored is not None:
                self.state, self.start_step = restored[0], int(restored[1])
                self.restore_s = time.perf_counter() - t0

        # modeled photonic fabric under the data-parallel gradient collective:
        # channel plan + exposed network time per step, replanned on faults
        self.fabric = None if fabric is None else get_fabric(fabric)
        self.collective_channels = None
        self.net_s = 0.0
        if self.fabric is not None:
            self._grad_bytes = 4.0 * sum(p.numel() for p in T.leaves(self.state.params))
            self._replan()

        self.monitor = DeadlineMonitor(tcfg.straggler_deadline_s)
        self.history: list = []

    # ---- checkpoints ------------------------------------------------------
    def full_state(self) -> adamw.TrainState:
        """The whole state (under a mesh a collective: every rank calls it)."""
        return self.state if self.mesh is None else gather(self.state)

    def _shards(self):
        """(path name, the leaf, its full shape, its `NamedSharding`) of each
        state leaf under the mesh."""
        return [(name, t, tuple(t.shape), sh) for (name, t), sh in
                zip(T.leaves_with_path(self.state), T.leaves(self.state_sh))]

    def _save(self, step: int) -> None:
        if self.mesh is None:
            store.save(self.tcfg.ckpt_dir, step, self.state, keep=self.tcfg.keep)
            return

        def pieces(t, shape, sh):    # this rank's slice, when it is the one to write it
            if not S.owns_shard(self.mesh, sh.spec):
                return lambda: []
            return lambda: [(S.shard_index(self.mesh, sh.spec, shape), _to_local(t))]

        leaves = [(name, shape, t.dtype, pieces(t, shape, sh))
                  for name, t, shape, sh in self._shards()]
        store.save_sharded(self.tcfg.ckpt_dir, step, leaves, keep=self.tcfg.keep,
                           first=dist.get_rank() == 0, barrier=dist.barrier)

    def _restore(self):
        if self.mesh is None:
            return store.restore_latest_valid(self.tcfg.ckpt_dir, self.state)
        shards = self._shards()
        full = T.unflatten(self.state, [SimpleNamespace(shape=shape, dtype=t.dtype)
                                        for _, t, shape, _ in shards])

        # rank 0 walks back to the newest valid step, dropping corrupt ones,
        # and every rank takes its answer: the step, -1 for none, -2 for
        # another structure, -3 for any other failure
        found, error = -1, None
        if dist.get_rank() == 0:
            try:
                step = store.latest_valid_step(self.tcfg.ckpt_dir, full)
                found = -1 if step is None else step
            except store.StructureMismatch as e:
                found, error = -2, e
            except Exception as e:
                found, error = -3, e
        seen = torch.tensor([found], dtype=torch.int64, device=self.device)
        dist.broadcast(seen, src=0)
        step = int(seen[0])
        if step <= -2:
            if error is not None:
                raise error
            raise (store.StructureMismatch if step == -2 else RuntimeError)(
                "the checkpoint check failed on rank 0")
        if step == -1:
            return None
        like = T.unflatten(self.state, [
            SimpleNamespace(index=S.shard_index(self.mesh, sh.spec, shape),
                            shape=tuple(_to_local(t).shape), dtype=t.dtype,
                            device=self.device) for _, t, shape, sh in shards])
        local = store.read_slices(self.tcfg.ckpt_dir, step, like)
        return T.map_structure(
            lambda z, sh, s: _as_dtensor(self.mesh, z, sh.spec, s.shape)
            if _is_sharded(sh) else z, local, self.state_sh, full), step

    def _admit(self, delivery_s: float) -> bool:
        """The deadline policy's verdict on this step's batch.  Under a mesh
        the ranks decide together, on the slowest rank's delivery: a rank
        that skipped a step its peers entered would leave their
        collectives unmatched."""
        if self.mesh is not None:
            t = torch.tensor([delivery_s], dtype=torch.float64, device=self.device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            delivery_s = float(t[0])
        return self.monitor.admit(delivery_s)

    # ---- fault-epoch hook -------------------------------------------------
    def _replan(self) -> None:
        """(Re)plan the gradient-collective channels against the current
        fabric and refresh the modeled exposed network time per step.
        Raises FabricUnusableError when the fabric cannot carry the
        collective at all (the hard-fail path)."""
        if self.fabric.cross_pod_bw_bytes_per_s <= 0:
            raise FabricUnusableError(
                f"fabric {self.fabric.name!r} has no surviving bandwidth; "
                f"the gradient collective cannot be scheduled")
        w = self.tcfg.overlap_window_s
        self.collective_channels = plan_collective_channels(
            self._grad_bytes, w, fabric=self.fabric, max_channels=64)
        self.net_s = overlapped_step_s(
            w, self._grad_bytes, self.fabric, self.collective_channels) - w

    def inject_fault(self, scenario: FaultScenario) -> None:
        """Degrade the fabric under `scenario` and replan the collective —
        training continues at the (modeled) reduced throughput, or hard-fails
        with FabricUnusableError when nothing survives.  The degraded
        design's energy is evaluated on the trainer's device."""
        if self.fabric is None:
            raise ValueError("trainer has no fabric to degrade")
        self.fabric = degrade(self.fabric, scenario, device=self.device)
        self._replan()

    def run(self, steps: int, fail_at: Optional[int] = None,
            quiet: bool = False, fault_at: Optional[int] = None,
            fault_scenario: Optional[FaultScenario] = None) -> Dict[str, Any]:
        """Train up to step `steps`.  Each `history` row holds the step's
        metrics, its seconds (`step_s`, host clock to the metrics on the
        host), where a checkpoint was written `ckpt_s`, and with a fabric
        the modelled exposed network seconds `net_s`.  With `fault_at`,
        `fault_scenario` is injected before step `fault_at` (1-based)."""
        t0 = time.perf_counter()
        for step in range(self.start_step, steps):
            if fault_at is not None and step + 1 == fault_at:
                self.inject_fault(fault_scenario)
            fetch_t0 = time.perf_counter()
            batch = self.source.batch_at(step)
            delivery = time.perf_counter() - fetch_t0
            if not self._admit(delivery):
                continue  # straggler drop: skip this step's batch (every rank's, under a mesh)

            t_step = time.perf_counter()
            self.state, metrics = self._step(self.state, _to_device(batch, self.device))
            row = {k: float(v) for k, v in metrics.items()}
            row["step_s"] = time.perf_counter() - t_step
            if (step + 1) % self.tcfg.ckpt_every == 0 or step + 1 == steps:
                t_ck = time.perf_counter()
                self._save(step + 1)
                row["ckpt_s"] = time.perf_counter() - t_ck
            if fail_at is not None and step + 1 == fail_at:
                raise FailureInjected(f"injected node failure at step {step + 1}")
            if not quiet and (step + 1) % self.tcfg.log_every == 0:
                print(f"step {step+1}: loss={row['loss']:.4f} gnorm={row['grad_norm']:.3f}")
            row["step"] = step + 1
            if self.fabric is not None:
                row["net_s"] = self.net_s
            self.history.append(row)
        result = {
            "final_step": steps,
            "wall_s": time.perf_counter() - t0,
            "last_loss": self.history[-1]["loss"] if self.history else None,
            "straggler": dataclasses.asdict(self.monitor.stats),
        }
        if self.fabric is not None:
            result["fabric"] = self.fabric.name
            result["collective_channels"] = self.collective_channels
            result["net_s"] = self.net_s
        return result


def run_with_restarts(make_trainer, total_steps: int, fail_at=(), **run_kwargs):
    """Supervisor loop: on FailureInjected (or a real crash in production),
    rebuild the trainer, which restores the latest checkpoint, and continue.
    Returns the last trainer, with `history` merged across segments so
    post-restart reports cover the full run (steps replayed after a restore
    keep only their re-executed rows: each step appears exactly once)."""
    pending = list(fail_at)
    prior: list = []
    while True:
        tr = make_trainer()
        # drop first-execution rows of steps the restored trainer will replay
        prior = [h for h in prior if h.get("step", 0) <= tr.start_step]
        try:
            tr.run(total_steps, fail_at=pending[0] if pending else None, quiet=True,
                   **run_kwargs)
            tr.history = prior + tr.history
            return tr
        except FailureInjected:
            prior = prior + tr.history
            pending.pop(0)
            continue
