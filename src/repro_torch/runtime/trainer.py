"""Fault-tolerant training runtime, on one device or over a device mesh.

Builds the train step, wires the data pipeline, checkpoints step-atomically
and resumes bitwise-identically, injects failures, and accounts stragglers
by the deadline policy (under a mesh the ranks drop a step together).

train_step = forward (chunked CE, `models.model.loss_fn`) -> backward
(autograd) -> AdamW update; each part runs inside a `layers._span` range
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
batch split over the data-parallel ranks, the gradients summed by the
TRINE all-reduce (`parallel.collectives`), additional `gather` and
`grad_reduce` ranges.  As in the reference, the trainer without a mesh
builds its step with no wire, whatever `cfg.wire_bits` says; under a mesh
`cfg.wire_bits` raises, since the sharded wire is not ported.

Under a mesh each rank holds only its shards of the state (params, m, v:
12/N bytes a parameter over N ranks) between steps, but the step itself is
not memory-sharded: it gathers the full f32 parameters (4 bytes a
parameter) and computes the full gradient (4 bytes), and the reduction
holds the flat gradient and the schedule's full result (8 bytes, 12 when
the length needs padding to the data size) once the parameters are freed.
So a rank needs about 8-12 bytes a parameter besides the activations,
whatever the mesh: only configs that train on one card train under a mesh
(ROADMAP.md, Deviations).
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
from repro_torch.parallel import collectives as CC
from repro_torch.parallel import sharding as S
from repro_torch.parallel import wire as W


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


def _loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], param_wire,
                    accum_steps: int, device: torch.device):
    """(loss, metrics {ce, aux}, gradients in `T.leaves(params)` order) of
    one batch, as `make_train_step` describes."""
    def grads_of(leaves, params_of, mb):
        with L._span("loss"):
            loss, metrics = M.loss_fn(cfg, params_of(), mb, device=device)
        with L._span("backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    if param_wire is None:
        diff_var = params
    else:
        qtree = param_wire.quantize(params)     # outside autograd, once
        diff_var = param_wire.carrier(params)
    diff_var = T.map_structure(lambda p: p.detach().requires_grad_(True), diff_var)
    leaves = T.leaves(diff_var)

    def params_of():       # the loss's tree, built anew for each microbatch
        return diff_var if param_wire is None else param_wire.graft(qtree, diff_var)

    if accum_steps == 1:
        return grads_of(leaves, params_of, batch)
    mbs = _split_microbatches(batch, accum_steps)
    g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    l_sum = torch.zeros((), dtype=torch.float32, device=device)
    mets = []
    for i in range(accum_steps):
        l, m, g = grads_of(leaves, params_of, {k: v[i] for k, v in mbs.items()})
        g_sum = [a + b for a, b in zip(g_sum, g)]
        l_sum = l_sum + l
        mets.append(m)
    metrics = {k: torch.mean(torch.stack([m[k] for m in mets])) for k in mets[0]}
    return l_sum / accum_steps, metrics, [g / accum_steps for g in g_sum]


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
        with L._span("optimizer"):
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


def distribute(mesh, tree, shardings, device=None):
    """Full tensors (the same on every rank) -> DTensors holding this
    rank's shards, laid out as `shardings` (a tree of `NamedSharding`s of
    the same structure; a leaf whose spec is empty, such as the step,
    stays a plain replicated tensor), moved to `device` when given (only
    the shard is copied).  No communication."""
    def leaf(t, sh):
        dev = t.device if device is None else torch.device(device)
        if not any(a is not None for a in sh.spec):
            return t.to(dev)
        local = S.local_shard(mesh, sh.spec, t)
        if local.numel() != t.numel() or local.device != dev:    # free the full tensor
            local = local.to(dev, copy=True, memory_format=torch.contiguous_format)
        return _as_dtensor(mesh, local, sh.spec, t.shape)

    return T.map_structure(leaf, tree, shardings)


def sharded_init(mesh, opt: adamw.OptConfig, params, state_sh) -> adamw.TrainState:
    """A fresh optimizer state over full `params` (the same on every rank),
    laid out as `state_sh`, with no full moment allocated: the parameters
    are split first and the moments made as the rank's shards."""
    from torch.distributed.tensor import DTensor

    params = distribute(mesh, params, state_sh.params)
    local = adamw.init_state(opt, T.map_structure(
        lambda p: p.to_local() if isinstance(p, DTensor) else p, params))

    def wrap(z, p, sh):
        return _as_dtensor(mesh, z, sh.spec, p.shape) if isinstance(p, DTensor) else z

    return local._replace(params=params, m=T.map_structure(wrap, local.m, params, state_sh.m),
                          v=T.map_structure(wrap, local.v, params, state_sh.v))


def gather(tree, device=None):
    """Every DTensor leaf as its full tensor (a collective: every rank of its
    mesh calls it), moved to `device` when given; other leaves as they are.
    The shards are all-gathered along each sharded mesh dimension, the
    innermost first, with the c10d calls of `parallel.collectives`; a
    dimension of size 1 holds the whole (no copy: at one rank the result is
    the shard's own storage)."""
    from torch.distributed.tensor import DTensor

    def leaf(t):
        if isinstance(t, DTensor):
            full = t.to_local()
            for i in reversed(range(t.device_mesh.ndim)):
                p = t.placements[i]
                if p.is_shard() and t.device_mesh.size(i) > 1:
                    parts = CC.all_gather(full, t.device_mesh.get_group(i))
                    full = torch.cat(tuple(parts), dim=p.dim)
            t = full
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


def _make_sharded_step(cfg: ModelConfig, opt: adamw.OptConfig, mesh, state_sh, batch_sh,
                       accum_steps: int, device: torch.device):
    from torch.distributed.tensor import DTensor

    axes = batch_sh["tokens"].spec[0]
    axes = (axes,) if isinstance(axes, str) else axes
    reduce = _batch_reduce(mesh, axes)
    param_sh = T.leaves(state_sh.params)

    def to_local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    def step_fn(state: adamw.TrainState, batch: Dict[str, torch.Tensor]):
        local = {k: S.local_shard(mesh, batch_sh[k].spec, v) for k, v in batch.items()}
        share = local["tokens"].numel() / batch["tokens"].numel()   # this rank's tokens
        with L._span("gather"):
            params = gather(state.params)
        loss, metrics, grads = _loss_and_grads(cfg, params, local, None, accum_steps, device)
        del params
        with L._span("grad_reduce"):
            # the global batch's mean: each rank's mean weighted by its tokens
            shapes = [g.shape for g in grads]
            flat = torch.cat([g.reshape(-1) for g in grads])
            del grads
            if share != 1:
                flat.mul_(share)
            flat = reduce(flat)
            scalars = torch.stack([loss, metrics["ce"], metrics["aux"]])
            scalars = CC.flat_all_reduce(scalars * share, mesh, axes) if axes else scalars
        grads = [f.view(sh) for f, sh in zip(torch.split(flat, [sh.numel() for sh in shapes]),
                                             shapes)]
        with L._span("optimizer"):
            gn = adamw.global_norm(grads)
            mine = [S.local_shard(mesh, sh.spec, g).contiguous() for g, sh in zip(grads, param_sh)]
            local_state = T.map_structure(to_local, state)
            new_local = adamw.apply_updates(opt, local_state, T.unflatten(state.params, mine),
                                            grad_norm=gn)
            new_state = T.map_structure(
                lambda t, old: DTensor.from_local(t, old.device_mesh, old.placements,
                                                  run_check=False, shape=old.shape,
                                                  stride=old.stride())
                if isinstance(old, DTensor) else t, new_local, state)
        metrics = {"ce": scalars[1], "aux": scalars[2], "loss": scalars[0], "grad_norm": gn}
        return new_state, metrics
    return step_fn


def build_sharded_step(cfg: ModelConfig, opt: adamw.OptConfig, mesh, param_specs,
                       batch_example, device="cuda", accum_steps: int = 1):
    """The train step over `mesh` (a `DeviceMesh`): returns (step,
    state_shardings, batch_shardings); `mesh=None` returns the one-device
    step alone, as the reference's does.

    The state (params, m, v) lives as DTensors laid out by
    `enforce_divisibility(tree_shardings(mesh, state_specs(param_specs),
    rules_for(cfg, mesh)))` (`distribute` puts a full state there,
    `sharded_init` a fresh one).
    `step(state, batch)` takes the GLOBAL batch on every rank and runs on
    the rank's shard of it (`train_batch_shardings`); it gathers the
    parameters whole, runs `make_train_step`'s forward and backward on
    plain local tensors (the kernels see no DTensor), sums the gradients,
    each rank's weighted by its share of the tokens, over the ranks the
    batch is split on (`trine_all_reduce` over (pod, data), `flat_all_reduce`
    otherwise), and updates each rank's shards with AdamW clipped by the
    whole gradient's norm.  The loss, its parts and the clipping norm are
    the global batch's.  The `model`-axis ranks hold the same batch shard
    and compute the same gradients: GSPMD splits that work in the
    reference, and this step does not (ROADMAP.md).  Nor does it shard
    the step's memory: the module docstring counts what a rank holds.

    MoE configs raise `NotImplementedError` (their expert-parallel dispatch
    is not ported), and so does `cfg.wire_bits` (the sharded parameter
    wire)."""
    device = require_device(device)
    if mesh is None:
        return make_train_step(cfg, opt, accum_steps=accum_steps, device=device)
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: an MoE config under a mesh needs the "
                                  f"expert-parallel dispatch, which is not ported")
    if cfg.wire_bits:
        W.make_param_wire(cfg, mesh)     # raises: the sharded wire is not ported
    rules = S.rules_for(cfg, mesh)
    shapes, _ = M.init_abstract(cfg)
    abstract = adamw.TrainState(step=torch.empty((), dtype=torch.int32, device="meta"),
                                params=shapes, m=shapes, v=shapes)
    state_sh = S.enforce_divisibility(
        S.tree_shardings(mesh, adamw.state_specs(param_specs), rules), abstract)
    batch_sh = S.train_batch_shardings(cfg, mesh, batch_example)
    step = _make_sharded_step(cfg, opt, mesh, state_sh, batch_sh, accum_steps, device)
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
    same arguments) the step is `build_sharded_step`'s: the state (the same
    on every rank) is split into each rank's DTensor shards (a fresh one
    by `sharded_init`), each rank draws the global batch and trains on its
    shard of it.  A checkpoint gathers the state leaf by leaf and rank 0
    writes it; a restore reads it on every rank's host and moves the
    rank's shards to the device.  `full_state()` gives the whole state on
    every rank.  The straggler deadline drops a step on every rank when
    any rank's delivery missed it (`_admit`)."""

    def __init__(self, cfg: ModelConfig, opt: adamw.OptConfig, data: DataConfig,
                 tcfg: TrainerConfig, mesh=None, resume: bool = True, source=None,
                 fabric=None, device="cuda", state: Optional[adamw.TrainState] = None):
        self.cfg, self.opt, self.data_cfg, self.tcfg = cfg, opt, data, tcfg
        self.mesh = mesh
        self.device = require_device(device)
        self.source = source if source is not None else SyntheticLM(cfg, data)
        params = None
        if state is None:
            params = M.init(cfg, seed=tcfg.seed, device=self.device, expert_dtype=torch.float32)
        check_masters(params if state is None else state.params)
        self.state_sh = None
        if mesh is None:
            self._step = make_train_step(cfg, opt, device=self.device)
            state = adamw.init_state(opt, params) if state is None else state
        else:
            self._step, self.state_sh, _ = build_sharded_step(
                cfg, opt, mesh, M.param_specs(cfg), self.source.batch_at(0), device=self.device)
            state = (sharded_init(mesh, opt, params, self.state_sh) if state is None
                     else distribute(mesh, state, self.state_sh))
        del params
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

    def _save(self, step: int) -> None:
        if self.mesh is None:
            store.save(self.tcfg.ckpt_dir, step, self.state, keep=self.tcfg.keep)
            return
        rank0 = dist.get_rank() == 0

        def leaf(t):   # one whole leaf on the device at a time; rank 0 keeps it on the host
            t = gather(t, device="cpu" if rank0 else None)
            return t if rank0 else None

        full = T.map_structure(leaf, self.state)
        if rank0:
            store.save(self.tcfg.ckpt_dir, step, full, keep=self.tcfg.keep)
        del full
        dist.barrier()

    def _restore(self):
        if self.mesh is None:
            return store.restore_latest_valid(self.tcfg.ckpt_dir, self.state)
        like = T.map_structure(lambda t: SimpleNamespace(shape=tuple(t.shape), dtype=t.dtype,
                                                         device="cpu"), self.state)
        restored = store.restore_latest_valid(self.tcfg.ckpt_dir, like)
        step = -1 if restored is None else int(restored[1])
        seen = torch.tensor([step, -step], device=self.device)
        dist.all_reduce(seen, op=dist.ReduceOp.MAX)
        if int(seen[0]) != -int(seen[1]):
            raise RuntimeError(f"ranks restored different checkpoints (this rank: step {step})")
        if restored is None:
            return None
        return distribute(self.mesh, restored[0], self.state_sh, device=self.device), step

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
