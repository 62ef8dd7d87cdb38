"""Fault-tolerant training runtime on one device.

Builds the train step, wires the data pipeline, checkpoints step-atomically
and resumes bitwise-identically, injects failures, and accounts stragglers
by the deadline policy.

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

Not ported yet: the sharded step over a mesh (`build_sharded_step`,
`param_wire`); a mesh raises `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

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


def make_train_step(cfg: ModelConfig, opt: adamw.OptConfig, accum_steps: int = 1,
                    device="cuda"):
    """`step(state, batch) -> (new_state, metrics)`, metrics {ce, aux, loss,
    grad_norm} as f32 scalar tensors; `batch` holds tensors on `device`.

    `accum_steps` > 1 runs gradient accumulation: the batch is split into
    microbatches run in turn, gradients summed in f32 and averaged, ONE
    optimizer update."""
    device = require_device(device)

    def grads_of(leaves, params, mb):
        with L._span("loss"):
            loss, metrics = M.loss_fn(cfg, params, mb, device=device)
        with L._span("backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    def step_fn(state: adamw.TrainState, batch: Dict[str, torch.Tensor]):
        params = T.map_structure(lambda p: p.detach().requires_grad_(True), state.params)
        leaves = T.leaves(params)
        if accum_steps == 1:
            loss, metrics, grads = grads_of(leaves, params, batch)
        else:
            mbs = _split_microbatches(batch, accum_steps)
            g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            l_sum = torch.zeros((), dtype=torch.float32, device=device)
            mets = []
            for i in range(accum_steps):
                l, m, g = grads_of(leaves, params, {k: v[i] for k, v in mbs.items()})
                g_sum = [a + b for a, b in zip(g_sum, g)]
                l_sum = l_sum + l
                mets.append(m)
            grads = [g / accum_steps for g in g_sum]
            loss = l_sum / accum_steps
            metrics = {k: torch.mean(torch.stack([m[k] for m in mets])) for k in mets[0]}
        with L._span("optimizer"):
            grad_tree = T.unflatten(state.params, grads)
            new_state = adamw.apply_updates(opt, state, grad_tree)
            metrics = dict(metrics, loss=loss, grad_norm=adamw.global_norm(grad_tree))
        return new_state, metrics
    return step_fn


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
    with any non-f32 master raises `ValueError`."""

    def __init__(self, cfg: ModelConfig, opt: adamw.OptConfig, data: DataConfig,
                 tcfg: TrainerConfig, mesh=None, resume: bool = True, source=None,
                 fabric=None, device="cuda", state: Optional[adamw.TrainState] = None):
        if mesh is not None:
            raise NotImplementedError("the sharded train step over a mesh is not ported "
                                      "(ROADMAP.md, Queue 1 items 11 and 12)")
        self.cfg, self.opt, self.data_cfg, self.tcfg = cfg, opt, data, tcfg
        self.device = require_device(device)
        self.source = source if source is not None else SyntheticLM(cfg, data)
        if state is None:
            params = M.init(cfg, seed=tcfg.seed, device=self.device, expert_dtype=torch.float32)
            state = adamw.init_state(opt, params)
        check_masters(state.params)
        self.state = state
        self._step = make_train_step(cfg, opt, device=self.device)

        self.start_step = 0
        self.restore_s = None
        if resume:
            # corrupt/truncated latest checkpoints (bad SHA1, missing
            # manifest) are dropped and the previous retained step restored
            t0 = time.perf_counter()
            restored = store.restore_latest_valid(tcfg.ckpt_dir, self.state)
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
            if not self.monitor.admit(delivery):
                continue  # straggler drop: skip this host's contribution

            t_step = time.perf_counter()
            self.state, metrics = self._step(self.state, _to_device(batch, self.device))
            row = {k: float(v) for k, v in metrics.items()}
            row["step_s"] = time.perf_counter() - t_step
            if (step + 1) % self.tcfg.ckpt_every == 0 or step + 1 == steps:
                t_ck = time.perf_counter()
                store.save(self.tcfg.ckpt_dir, step + 1, self.state, keep=self.tcfg.keep)
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
