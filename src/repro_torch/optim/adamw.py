"""AdamW built from scratch, the reference's arithmetic in its order:

  * optimizer-state compression: m/v stored in bf16 when
    `state_dtype="bfloat16"`, updated in f32,
  * global-norm clipping computed in f32 whatever the state dtype,
  * cosine schedule with linear warmup.

The step is an int32 scalar tensor on the parameters' device, and the
schedule and the bias corrections `1 - b ** step` are computed from it in
f32 on that device, as the reference computes them from its int32 step
(not in Python floats, whose rounding differs).  `state_specs` gives the
state's logical-axis spec tree (the params', for m and v too: the state is
sharded as the params are).  `apply_updates(grad_norm=)` takes the clipping
norm from the caller, so that a rank updating only its shards of the
state clips by the whole gradient's norm, which the sharded step forms
from the shards' `sum_of_squares` (`runtime.trainer`), and
`apply_updates(inplace=True)` writes the update into the state's tensors
leaf by leaf, so that no second copy of the state exists.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import tree as T


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"   # "bfloat16" = optimizer-state compression


class TrainState(NamedTuple):
    step: torch.Tensor     # int32 scalar
    params: Any
    m: Any
    v: Any


def init_state(cfg: OptConfig, params) -> TrainState:
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32
    device = T.leaves(params)[0].device
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        params=params,
        m=T.map_structure(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params),
        v=T.map_structure(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params),
    )


def state_specs(param_specs) -> TrainState:
    """Logical-axis spec tree for a TrainState built over `param_specs`."""
    return TrainState(step=None, params=param_specs, m=param_specs, v=param_specs)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (an int32 tensor), f32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def sum_of_squares(leaves) -> torch.Tensor:
    """The sum over `leaves` of each leaf's f32 sum of squares, leaf by leaf
    in order."""
    return sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(sum_of_squares(T.leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: OptConfig, state: TrainState, grads,
                  grad_norm: Optional[torch.Tensor] = None, inplace: bool = False) -> TrainState:
    """One AdamW step: clip `grads` to `cfg.clip_norm` in global norm
    (`grad_norm` when given, else `global_norm(grads)`), update the moments
    in f32, step the masters.  Returns a new state; `state` is not
    modified, unless `inplace`: then each leaf's new params, m and v are
    copied into `state`'s tensors as soon as they are computed (the same
    values), and the returned state holds those tensors."""
    step = state.step + 1
    lr = schedule(cfg, step)
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)

    def upd(p, g, m, v):
        f32 = torch.float32
        g = g.to(f32) * scale
        m32 = b1 * m.to(f32) + (1 - b1) * g
        v32 = b2 * v.to(f32) + (1 - b2) * torch.square(g)
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        update = update + cfg.weight_decay * p.to(f32)
        newp = p.to(f32) - lr * update
        return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    leaves = zip(*(T.leaves(t) for t in (state.params, grads, state.m, state.v)))
    if inplace:
        for p, g, m, v in leaves:
            for old, new in zip((p, m, v), upd(p, g, m, v)):
                old.copy_(new)
        return state._replace(step=step)
    out = [upd(*leaf) for leaf in leaves]
    return TrainState(step=step,
                      params=T.unflatten(state.params, [o[0] for o in out]),
                      m=T.unflatten(state.m, [o[1] for o in out]),
                      v=T.unflatten(state.v, [o[2] for o in out]))
