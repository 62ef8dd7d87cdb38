"""Carries the reference package's parameters and training state over to
this port.

The boundary is numpy: the caller turns the reference's `init` pytree (or
its `TrainState`) into numpy arrays (`jax.tree.map(np.asarray, params)`)
and this module never sees the other framework.  Layouts are the
reference's and stay as they are (`wq (M,H,Dh)`, `wo (H,Dh,M)`, stage
leaves stacked on a leading layer axis).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import TrainState

Params = Dict[str, Any]

_BLOCK_LEAVES = {
    "attn": ("wq", "wk", "wv", "wo", "norm"),
    "cross": ("wq", "wk", "wv", "wo", "norm"),
    "mlp": ("wi", "wg", "wo", "norm"),
    "moe": ("router", "wi", "wg", "wo", "norm"),
    "mamba": ("in_proj", "conv", "A_log", "D", "dt_bias", "out_proj", "norm", "gate_norm"),
    "mlstm": ("wqkv", "wif", "wo", "norm"),
    "slstm": ("wx", "wr", "bias", "wo", "norm"),
}


def _leaf(a, device, dtype) -> torch.Tensor:
    a = np.array(a)                         # a copy: the source may be read-only
    if a.dtype.name == "bfloat16":          # the reference's bf16, which numpy knows by name
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _blocks(cfg: ModelConfig, kind: str, src: Params, repeat: int, where: str,
            device, dtype) -> Params:
    """`repeat` blocks of `kind` from the reference's layer-stacked tree."""
    block = {}
    for sub in M.block_groups(cfg, kind):
        block[sub] = {}
        for leaf in _BLOCK_LEAVES[sub]:
            t = _leaf(src[sub][leaf], device, dtype)
            if t.shape[0] != repeat:
                raise ValueError(f"{cfg.name}: {where}.{sub}.{leaf} has "
                                 f"{t.shape[0]} layers, expected {repeat}")
            block[sub][leaf] = t
    return block


def params_from_reference(cfg: ModelConfig, np_params: Params, device="cuda",
                          dtype: Optional[torch.dtype] = None) -> Params:
    """The port's parameter tree from the reference's, given as numpy arrays.

    Raises `ValueError` when the tree does not match the config."""
    device = require_device(device)
    layout = M.stages(cfg)
    if len(np_params["stages"]) != len(layout):
        raise ValueError(f"{cfg.name}: expected {len(layout)} stages, "
                         f"got {len(np_params['stages'])}")
    out: Params = {"embed": _leaf(np_params["embed"], device, dtype),
                   "final_norm": _leaf(np_params["final_norm"], device, dtype)}
    if tuple(out["embed"].shape) != (cfg.vocab, cfg.d_model):
        raise ValueError(f"{cfg.name}: embed has shape {tuple(out['embed'].shape)}")
    if not cfg.tie_embeddings:
        out["lm_head"] = _leaf(np_params["lm_head"], device, dtype)
    if M.has_shared_attn(cfg):
        out["shared_attn"] = {leaf: _leaf(np_params["shared_attn"][leaf], device, dtype)
                              for leaf in _BLOCK_LEAVES["attn"]}
    out["stages"] = []
    for (repeat, kinds), src in zip(layout, np_params["stages"]):
        out["stages"].append({f"{kind}_{j}": _blocks(cfg, kind, src[f"{kind}_{j}"], repeat,
                                                     f"{kind}_{j}", device, dtype)
                              for j, kind in enumerate(kinds)})
    if cfg.encoder_layers:
        # the reference stacks the encoder's blocks with no `enc_0` level
        # (its `encode` wraps them in one)
        enc = np_params["encoder"]
        out["encoder"] = {"blocks": _blocks(cfg, "enc", enc["blocks"], cfg.encoder_layers,
                                            "encoder.blocks", device, dtype),
                          "norm": _leaf(enc["norm"], device, dtype)}
    return out


def state_from_reference(cfg: ModelConfig, np_state, device="cuda") -> TrainState:
    """The port's `TrainState` from the reference's, given with numpy leaves
    (`jax.tree.map(np.asarray, state)`): the int32 step, the masters, and
    the moments m and v in their own dtype (f32, or bf16 under
    `state_dtype="bfloat16"`), so that both packages train from one point.

    Raises `ValueError` when a tree does not match the config."""
    device = require_device(device)
    step = torch.tensor(np.asarray(np_state.step), dtype=torch.int32, device=device)
    return TrainState(step=step,
                      params=params_from_reference(cfg, np_state.params, device),
                      m=params_from_reference(cfg, np_state.m, device),
                      v=params_from_reference(cfg, np_state.v, device))
