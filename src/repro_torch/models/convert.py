"""Carries the reference package's parameters over to this port.

The boundary is numpy: the caller turns the reference's `init` pytree into
numpy arrays (`jax.tree.map(np.asarray, params)`) and this module never sees
the other framework.  Layouts are the reference's and stay as they are
(`wq (M,H,Dh)`, `wo (H,Dh,M)`, stage leaves stacked on a leading layer axis).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

_BLOCK_LEAVES = {
    "attn": ("wq", "wk", "wv", "wo", "norm"),
    "mlp": ("wi", "wg", "wo", "norm"),
    "moe": ("router", "wi", "wg", "wo", "norm"),
    "mamba": ("in_proj", "conv", "A_log", "D", "dt_bias", "out_proj", "norm", "gate_norm"),
    "mlstm": ("wqkv", "wif", "wo", "norm"),
    "slstm": ("wx", "wr", "bias", "wo", "norm"),
}


def _subs(cfg: ModelConfig, kind: str):
    """The parameter groups a block of `kind` holds (shared_attn holds none:
    its parameters live once, at the top of the tree)."""
    if kind in ("attn", "local", "global"):
        return ("attn", "mlp") if cfg.d_ff else ("attn",)
    if kind == "moe":
        return ("attn", "moe")
    if kind == "shared_attn":
        return ()
    return (kind,)


def _leaf(a, device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))       # a copy: the source may be read-only
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_reference(cfg: ModelConfig, np_params: Params, device="cuda",
                          dtype: Optional[torch.dtype] = None) -> Params:
    """The port's parameter tree from the reference's, given as numpy arrays.

    Raises `NotImplementedError` for a config with block kinds that are not
    ported, and `ValueError` when the tree does not match the config."""
    device = require_device(device)
    M.require_ported(cfg)
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
        sp = {}
        for j, kind in enumerate(kinds):
            name = f"{kind}_{j}"
            block = {}
            for sub in _subs(cfg, kind):
                block[sub] = {}
                for leaf in _BLOCK_LEAVES[sub]:
                    t = _leaf(src[name][sub][leaf], device, dtype)
                    if t.shape[0] != repeat:
                        raise ValueError(f"{cfg.name}: {name}.{sub}.{leaf} has "
                                         f"{t.shape[0]} layers, expected {repeat}")
                    block[sub][leaf] = t
            sp[name] = block
        out["stages"].append(sp)
    return out
