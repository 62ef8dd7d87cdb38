"""Serving over a device mesh: the sharded prefill and decode step.

The counterpart of what the JAX package's dry-run builds for a serving
cell (`launch/dryrun.py`, `_lower_cell`: `jax.jit(M.prefill | M.serve_step,
in_shardings=...)` under `actx.activation_sharding`), which its
`launch/serve.py` calls the same `serve_step` the dry-run proves against
the production mesh.  The reference has no module of its own for them;
GSPMD places the compute from the shardings.  Here each rank runs the
one-device `model.prefill` / `model.serve_step` on its slices, under three
contexts:

  * `model.param_gather`: each weight made whole from the rank's shards
    where the forward uses it (the sharded train step's gather,
    `runtime.trainer._ShardGather`), keeping the `model` slice of the
    leaves the tensor-parallel split computes on (`trainer.tp_split_leaves`);
  * `actx.activation_sharding(mesh, batch_axes)`: the split's operators
    (`tp_copy`/`tp_sum`/`tp_max`) and the photonic dispatch on the global
    rows (`kernels.ops.Shard`);
  * `model.cache_layout`: the cache in the reference's layout
    (`sharding.cache_shardings`, then `enforce_divisibility`): the batch on
    (pod, data) when the global batch divides over them, the KV heads on
    `model` when `n_kv_heads % model == 0` (a rank's attention computes its
    own KV heads' slice and writes only those), and otherwise the cache
    LENGTH on the leftover axes (flash-decoding).

The length-split schedule (`layers._cached_attention`), one attention
block of one decode step:
  1. Q, K, V of the new token as on one device (Q: this rank's query heads
     under the split by heads; K, V: every KV head, from the whole `wk`,
     `wv`);
  2. a rolling (windowed) cache that is full shifts by one position across
     the blocks: each block's first position is all-gathered over the
     length's axes and the block takes its successor's;
  3. the new K and V are written at slot min(pos, window - 1) by the block
     that owns it (every replica of that block);
  4. when `model` splits the length, Q's heads are all-gathered over
     `model` (one token: every head must meet this rank's positions);
  5. each rank forms its positions' softmax partials, the max (one
     all-reduce MAX) and the sum of exponentials with the weighted V (one
     all-reduce SUM), over the length's axes;
  6. the rank keeps its own query heads of the result for the row-split
     `wo`, whose partial products are summed over `model`.
A prefill computes the attention on the rank's heads and writes the whole
K and V of the positions the rank holds.  Recurrent states (mamba's SSM and
conv states, mLSTM's C and n, sLSTM's h, c, n, m) follow the same rules;
where they leave a dimension other than the batch split (mamba's conv
window on `ffn`, hence `model`), the state is all-gathered on it, the
block computes whole, as it does in training, and the rank writes back its
slice.

Both builders return the step with its shardings, as
`runtime.trainer.build_sharded_step` does.  The step takes the GLOBAL
batch (tokens, and `enc_out` for an encoder-decoder config) on every rank
and runs on its shard; it returns this rank's batch rows of the logits,
whole along the vocabulary (gathered over `model` when the head splits
it), and the rank's cache shards.  Parameters are the rank's shards as
`trainer.distribute` or `trainer.sharded_init` lay them out (DTensors or
their local tensors).  Only the `tp_fsdp` strategy (every config's) is
served; another raises.  With `mesh=None` the builders return the
one-device functions; at world size 1 the steps are those, bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import require_device
from repro_torch import tree as T
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import actx
from repro_torch.parallel import sharding as S
from repro_torch.parallel.collectives import mesh_axis_sizes
from repro_torch.runtime import trainer as TR

__all__ = ["param_shardings", "serve_cache_shardings", "build_sharded_prefill",
           "build_sharded_serve_step"]


def _check_strategy(cfg: ModelConfig) -> None:
    if cfg.parallel_strategy != "tp_fsdp":
        raise ValueError(f"{cfg.name}: sharded serving runs the tp_fsdp strategy, not "
                         f"{cfg.parallel_strategy!r}")


def param_shardings(cfg: ModelConfig, mesh, param_specs=None):
    """`enforce_divisibility(tree_shardings(mesh, param_specs, rules))` on
    `init_abstract`'s shapes: the reference's serving layout of the
    parameters."""
    shapes, specs = M.init_abstract(cfg)
    specs = specs if param_specs is None else param_specs
    return S.enforce_divisibility(S.tree_shardings(mesh, specs, S.rules_for(cfg, mesh)),
                                  shapes)


def serve_cache_shardings(cfg: ModelConfig, mesh, cache):
    """The layout over `mesh` of the global cache `cache` (its shapes:
    `init_cache_abstract`'s will do): `cache_shardings` then
    `enforce_divisibility`."""
    gb = _cache_batch(cfg, cache)
    return S.enforce_divisibility(
        S.cache_shardings(cfg, mesh, M.cache_specs(cfg), gb, S.rules_for(cfg, mesh)), cache)


def _cache_batch(cfg: ModelConfig, cache) -> int:
    """The global batch of a (global-shaped) cache tree: its first leaf's
    batch dimension (mLSTM's fuses batch and heads)."""
    for (_, kinds), stage in zip(M.stages(cfg), cache):
        for j, kind in enumerate(kinds):
            leaf = next(iter(stage[f"{kind}_{j}"].values()))
            return leaf.shape[1] // (cfg.n_heads if kind == "mlstm" else 1)
    raise ValueError(f"{cfg.name}: an empty cache")


class _Rank:
    """What both steps share: the parameter gather and the contexts under
    which the one-device entry points run on this rank's slices."""

    def __init__(self, cfg: ModelConfig, mesh, param_specs, global_batch: int,
                 cache_sh):
        _check_strategy(cfg)
        self.cfg, self.mesh = cfg, mesh
        specs = M.param_specs(cfg) if param_specs is None else param_specs
        self.param_sh = param_shardings(cfg, mesh, specs)
        self.dp = S.batch_axes(mesh, global_batch)
        self.tp_local = TR.tp_split_leaves(cfg, mesh, self.dp, T.leaves(self.param_sh), specs)
        self.layout = M.CacheLayout(T.map_structure(lambda sh: sh.spec, cache_sh),
                                    global_batch, mesh_axis_sizes(mesh))

    def run(self, fn, params, share: float):
        """`fn(local params)` under the gather, the split and the cache
        layout; its logits made whole along the vocabulary."""
        leaves = [TR._to_local(p) for p in T.leaves(params)]
        gather = TR._ShardGather(self.mesh, self.dp, share, leaves, T.leaves(self.param_sh),
                                 self.tp_local)
        with torch.no_grad(), M.param_gather(gather), actx.activation_sharding(
                self.mesh, self.dp, "model", rows=1 / share), M.cache_layout(self.layout):
            logits, cache = fn(T.unflatten(params, leaves))
            if logits.shape[-1] < self.cfg.vocab:
                logits = actx.gather_tp(logits, -1)
        return logits, cache


def _local(mesh, sh, x):
    return S.local_shard(mesh, sh.spec, torch.as_tensor(x))


def build_sharded_prefill(cfg: ModelConfig, mesh, param_specs, batch_example,
                          cache_len: int, device="cuda"):
    """The prefill over `mesh` (a `DeviceMesh`): returns (prefill,
    param_shardings, batch_shardings, cache_shardings); `mesh=None`
    returns `model.prefill` on one device alone.  `prefill(params,
    batch)` takes the global batch (`batch_example`'s leaves and shapes)
    and returns (this rank's rows of the last logits (b, 1, V), this rank's
    cache shards for `cache_len` positions)."""
    device = require_device(device)
    if mesh is None:
        return lambda params, batch: M.prefill(cfg, params, batch, cache_len, device=device)
    gb = batch_example["tokens"].shape[0]
    cache_sh = serve_cache_shardings(cfg, mesh, M.init_cache_abstract(cfg, gb, cache_len)[0])
    batch_sh = S.train_batch_shardings(cfg, mesh, batch_example)
    rank = _Rank(cfg, mesh, param_specs, gb, cache_sh)

    def prefill(params, batch: Dict[str, Any]):
        local = {k: _local(mesh, batch_sh[k], v) for k, v in batch.items()}
        share = local["tokens"].shape[0] / batch["tokens"].shape[0]
        return rank.run(lambda p: M.prefill(cfg, p, local, cache_len, device=device),
                        params, share)

    return prefill, rank.param_sh, batch_sh, cache_sh


def build_sharded_serve_step(cfg: ModelConfig, mesh, param_specs, cache_example,
                             device="cuda"):
    """One decode step over `mesh`: returns (serve_step, param_shardings,
    cache_shardings, token_shardings); `mesh=None` returns `model.serve_step`
    on one device alone.  `cache_example` is the global cache (its shapes:
    `init_cache_abstract`'s will do).  `serve_step(params, cache, tokens,
    pos, enc_out=None)` takes this rank's cache shards (as the sharded
    prefill leaves them), the global tokens (B, 1), `pos` (a scalar, or a
    (B,) vector of which the rank takes its rows) and, for an
    encoder-decoder config, the global `enc_out` (B, Se, M); it returns
    (this rank's rows of the logits (b, 1, V), the cache, updated in place)."""
    device = require_device(device)
    if mesh is None:
        return lambda params, cache, tokens, pos, enc_out=None: M.serve_step(
            cfg, params, cache, tokens, pos, enc_out=enc_out, device=device)
    gb = _cache_batch(cfg, cache_example)
    cache_sh = serve_cache_shardings(cfg, mesh, cache_example)
    tok_sh = S.train_batch_shardings(cfg, mesh, {"t": torch.empty((gb, 1), device="meta")})["t"]
    rank = _Rank(cfg, mesh, param_specs, gb, cache_sh)

    def serve_step(params, cache, tokens, pos, enc_out: Optional[torch.Tensor] = None):
        tokens = torch.as_tensor(tokens)
        local = _local(mesh, tok_sh, tokens)
        share = local.shape[0] / tokens.shape[0]
        if np.ndim(pos) == 1:       # per-slot positions: this rank's rows
            pos = _local(mesh, tok_sh, torch.as_tensor(pos)[:, None])[:, 0]
        if enc_out is not None:
            enc_out = _local(mesh, tok_sh, enc_out)
        return rank.run(lambda p: M.serve_step(cfg, p, cache, local, pos, enc_out=enc_out,
                                               device=device), params, share)

    return serve_step, rank.param_sh, cache_sh, tok_sh
