"""Parameter wire formats: what dtype crosses the interposer.

The 2.5D-CrossLight interposer ships weights to the photonic MAC banks at
the MR amplitude resolution (8 bits).  In a sharded step the dominant
collective is the per-layer parameter all-gather; the JAX package's
`parallel/wire.py` puts the narrow payload on it, and this module is its
counterpart on one device, with the same numerics:

  * layer-stacked parameters (under `params["stages"]` and
    `params["encoder"]["blocks"]`, ndim >= 3) become `{~q: int8, ~s: scale}`
    pairs (one scale per layer), made once per step outside autograd and
    dequantized at the entry of each layer body (`dequant_subtree`, called
    by `models.model`);
  * gradients reach the f32 masters through a zero-valued delta `~d`
    grafted onto each pair inside the differentiated function:
    d(loss)/d(delta) is the straight-through master gradient;
  * every other float32 leaf of ndim >= 2 is quantized and dequantized in
    place (`_quant_leaf`, straight-through backward) under 8 bits, or cast
    to the compute dtype under 16.

Which leaves are transformed follows the reference exactly: >= 2-D float32
leaves.  A stacked 2-D leaf (a layer stack of norm scales, mamba's `A_log`,
`D`, `dt_bias`) is not a pair, since pairs take ndim >= 3, so under 8 bits
it goes through `_quant_leaf` with ONE scale for all its layers; 1-D leaves
stay f32.  Quantization scales are per leading index for ndim >= 3 (per
layer for a stack; per row of a non-stacked 3-D leaf, such as zamba2's
shared attention), per tensor otherwise.

The wire computes in bf16 (`WIRE_COMPUTE_DTYPE`), as the reference's
always does.

Over a mesh (`make_param_wire(cfg, mesh, rules, param_specs)`, which the
sharded train step builds from `cfg.wire_bits`), the same numbers cross
the sharded step's per-layer gather: `mesh_step` quantizes each rank's
shards once per step, outside autograd, with the reference's scales (one
per layer of a stack, one per leading index of another 3-D leaf, one per
tensor otherwise), each the MAX over the ranks of their shards' maxima
(one all-reduce for every leaf).  A sharded leaf then crosses the gather
as its int8 levels (pairs and `_quant_leaf`'s leaves) or in bf16 (16
bits), and is dequantized after it, at the body's entry; its gradient goes
straight through (for a pair, through the `~d` carrier's shard) to the f32
master's shard, reduce-scattered as without the wire
(`runtime.trainer`).  A leaf the mesh does not split takes the one-device
transforms above.  Under the tensor-parallel split a leaf's `model` slice
stays split in the gather, levels included.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.parallel import collectives as CC

__all__ = ["WIRE_Q", "WIRE_S", "WIRE_D", "WIRE_COMPUTE_DTYPE", "is_pair", "has_pair",
           "dequant_subtree", "ParamWire", "MeshStep", "make_param_wire"]

WIRE_Q, WIRE_S, WIRE_D = "~q", "~s", "~d"
WIRE_COMPUTE_DTYPE = torch.bfloat16


def is_pair(x) -> bool:
    return isinstance(x, dict) and WIRE_Q in x


def _absmax(wf: torch.Tensor) -> torch.Tensor:
    """max |w| per leading index for ndim >= 3, kept as a broadcastable
    (n, 1, ...) tensor, per tensor otherwise: `_quantize_array`'s ranges."""
    dims = tuple(range(1, wf.ndim)) if wf.ndim >= 3 else tuple(range(wf.ndim))
    return torch.amax(torch.abs(wf), dim=dims, keepdim=True)


def _levels(wf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.round(wf / scale).clamp_(-128, 127).to(torch.int8)


def _quantize_array(w: torch.Tensor, bits: int):
    """(int8 levels, f32 scale); one scale per leading index for ndim >= 3,
    kept as a broadcastable (n, 1, ...) tensor, one per tensor otherwise.
    Rounds half to even, as `jnp.round`; levels out of int8's range
    saturate, as XLA's conversion does."""
    qmax = 2.0 ** (bits - 1) - 1
    wf = w.to(torch.float32)
    scale = _absmax(wf).clamp_min(1e-8) / qmax
    return _levels(wf, scale), scale


def has_pair(tree) -> bool:
    """Whether any wire pair lies in `tree`."""
    if is_pair(tree):
        return True
    if isinstance(tree, dict):
        return any(has_pair(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(has_pair(v) for v in tree)
    return False


def _dequant(x, compute_dtype):
    if is_pair(x):
        wd = x[WIRE_Q].to(compute_dtype) * x[WIRE_S].to(compute_dtype)
        if WIRE_D in x:
            wd = wd + x[WIRE_D].to(compute_dtype)
        return wd
    if isinstance(x, dict):
        return {k: _dequant(v, compute_dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_dequant(v, compute_dtype) for v in x)
    return x


def dequant_subtree(subtree, compute_dtype):
    """Model-side hook (layer-body entry): wire pairs -> plain tensors,
    `~q` times `~s` in the compute dtype (the scale rounded to it first),
    plus `~d`.  A subtree without pairs comes back as it is: the same
    object, no copy."""
    if not has_pair(subtree):
        return subtree
    return _dequant(subtree, compute_dtype)


class _QuantLeaf(torch.autograd.Function):
    """Quantize -> dequantize to the compute dtype; the backward is
    straight through to the f32 master."""

    @staticmethod
    def forward(ctx, w, bits, compute_dtype):
        q, scale = _quantize_array(w, bits)
        return q.to(compute_dtype) * scale.to(compute_dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.float32), None, None


def _quant_leaf(w: torch.Tensor, bits: int, compute_dtype) -> torch.Tensor:
    return _QuantLeaf.apply(w, bits, compute_dtype)


def _eligible(w) -> bool:
    return isinstance(w, torch.Tensor) and w.ndim >= 2 and w.dtype == torch.float32


def _map_with_path(fn: Callable, tree: Any, *rest: Any, path: tuple = ()) -> Any:
    """`fn(path, leaf, *rest_leaves)` over `tree`'s leaves (a pair dict is
    one leaf); `path` holds the dict keys and list indices down to it."""
    if isinstance(tree, dict) and not is_pair(tree):
        return {k: _map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, *(r[i] for r in rest), path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


class ParamWire:
    """Wire transform for one config, on one device or over a mesh.  Usage
    (trainer, one device):

        pw = make_param_wire(cfg)
        qtree = pw.quantize(state.params)            # outside autograd
        v = leaves of pw.carrier(state.params), requiring grad
        loss = loss_fn(cfg, pw.graft(qtree, v), batch)
        grads = torch.autograd.grad(loss, v)         # the master tree's

    Over a mesh the sharded step calls `mesh_step` once per step."""

    # parameter subtrees stacked on a leading layer axis
    SCANNED_PREFIXES = (("stages",), ("encoder", "blocks"))

    def __init__(self, cfg, mesh=None):
        self.bits = int(getattr(cfg, "wire_bits", 0) or 0)
        self.mesh = mesh
        self.pair_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def _is_scanned(self, path) -> bool:
        return any(tuple(path[:len(p)]) == p for p in self.SCANNED_PREFIXES)

    def _is_pair_leaf(self, path, w) -> bool:
        return self._is_scanned(path) and _eligible(w) and w.ndim >= 3

    def _int8_pairs(self) -> bool:
        return 0 < self.bits < 16

    def quantize(self, params):
        """Pairs for the layer-stacked eligible leaves of ndim >= 3; every
        other leaf passes through (transformed differentiably in `graft`).
        Call outside autograd."""
        if not self._int8_pairs():
            return params

        def leaf(path, w):
            if self._is_pair_leaf(path, w):
                with torch.no_grad():
                    q, scale = _quantize_array(w, self.bits)
                return {WIRE_Q: q, WIRE_S: scale}
            return w

        return _map_with_path(leaf, params)

    def carrier(self, params):
        """The differentiation variable: zeros at pair positions (the `~d`
        delta), the master tensors everywhere else."""
        if not self._int8_pairs():
            return params

        def leaf(path, w):
            if self._is_pair_leaf(path, w):
                return torch.zeros(w.shape, dtype=torch.float32, device=w.device)
            return w

        return _map_with_path(leaf, params)

    def graft(self, qtree, vtree):
        """Merge the carrier into the quantized tree and apply the
        differentiable transforms of the other leaves.  Call inside the
        differentiated function."""
        def leaf(path, q_leaf, v_leaf):
            if is_pair(q_leaf):
                return {**q_leaf, WIRE_D: v_leaf}
            w = v_leaf
            if not _eligible(w):
                return w
            if self._int8_pairs():
                return _quant_leaf(w, self.bits, WIRE_COMPUTE_DTYPE)
            if self.bits == 16:
                return w.to(WIRE_COMPUTE_DTYPE)
            return w

        return _map_with_path(leaf, qtree, vtree)


    def kind(self, path, w) -> str:
        """What crosses the wire for the leaf at `path`: "pair" (int8
        levels, a scale per layer), "quant" (`_quant_leaf`'s int8), "cast"
        (bf16), or "" (the leaf as it is)."""
        if not _eligible(w):
            return ""
        if self._int8_pairs():
            return "pair" if self._is_pair_leaf(path, w) else "quant"
        return "cast" if self.bits == 16 else ""

    def mesh_step(self, params, shardings, tp_local) -> "MeshStep":
        """One step's wire over the mesh, from `params` (this rank's f32
        shards, plain tensors, in the master tree's structure) laid out as
        `shardings` (its tree of `NamedSharding`s).  Call outside
        autograd, once per step (module docstring)."""
        return MeshStep(self, params, shardings, tp_local)


class MeshStep:
    """One step of the wire over a mesh, leaf by leaf in `T.leaves` order:

      * `leaves`: the differentiation variable (requiring grad): the `~d`
        carrier (zeros, the shard's shape) for a pair, the master shard
        otherwise;
      * `tree()`: the loss's tree, built anew for each microbatch: a
        sharded leaf as its entry of `leaves` (the step's gather applies
        the wire to it, `wired`), another one as the one-device `graft`
        gives it;
      * `wired`: {id of a sharded leaf's entry of `leaves`: (kind, levels
        (a pair's, quantized here), the scales of the rank's shard and of
        the tensor its gather makes (`_global_scales`; None in bf16), the
        dtype it is dequantized in)}.

    `tp_local` says, leaf by leaf, whether the gather keeps the leaf's
    `model` slice (the tensor-parallel split)."""

    def __init__(self, pw: ParamWire, params, shardings, tp_local):
        self.bits, self._like = pw.bits, params
        kinds = T.leaves(_map_with_path(pw.kind, params))
        masters = T.leaves(params)
        sharded = [any(a is not None for a in sh.spec) for sh in T.leaves(shardings)]
        specs = [sh.spec for sh in T.leaves(shardings)]
        quantized = [j for j, k in enumerate(kinds) if sharded[j] and k in ("pair", "quant")]
        scale_of = dict(zip(quantized, _global_scales(
            pw.mesh, [masters[j] for j in quantized], [specs[j] for j in quantized],
            [{"model"} if tp_local[j] else set() for j in quantized], pw.bits)))
        self.leaves, self.wired, self._plain = [], {}, []
        with torch.no_grad():
            for j, (kind, w) in enumerate(zip(kinds, masters)):
                v = (torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                     if kind == "pair" else w.detach())
                self.leaves.append(v.requires_grad_(True))
                if sharded[j] and kind:
                    mine, whole = scale_of.get(j, (None, None))
                    levels = _levels(w.to(torch.float32), mine) if kind == "pair" else None
                    # a pair dequantizes in the model's compute dtype (at the
                    # body's entry, `dequant_subtree`), the others in bf16
                    dtype = pw.pair_dtype if kind == "pair" else WIRE_COMPUTE_DTYPE
                    self.wired[id(v)] = (kind, levels, mine, whole, dtype)
                    self._plain.append(("", None))
                elif kind == "pair":
                    q, sc = _quantize_array(w, self.bits)
                    self._plain.append((kind, {WIRE_Q: q, WIRE_S: sc}))
                else:
                    self._plain.append((kind, None))

    def tree(self):
        out = []
        for (kind, pair), v in zip(self._plain, self.leaves):
            if kind == "pair":
                out.append({**pair, WIRE_D: v})
            elif kind == "quant":
                out.append(_quant_leaf(v, self.bits, WIRE_COMPUTE_DTYPE))
            elif kind == "cast":
                out.append(v.to(WIRE_COMPUTE_DTYPE))
            else:
                out.append(v)
        return T.unflatten(self._like, out)


@torch.no_grad()
def _global_scales(mesh, shards, specs, kept, bits: int) -> list:
    """Each shard's scales (`_quantize_array`'s, of the whole leaf), per
    leading index or per tensor, each range the MAX over the mesh's ranks of
    their shards' (one all-reduce for every leaf): (this rank's block, the
    block of the tensor its gather makes, which keeps the mesh axes in
    `kept`, the tensor-parallel split's, local)."""
    if not shards:
        return []
    qmax = 2.0 ** (bits - 1) - 1
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    pieces, blocks = [], []
    for w, spec in zip(shards, specs):
        local = _absmax(w.to(torch.float32)).reshape(-1)
        lead = spec[0] if len(spec) and w.ndim >= 3 else None
        lead = () if lead is None else (lead,) if isinstance(lead, str) else tuple(lead)
        # this rank's block in the leaf's whole leading grid (zeros elsewhere)
        idx, n = 0, 1
        for a in lead:
            idx, n = idx * sizes[a] + coord[a], n * sizes[a]
        grid = torch.zeros(local.numel() * n, dtype=torch.float32, device=w.device)
        grid[idx * local.numel():(idx + 1) * local.numel()] = local
        pieces.append(grid)
        blocks.append((idx, local.numel(), lead))
    flat = torch.cat(pieces)
    if mesh.size() > 1:
        dist.all_reduce(flat, op=dist.ReduceOp.MAX,
                        group=CC._axis_group(mesh, mesh.mesh_dim_names))
    out, at = [], 0
    for w, piece, (idx, count, lead), keep in zip(shards, pieces, blocks, kept):
        scale = flat[at:at + piece.numel()].clamp_min(1e-8) / qmax
        at += piece.numel()
        tail = (1,) * (w.ndim - 1) if w.ndim >= 3 else None
        mine = scale[idx * count:(idx + 1) * count]
        whole = mine if lead and set(lead) <= keep else scale
        out.append(tuple(t.reshape((1,) * w.ndim if tail is None else (t.numel(),) + tail)
                         for t in (mine, whole)))
    return out


def make_param_wire(cfg, mesh=None, rules=None, param_specs=None) -> ParamWire:
    """The reference's factory: the wire of `cfg.wire_bits`, on one device,
    or over `mesh` (a `DeviceMesh`), whose shards the sharding `rules` lay
    out from the logical `param_specs` (all three, or none; the sharded
    step hands `mesh_step` the shardings they give)."""
    if mesh is not None and (rules is None or param_specs is None):
        raise ValueError("the wire over a mesh needs the sharding rules and the param specs "
                         "its shards are laid out by")
    return ParamWire(cfg, mesh)
