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
always does.  It is the one-device wire: `make_param_wire`'s `mesh`,
`rules` and `param_specs` describe the sharded wire (its pairs laid out by
the sharding rules, `parallel.sharding`), which is not ported, so a mesh
raises `NotImplementedError`, and so does `cfg.wire_bits` in the sharded
train step (`runtime.trainer.build_sharded_step`).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["WIRE_Q", "WIRE_S", "WIRE_D", "WIRE_COMPUTE_DTYPE", "is_pair", "has_pair",
           "dequant_subtree", "ParamWire", "make_param_wire"]

WIRE_Q, WIRE_S, WIRE_D = "~q", "~s", "~d"
WIRE_COMPUTE_DTYPE = torch.bfloat16


def is_pair(x) -> bool:
    return isinstance(x, dict) and WIRE_Q in x


def _quantize_array(w: torch.Tensor, bits: int):
    """(int8 levels, f32 scale); one scale per leading index for ndim >= 3,
    kept as a broadcastable (n, 1, ...) tensor, one per tensor otherwise.
    Rounds half to even, as `jnp.round`; levels out of int8's range
    saturate, as XLA's conversion does."""
    qmax = 2.0 ** (bits - 1) - 1
    wf = w.to(torch.float32)
    dims = tuple(range(1, wf.ndim)) if wf.ndim >= 3 else tuple(range(wf.ndim))
    scale = torch.amax(torch.abs(wf), dim=dims, keepdim=True).clamp_min(1e-8) / qmax
    q = torch.round(wf / scale).clamp_(-128, 127).to(torch.int8)
    return q, scale


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
    """Wire transform for one config on one device.  Usage (trainer):

        pw = make_param_wire(cfg)
        qtree = pw.quantize(state.params)            # outside autograd
        v = leaves of pw.carrier(state.params), requiring grad
        loss = loss_fn(cfg, pw.graft(qtree, v), batch)
        grads = torch.autograd.grad(loss, v)         # the master tree's
    """

    # parameter subtrees stacked on a leading layer axis
    SCANNED_PREFIXES = (("stages",), ("encoder", "blocks"))

    def __init__(self, cfg):
        self.bits = int(getattr(cfg, "wire_bits", 0) or 0)

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


def make_param_wire(cfg, mesh=None, rules=None, param_specs=None) -> ParamWire:
    """The reference's factory: the wire of `cfg.wire_bits` on one device.
    The sharded wire (`mesh`, `rules`, `param_specs`) raises."""
    if mesh is not None or rules is not None or param_specs is not None:
        raise NotImplementedError("the sharded parameter wire over a mesh is not ported "
                                  "(ROADMAP.md, Queue 1 item 8)")
    return ParamWire(cfg)
