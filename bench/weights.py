"""The weights, drawn from the seed into the port's parameter tree.

The tree's structure (leaf names, shapes, dtypes: f32 masters, the MoE
experts in the compute dtype) is read from `model.init(..., device="meta")`
and its logical axes from `model.param_specs`; the values are the
benchmark's own: one `torch.randn` on the device per leaf, in the dtype the
leaf is served in, from one generator seeded with the seed.  A weight is
N(0, 1 / fan_in), its fan-in the axes it contracts over: `embed` where it
is not the last axis, else every axis but the layer, expert and last ones.
The embedding table is N(0, 1 / d_model), so that a token's vector has
unit RMS.  Norm scales are 0.1 N(0, 1) (the model multiplies by 1 + scale),
so that the check sees them.  The same tensors go to the program and to
the reference.
"""

from __future__ import annotations

import math

import torch

NORM_STD = 0.1


def _fan_in(shape, axes) -> int:
    named = [(n, a) for n, a in zip(shape, axes) if a not in ("layers", "experts")]
    if any(a == "embed" for _, a in named[:-1]):
        return dict((a, n) for n, a in named)["embed"]
    return math.prod(n for n, _ in named[:-1])


def _draw(gen, meta: torch.Tensor, axes, device) -> torch.Tensor:
    t = torch.randn(tuple(meta.shape), generator=gen, device=device, dtype=meta.dtype)
    if meta.ndim == 1 or axes[-1] is None and all(a in ("layers", None) for a in axes):
        return t.mul_(NORM_STD)
    if axes[0] == "vocab":                       # the embedding table
        return t.mul_(meta.shape[-1] ** -0.5)
    return t.mul_(_fan_in(meta.shape, axes) ** -0.5)


def _walk(meta, specs, fn):
    if isinstance(meta, dict):
        return {k: _walk(meta[k], specs[k], fn) for k in meta}
    if isinstance(meta, list):
        return [_walk(m, s, fn) for m, s in zip(meta, specs)]
    return fn(meta, specs)


def draw(cfg, seed: int, device, expert_dtype) -> dict:
    """The parameter tree of `cfg`, drawn from `seed` on `device`."""
    from repro_torch.models import model as M

    meta = M.init(cfg, device="meta", expert_dtype=expert_dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2 ** 63 - 1))
    with torch.no_grad():
        return _walk(meta, M.param_specs(cfg), lambda m, a: _draw(gen, m, a, device))
