"""Building blocks of the dense / local-global architecture families.

Plain functions over explicit parameter dicts of tensors.  Each `init_*`
returns the parameters of one block; each `apply_*` takes `(cfg, params, x,
...)` and works in the compute dtype.  Parameter layouts are the reference's
(`wq (M,H,Dh)`, `wo (H,Dh,M)`, ...), so weights cross between the packages
without reshaping.

Every matmul routes through `linear()`, which optionally applies the
photonic-MAC numerics (2.5D-CrossLight broadcast-and-weight quantization):
the paper's compute engine as a first-class model feature.

Blocks of the other families (MoE, Mamba2, xLSTM, cross-attention) and the
M-RoPE position streams are not ported yet; see ROADMAP.md, Queue 1.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init / linear helpers
# ---------------------------------------------------------------------------


def _dense_init(gen: torch.Generator, shape, in_axes=(0,), *, device, layers: int = 0):
    """N(0, 1/fan_in) weights; with `layers`, that many independent draws
    stacked on a leading axis (drawn as one tensor, no per-layer copies)."""
    fan_in = max(1, math.prod(shape[a] for a in in_axes))
    full = ((layers,) if layers else ()) + tuple(shape)
    w = torch.randn(full, generator=gen, device=device, dtype=torch.float32)
    return w.div_(math.sqrt(fan_in))


def _zeros(shape, *, device, layers: int = 0):
    return torch.zeros(((layers,) if layers else ()) + tuple(shape), device=device)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def linear(cfg: ModelConfig, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, ...out) with optional photonic-MAC numerics."""
    k = w.shape[0]
    out_shape = w.shape[1:]
    if cfg.use_photonic_mac:
        x2 = x.reshape(-1, k)
        w2 = w.reshape(k, -1)
        y = ops.photonic_matmul(x2, w2, cfg.photonic_bits, cfg.use_kernels)
        return y.reshape(*x.shape[:-1], *out_shape).to(x.dtype)
    return torch.matmul(x, w.reshape(k, -1).to(x.dtype)).reshape(*x.shape[:-1], *out_shape)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.to(torch.float32))).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(cfg: ModelConfig, device) -> torch.Tensor:
    dh = cfg.head_dim_
    exponent = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    return 1.0 / (cfg.rope_theta ** exponent)


def apply_rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, Dh); positions (B, S) integer."""
    if positions.ndim != 2:
        raise NotImplementedError(
            "M-RoPE position streams (3, B, S) are not ported yet (ROADMAP.md, Queue 1: "
            "enc/dec + M-RoPE slice)")
    freqs = rope_freqs(cfg, x.device)  # (Dh/2,)
    angle = positions.to(torch.float32)[..., None] * freqs[None, None, :]
    cos = torch.cos(angle)[:, :, None, :]  # (B, S, 1, n)
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(cfg: ModelConfig, gen: torch.Generator, *, device, layers: int = 0) -> Params:
    """One attention block, or `layers` of them stacked on a leading axis."""
    m, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    kw = {"device": device, "layers": layers}
    return {
        "wq": _dense_init(gen, (m, h, dh), **kw),
        "wk": _dense_init(gen, (m, hk, dh), **kw),
        "wv": _dense_init(gen, (m, hk, dh), **kw),
        "wo": _dense_init(gen, (h, dh, m), in_axes=(0, 1), **kw),
        "norm": _zeros((m,), **kw),
    }


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor):
    b, s, m = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = linear(cfg, p["wq"].reshape(m, h * dh), x).reshape(b, s, h, dh)
    k = linear(cfg, p["wk"].reshape(m, hk * dh), x).reshape(b, s, hk, dh)
    v = linear(cfg, p["wv"].reshape(m, hk * dh), x).reshape(b, s, hk, dh)
    q = apply_rope(cfg, q, positions)
    k = apply_rope(cfg, k, positions)
    return q, k, v


def apply_attention(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    window: int = 0,
    causal: bool = True,
    cache: Optional[Params] = None,
    cache_pos: Optional[torch.Tensor] = None,
    cache_pos_max: int = 0,
):
    """Pre-norm attention block with residual.  Returns (x, cache).

    Train: `cache` is None -> full-sequence attention (flash kernel or plain
    version).  Prefill (S > 1): full-sequence attention, then the block's
    K/V are written into `cache` {'k','v'} (B,Hk,Sc,Dh).  Decode (S == 1):
    one-step attention over the cache; `cache_pos` is a scalar tensor
    (lockstep batch) or a (B,) tensor (continuous batching: each slot at its
    own position) and `cache_pos_max` its largest value, known on the host,
    which tells whether any slot's cache has to roll.

    The cache tensors are updated in place and returned: a serving cache is
    large, and the caller (`model._run_stages`) hands over views of its
    layer-stacked buffers.
    """
    b, s, m = x.shape
    h, dh = cfg.n_heads, cfg.head_dim_
    xn = rms_norm(x, p["norm"])
    q, k, v = _qkv(cfg, p, xn, positions)
    q = q.movedim(2, 1)  # (B,H,S,Dh), a strided view
    k = k.movedim(2, 1)
    v = v.movedim(2, 1)

    if cache is None:
        out = ops.attention(q, k, v, causal, window, None, 0, cfg.use_kernels)
    elif s > 1:
        # prefill: full-sequence attention, then materialize the cache
        out = ops.attention(q, k, v, causal, window, None, 0, cfg.use_kernels)
        wlen = cache["k"].shape[2]
        if s >= wlen:  # windowed (or exact-length) cache: keep the last wlen
            cache["k"].copy_(k[:, :, s - wlen:])
            cache["v"].copy_(v[:, :, s - wlen:])
        else:
            start = int(cache_pos)
            cache["k"][:, :, start:start + s].copy_(k)
            cache["v"][:, :, start:start + s].copy_(v)
    else:
        # single-step decode; windowed caches roll once full
        wlen = cache["k"].shape[2]
        pos_b = torch.broadcast_to(cache_pos, (b,))
        if cache_pos_max >= wlen:
            full = (pos_b >= wlen)[:, None, None, None]
            for name in ("k", "v"):
                c = cache[name]
                c.copy_(torch.where(full, torch.roll(c, -1, dims=2), c))
        slot = torch.clamp(pos_b, max=wlen - 1)
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, :, slot] = k[:, :, 0].to(cache["k"].dtype)
        cache["v"][rows, :, slot] = v[:, :, 0].to(cache["v"].dtype)
        pos_eff = torch.clamp(cache_pos, max=wlen - 1)      # scalar or (B,)
        out = decode_attention(q, cache["k"], cache["v"], pos_eff, window=0)

    out = out.to(x.dtype).movedim(1, 2).reshape(b, s, h * dh)
    y = linear(cfg, p["wo"].reshape(h * dh, m), out)
    return x + y, cache


def decode_attention(q, k, v, pos, *, window: int = 0):
    """One-step (or few-step) attention over a statically shaped KV cache.
    q (B,H,Sq,Dh); k,v (B,Hk,Sc,Dh); pos = absolute position of the last
    query: a scalar tensor, or a (B,) tensor for continuous batching.
    Plain tensor code, as in the reference."""
    b, h, sq, dh = q.shape
    hk, sc = k.shape[1], k.shape[2]
    group = h // hk
    qg = q.reshape(b, hk, group, sq, dh).to(torch.float32)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32)) * dh ** -0.5
    kpos = torch.arange(sc, device=q.device)
    pos = torch.as_tensor(pos, device=q.device)
    back = torch.arange(sq - 1, -1, -1, device=q.device)
    qpos = (pos[:, None] if pos.ndim else pos) - back    # (B,Sq) or (Sq,)
    valid = kpos <= qpos[..., None]                      # (Sq,Sc) or (B,Sq,Sc)
    if window > 0:
        valid = valid & (kpos > qpos[..., None] - window)
    mask = valid[:, None, None] if pos.ndim else valid[None, None, None]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    pm = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", pm, v.to(torch.float32))
    return out.reshape(b, h, sq, dh)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(cfg: ModelConfig, gen: torch.Generator, *, device, layers: int = 0) -> Params:
    m, f = cfg.d_model, cfg.d_ff
    kw = {"device": device, "layers": layers}
    return {
        "wi": _dense_init(gen, (m, f), **kw),
        "wg": _dense_init(gen, (m, f), **kw),
        "wo": _dense_init(gen, (f, m), **kw),
        "norm": _zeros((m,), **kw),
    }


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xn = rms_norm(x, p["norm"])
    g = torch.nn.functional.silu(linear(cfg, p["wg"], xn).to(torch.float32)).to(x.dtype)
    h = linear(cfg, p["wi"], xn) * g
    return x + linear(cfg, p["wo"], h)
