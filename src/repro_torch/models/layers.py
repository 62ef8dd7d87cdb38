"""Building blocks of the dense, local-global, MoE, hybrid (Mamba2 + shared
attention), xLSTM, vision-language (M-RoPE) and encoder-decoder
architecture families.

Plain functions over explicit parameter dicts of tensors.  Each `init_*`
returns the parameters of one block; each `apply_*` takes `(cfg, params, x,
...)` and works in the compute dtype.  Parameter layouts are the reference's
(`wq (M,H,Dh)`, `wo (H,Dh,M)`, ...), so weights cross between the packages
without reshaping.

Every matmul routes through `linear()`, which optionally applies the
photonic-MAC numerics (2.5D-CrossLight broadcast-and-weight quantization):
the paper's compute engine as a first-class model feature.

The recurrent blocks (`apply_mamba`, `apply_mlstm`, `apply_slstm`) take a
cache of views into the model's layer-stacked buffers and write their new
state into it in place (`copy_`), as `apply_attention` does with K/V.

Under a sharded train step's tensor-parallel split (`parallel.actx`) a
block receives this rank's slice of the weights it splits, and reads the
split from their shapes: attention its heads (`wq` by columns, `wk`/`wv`
by KV heads or whole, `wo` by rows), the MLP its `ffn` columns, MoE its
experts (or each expert's `ffn` columns).  A replicated activation enters
the split through `actx.tp_copy`, and the partial results leave it
through `actx.tp_sum`, inside `linear(split="rows")` or after the combine.
Under `seq_tp` attention runs on this rank's slice of the sequence.  The
recurrent blocks take whole weights and compute as on one device.  Under
a sharded serving step an attention block's K/V cache may hold a slice of
the cache's length, or every KV head while the rank computes its own
query heads (`_cached_attention`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import actx

Params = Dict[str, Any]
# `keep(name, leaf)`: what an init stores of a leaf it has just drawn
Keep = Optional[Callable[[str, torch.Tensor], torch.Tensor]]


# ---------------------------------------------------------------------------
# init / linear helpers
# ---------------------------------------------------------------------------


def _dense_init(gen: torch.Generator, shape, in_axes=(0,), *, device, layers: int = 0,
                dtype: torch.dtype = torch.float32):
    """N(0, 1/fan_in) weights in `dtype`; with `layers`, that many
    independent draws stacked on a leading axis, each drawn in f32 and cast
    into a preallocated stack, so that no f32 copy of a whole stack in
    another dtype ever exists."""
    fan_in = max(1, math.prod(shape[a] for a in in_axes))
    if not layers:
        w = torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
        return w.div_(math.sqrt(fan_in)).to(dtype)
    out = torch.empty((layers,) + tuple(shape), device=device, dtype=dtype)
    for i in range(layers):
        out[i].copy_(_dense_init(gen, shape, in_axes, device=device))
    return out


def _draw(keep: Keep, leaves: Sequence[Tuple[str, Callable[[], torch.Tensor]]]) -> Params:
    """{name: draw()} in the order given, each leaf handed to `keep` (when
    given) as soon as it is drawn, before the next is: a sharded init keeps
    a rank's shard of it and frees the rest (`model.init(keep=)`)."""
    return {name: draw() if keep is None else keep(name, draw()) for name, draw in leaves}


def _zeros(shape, *, device, layers: int = 0):
    return torch.zeros(((layers,) if layers else ()) + tuple(shape), device=device)


def _full(shape, value: float, *, device, layers: int = 0):
    return torch.full(((layers,) if layers else ()) + tuple(shape), value, device=device)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _shard(m: int, split: Optional[str]) -> Optional[ops.Shard]:
    """Where this rank's product of `m` rows sits in a sharded step's
    global one (`ops.Shard`); None outside a sharded step."""
    if not actx.active():
        return None
    if actx.tp_size() == 1:
        return ops.Shard(m=actx.global_rows(m))
    return ops.Shard(m=actx.global_rows(m), split=split, index=actx.tp_rank(),
                     parts=actx.tp_size(), reduce_max=actx.tp_max)


def linear(cfg: ModelConfig, w: torch.Tensor, x: torch.Tensor,
           split: Optional[str] = None) -> torch.Tensor:
    """x (..., K) @ w (K, ...out) with optional photonic-MAC numerics.
    `split` names the slice of a split weight this rank holds: "cols" (its
    output columns), or "rows" (its input rows, x holding the matching
    features), whose partial products are summed over the split here."""
    k = w.shape[0]
    out_shape = w.shape[1:]
    if cfg.use_photonic_mac:
        x2 = x.reshape(-1, k)
        w2 = w.reshape(k, -1)
        y = ops.photonic_matmul(x2, w2, cfg.photonic_bits, cfg.use_kernels,
                                _shard(x2.shape[0], split))
        if split == "rows":
            y = actx.tp_sum(y)
        return y.reshape(*x.shape[:-1], *out_shape).to(x.dtype)
    y = torch.matmul(x, w.reshape(k, -1).to(x.dtype)).reshape(*x.shape[:-1], *out_shape)
    return actx.tp_sum(y) if split == "rows" else y


# the sharded train step's mean over its batch ranks (`runtime.trainer`): a
# differentiable function of this rank's mean, each rank's weighted by its
# tokens; None (one device) leaves a rank's mean as it is
_BATCH_MEAN: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


@contextlib.contextmanager
def batch_mean(fn: Optional[Callable[[torch.Tensor], torch.Tensor]]):
    """Within the context, the MoE load-balance statistics are averaged by
    `fn` over the ranks a sharded step splits the batch on (`apply_moe`)."""
    global _BATCH_MEAN
    prev, _BATCH_MEAN = _BATCH_MEAN, fn
    try:
        yield
    finally:
        _BATCH_MEAN = prev


def _span(name: str):
    """A named range in a `torch.profiler` trace (`chip_smoke.py --profile`
    reads the device time under each); nothing at all when no profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.to(torch.float32))).to(dt)


# ---------------------------------------------------------------------------
# RoPE (+ M-RoPE)
# ---------------------------------------------------------------------------


def rope_freqs(cfg: ModelConfig, device) -> torch.Tensor:
    dh = cfg.head_dim_
    exponent = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    return 1.0 / (cfg.rope_theta ** exponent)


def mrope_sections(n: int) -> list:
    """The stream (0 = t, 1 = h, 2 = w) of each of the `n` rotary pairs under
    M-RoPE: three contiguous sections, h and w n // 3 pairs each and t the
    rest (22/21/21 at Dh = 128), as the reference splits them."""
    s0, s1 = n - 2 * (n // 3), n // 3
    return [0] * s0 + [1] * s1 + [2] * (n - s0 - s1)


def apply_rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, Dh); positions (B, S) integer, or (3, B, S) for M-RoPE
    (temporal/height/width streams, `cfg.mrope`; each rotary pair takes the
    angle of its section's stream, so equal streams give the standard RoPE).
    Three streams for a config without M-RoPE raise `ValueError`."""
    freqs = rope_freqs(cfg, x.device)  # (Dh/2,)
    if positions.ndim == 3:
        if not cfg.mrope:
            raise ValueError(f"{cfg.name}: (3, B, S) M-RoPE positions given to a config "
                             "without mrope")
        _, b, s = positions.shape
        sect = torch.tensor(mrope_sections(freqs.shape[0]), device=x.device)
        pos = torch.gather(positions.to(torch.float32).movedim(0, -1), -1,
                           sect.expand(b, s, -1))                      # (B, S, n)
        angle = pos * freqs[None, None, :]
    else:
        angle = positions.to(torch.float32)[..., None] * freqs[None, None, :]
    cos = torch.cos(angle)[:, :, None, :]  # (B, S, 1, n)
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(cfg: ModelConfig, gen: torch.Generator, *, device, layers: int = 0,
                   keep: Keep = None) -> Params:
    """One attention block, or `layers` of them stacked on a leading axis;
    each leaf through `keep` as it is drawn (`_draw`), as in every init."""
    m, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    kw = {"device": device, "layers": layers}
    return _draw(keep, [
        ("wq", lambda: _dense_init(gen, (m, h, dh), **kw)),
        ("wk", lambda: _dense_init(gen, (m, hk, dh), **kw)),
        ("wv", lambda: _dense_init(gen, (m, hk, dh), **kw)),
        ("wo", lambda: _dense_init(gen, (h, dh, m), in_axes=(0, 1), **kw)),
        ("norm", lambda: _zeros((m,), **kw)),
    ])


def _local_kv(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor, hq: int, dim: int = 2):
    """K and V, whole along their KV-head dimension `dim` ((B, S, Hk, Dh)
    by default), cut to the KV heads of this rank's `hq` query heads under
    a split by heads: a contiguous range of whole groups, or one KV head
    per query head where the rank's heads straddle a group's edge (the
    same numbers either way)."""
    group = cfg.n_heads // cfg.n_kv_heads
    first = actx.tp_rank() * hq
    idx = [(first + j) // group for j in range(hq)]
    lo, n = idx[0], idx[-1] - idx[0] + 1
    if hq % n == 0 and idx == [lo + j // (hq // n) for j in range(hq)]:
        return k.narrow(dim, lo, n), v.narrow(dim, lo, n)
    index = torch.tensor(idx, device=k.device)
    return k.index_select(dim, index), v.index_select(dim, index)


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor,
         whole_kv: bool = False):
    """Q, K, V (B, S, H, Dh) with RoPE.  Under a split by heads (this rank
    holds `wq`'s slice), Q is this rank's heads and K, V its groups':
    column slices of `wk`, `wv` where the KV heads split too, else the
    whole K and V, their gradient summed over the split (`tp_copy`), cut
    to the rank's groups unless `whole_kv`."""
    b, s, m = x.shape
    dh = cfg.head_dim_
    h, hk = p["wq"].shape[-2], p["wk"].shape[-2]
    split = "cols" if h < cfg.n_heads else None
    xq = actx.tp_copy(x) if split else x
    q = linear(cfg, p["wq"].reshape(m, h * dh), xq, split).reshape(b, s, h, dh)
    kv_split = split if hk < cfg.n_kv_heads else None
    xkv = xq if kv_split else x
    k = linear(cfg, p["wk"].reshape(m, hk * dh), xkv, kv_split).reshape(b, s, hk, dh)
    v = linear(cfg, p["wv"].reshape(m, hk * dh), xkv, kv_split).reshape(b, s, hk, dh)
    if split and not kv_split and not whole_kv:
        k, v = _local_kv(cfg, actx.tp_copy(k), actx.tp_copy(v), h)
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
    cache_spec: Optional[Tuple] = None,
):
    """Pre-norm attention block with residual.  Returns (x, cache).

    Train: `cache` is None -> full-sequence attention (flash kernel or plain
    version).  With a cache, `_cached_attention`: prefill (S > 1) or
    one-step decode (S == 1); `cache_pos` is a scalar tensor (lockstep
    batch) or a (B,) tensor (continuous batching: each slot at its own
    position) and `cache_pos_max` its largest value, known on the host,
    which tells whether any slot's cache has to roll.

    The cache tensors are updated in place and returned: a serving cache is
    large, and the caller (`model._run_stages`) hands over views of its
    layer-stacked buffers.

    `cache_spec` (B, Hk, length, Dh): the mesh axes a sharded serving
    step splits this rank's cache on; none of size > 1 on the length, or
    no spec, is the one-device cache.
    """
    if cache is not None:
        return _cached_attention(cfg, p, x, positions, window=window, causal=causal,
                                 cache=cache, cache_pos=cache_pos, cache_pos_max=cache_pos_max,
                                 axes=_length_axes(cache_spec))
    if actx.seq_split():
        return _seq_attention(cfg, p, x, positions, window=window, causal=causal)
    b, s, m = x.shape
    dh = cfg.head_dim_
    h = p["wq"].shape[-2]                    # this rank's heads under a split
    xn = rms_norm(x, p["norm"])
    q, k, v = _qkv(cfg, p, xn, positions)
    with _span("attention"):
        out = ops.attention(q.movedim(2, 1), k.movedim(2, 1), v.movedim(2, 1), causal, window,
                            None, 0, cfg.use_kernels)
    out = out.to(x.dtype).movedim(1, 2).reshape(b, s, h * dh)
    y = linear(cfg, p["wo"].reshape(h * dh, m), out, "rows" if h < cfg.n_heads else None)
    return x + y, None


def _length_axes(cache_spec: Optional[Tuple]) -> Tuple[str, ...]:
    """The mesh axes of size > 1 a sharded serving step splits a K/V
    cache's length on (none without a spec)."""
    if not cache_spec or len(cache_spec) < 3:
        return ()
    axes = actx.axes_of(cache_spec[2])
    return axes if actx.axes_size(axes) > 1 else ()


def _cached_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      positions: torch.Tensor, *, window: int, causal: bool,
                      cache: Params, cache_pos, cache_pos_max: int, axes: Tuple[str, ...]):
    """`apply_attention` with a K/V cache {'k','v'} (B,Hk,L,Dh), this rank's
    global positions [lo, lo + L) of a cache of length `wlen`.  On one
    device, and wherever `axes` is empty, the rank holds the whole length
    (lo = 0).  A sharded serving step may split the length over `axes`
    (flash-decoding; `parallel.sharding.cache_shardings` puts it there when
    the batch or the KV heads do not take the axes), and may hold every KV
    head while the rank computes its query heads (`_qkv(whole_kv=True)`).

    Prefill: full-sequence attention (this rank's query heads), then the
    K and V of the rank's positions written (a windowed or exact-length
    cache keeps the last `wlen`).  Decode: a full rolling window rolls by
    one (across the blocks: each block's first position all-gathered over
    `axes`, the counterpart of GSPMD's collective permute); the new token's
    K and V are written by the block that owns its slot; Q's heads are made
    whole over `model` when `model` splits the length (one token's worth:
    every head meets this rank's positions), and `decode_attention`'s
    softmax over the rank's positions is combined over `axes`; the rank's
    heads of the result then enter the row-split `wo`."""
    b, s, m = x.shape
    dh = cfg.head_dim_
    h = p["wq"].shape[-2]
    xn = rms_norm(x, p["norm"])
    q, k, v = _qkv(cfg, p, xn, positions, whole_kv=True)
    q, k, v = q.movedim(2, 1), k.movedim(2, 1), v.movedim(2, 1)
    n_loc = cache["k"].shape[2]
    wlen = n_loc * actx.axes_size(axes)
    lo = actx.axes_index(axes) * n_loc
    if k.shape[1] != cache["k"].shape[1]:
        raise ValueError(f"{cfg.name}: this rank computes {k.shape[1]} KV heads and holds "
                         f"{cache['k'].shape[1]} in its cache")
    head_split = h < cfg.n_heads
    # the rank's query heads meet their groups' KV heads alone
    cut_kv = head_split and k.shape[1] == cfg.n_kv_heads
    with _span("attention"):   # the product and the cache, not the projections
        if s > 1:
            kq, vq = _local_kv(cfg, k, v, h, dim=1) if cut_kv else (k, v)
            out = ops.attention(q, kq, vq, causal, window, None, 0, cfg.use_kernels)
            start = s - wlen if s >= wlen else -int(cache_pos)     # cache slot 0's position
            a, z = max(lo, -start), min(lo + n_loc, s - start)     # the rows this rank holds
            if a < z:
                cache["k"][:, :, a - lo:z - lo].copy_(k[:, :, start + a:start + z])
                cache["v"][:, :, a - lo:z - lo].copy_(v[:, :, start + a:start + z])
        else:
            pos_b = torch.broadcast_to(cache_pos, (b,))
            if cache_pos_max >= wlen:
                full = (pos_b >= wlen)[:, None, None, None]
                nxt = (actx.axes_index(axes) + 1) % actx.axes_size(axes)
                for name in ("k", "v"):
                    c = cache[name]
                    first = actx.axes_gather(c[:, :, :1], axes, 2)[:, :, nxt:nxt + 1]
                    c.copy_(torch.where(full, torch.cat([c[:, :, 1:], first], dim=2), c))
            slot = torch.clamp(pos_b, max=wlen - 1)
            rows = torch.arange(b, device=x.device)
            for name, new in (("k", k), ("v", v)):
                c = cache[name]
                new = new[:, :, 0].to(c.dtype)
                if axes:   # the block that owns the slot writes it
                    local = slot - lo
                    mine = ((local >= 0) & (local < n_loc))[:, None, None]
                    local = torch.clamp(local, 0, n_loc - 1)
                    c[rows, :, local] = torch.where(mine, new, c[rows, :, local])
                else:
                    c[rows, :, slot] = new
            pos_eff = torch.clamp(cache_pos, max=wlen - 1)
            q_all = actx.gather_tp(q, 1) if head_split and "model" in axes else q
            kc, vc = cache["k"], cache["v"]
            if cut_kv and "model" not in axes:
                kc, vc = _local_kv(cfg, kc, vc, h, dim=1)
            out = decode_attention(q_all, kc, vc, pos_eff, lo=lo, axes=axes)
            if q_all is not q:
                out = out.narrow(1, actx.tp_rank() * h, h)
    out = out.to(x.dtype).movedim(1, 2).reshape(b, s, h * dh)
    y = linear(cfg, p["wo"].reshape(h * dh, m), out, "rows" if head_split else None)
    return x + y, cache


def _seq_attention(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor, *,
                   window: int, causal: bool):
    """`seq_tp`'s training attention (the reference's `actx.constrain_seq`
    at the block's entry): whole weights on every rank, Q from this rank's
    slice of the sequence, K and V from every slice (gathered, their
    gradient reduce-scattered back), the kernel at `q_offset` = the slice's
    start, the residual on the slice, and the slices gathered back at the
    block's exit (the reference's `constrain_unseq`, where the MLP begins;
    the numbers are the same, and every consumer of the block finds the
    whole sequence).  The weights' gradients, each rank's from its slice,
    are summed over the split (`tp_copy`)."""
    s_all = x.shape[1]
    x = actx.constrain_seq(x)
    positions = actx.seq_slice(positions, dim=-1)
    p = {name: actx.tp_copy(w) for name, w in p.items()}
    b, s, m = x.shape
    h, dh = cfg.n_heads, cfg.head_dim_
    with actx.seq_rows():
        xn = rms_norm(x, p["norm"])
        q, k, v = _qkv(cfg, p, xn, positions)
        k, v = actx.gather_seq(k), actx.gather_seq(v)
        with _span("attention"):
            out = ops.attention(q.movedim(2, 1), k.movedim(2, 1), v.movedim(2, 1), causal,
                                window, None, actx.tp_rank() * s, cfg.use_kernels, s_all)
        out = out.to(x.dtype).movedim(1, 2).reshape(b, s, h * dh)
        y = linear(cfg, p["wo"].reshape(h * dh, m), out)
    return actx.constrain_unseq(x + y), None


def decode_attention(q, k, v, pos, *, window: int = 0, lo: int = 0,
                     axes: Tuple[str, ...] = ()):
    """One-step (or few-step) attention over a statically shaped KV cache.
    q (B,H,Sq,Dh); k,v (B,Hk,Sc,Dh); pos = absolute position of the last
    query: a scalar tensor, or a (B,) tensor for continuous batching.
    Plain tensor code, as in the reference.  With `axes`, this rank holds
    the cache's positions [lo, lo + Sc) of a length split over `axes`: the
    softmax's max, sum of exponentials and weighted V of those positions
    are combined over the ranks of `axes` (one all-reduce of the max, one
    of the sums)."""
    b, h, sq, dh = q.shape
    hk, sc = k.shape[1], k.shape[2]
    group = h // hk
    qg = q.reshape(b, hk, group, sq, dh).to(torch.float32)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32)) * dh ** -0.5
    kpos = torch.arange(lo, lo + sc, device=q.device)
    pos = torch.as_tensor(pos, device=q.device)
    back = torch.arange(sq - 1, -1, -1, device=q.device)
    qpos = (pos[:, None] if pos.ndim else pos) - back    # (B,Sq) or (Sq,)
    valid = kpos <= qpos[..., None]                      # (Sq,Sc) or (B,Sq,Sc)
    if window > 0:
        valid = valid & (kpos > qpos[..., None] - window)
    mask = valid[:, None, None] if pos.ndim else valid[None, None, None]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    if not axes:
        pm = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgqs,bksd->bkgqd", pm, v.to(torch.float32))
        return out.reshape(b, h, sq, dh)
    top = torch.amax(s, dim=-1, keepdim=True)
    actx.axes_max(top, axes)
    e = torch.exp(s - top)
    num = torch.einsum("bkgqs,bksd->bkgqd", e, v.to(torch.float32))
    parts = actx.axes_sum(torch.cat([num, e.sum(dim=-1, keepdim=True)], dim=-1), axes)
    return (parts[..., :dh] / parts[..., dh:]).reshape(b, h, sq, dh)


def init_cross_attention(cfg: ModelConfig, gen: torch.Generator, *, device,
                         layers: int = 0, keep: Keep = None) -> Params:
    """The decoder's cross-attention: the leaves of an attention block."""
    return init_attention(cfg, gen, device=device, layers=layers, keep=keep)


def apply_cross_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                          enc_out: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention with residual: queries from rms_norm(x), keys
    and values from `enc_out` (B, Se, M) with no norm and no RoPE, attention
    with no mask.  K and V are projected from `enc_out` on every call,
    decode steps included: the reference keeps no cross-attention cache."""
    b, s, m = x.shape
    se = enc_out.shape[1]
    dh = cfg.head_dim_
    h, hk = p["wq"].shape[-2], p["wk"].shape[-2]     # this rank's, under a split
    split = "cols" if h < cfg.n_heads else None
    kv_split = split if hk < cfg.n_kv_heads else None
    xn = rms_norm(x, p["norm"])
    xq = actx.tp_copy(xn) if split else xn
    enc = actx.tp_copy(enc_out) if kv_split else enc_out
    q = linear(cfg, p["wq"].reshape(m, h * dh), xq, split).reshape(b, s, h, dh)
    k = linear(cfg, p["wk"].reshape(m, hk * dh), enc, kv_split).reshape(b, se, hk, dh)
    v = linear(cfg, p["wv"].reshape(m, hk * dh), enc, kv_split).reshape(b, se, hk, dh)
    if split and not kv_split:
        k, v = _local_kv(cfg, actx.tp_copy(k), actx.tp_copy(v), h)
    with _span("cross_attention"):
        out = ops.attention(q.movedim(2, 1), k.movedim(2, 1), v.movedim(2, 1),
                            False, 0, None, 0, cfg.use_kernels)
    out = out.to(x.dtype).movedim(1, 2).reshape(b, s, h * dh)
    return x + linear(cfg, p["wo"].reshape(h * dh, m), out, split and "rows")


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(cfg: ModelConfig, gen: torch.Generator, *, device, layers: int = 0,
             keep: Keep = None) -> Params:
    m, f = cfg.d_model, cfg.d_ff
    kw = {"device": device, "layers": layers}
    return _draw(keep, [
        ("wi", lambda: _dense_init(gen, (m, f), **kw)),
        ("wg", lambda: _dense_init(gen, (m, f), **kw)),
        ("wo", lambda: _dense_init(gen, (f, m), **kw)),
        ("norm", lambda: _zeros((m,), **kw)),
    ])


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU with residual; under a split by `ffn` (this rank's columns of
    `wi`, `wg` and rows of `wo`) the partial products are summed."""
    # under seq_tp the attention block has gathered the sequence back
    # already (`_seq_attention`): the reference's `constrain_unseq` here
    xn = rms_norm(x, p["norm"])
    split = p["wi"].shape[-1] < cfg.d_ff
    if split:
        xn = actx.tp_copy(xn)
    cols = "cols" if split else None
    g = torch.nn.functional.silu(linear(cfg, p["wg"], xn, cols).to(torch.float32)).to(x.dtype)
    h = linear(cfg, p["wi"], xn, cols) * g
    return x + linear(cfg, p["wo"], h, "rows" if split else None)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def init_moe(cfg: ModelConfig, gen: torch.Generator, *, device, layers: int = 0,
             expert_dtype: Optional[torch.dtype] = None, keep: Keep = None) -> Params:
    """Router (M,E) and the experts' SwiGLU stacks wi/wg (E,M,F), wo (E,F,M).

    By default the expert stacks are stored in the compute dtype: both
    dispatches cast them to it on every use, as the reference casts its f32
    masters, so the forward numbers are those of f32 masters (mixtral's
    experts are 90 GB in bf16 and 180 GB in f32).  An optimizer needs f32
    masters: the trainer passes `expert_dtype=torch.float32`."""
    m, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    kw = {"device": device, "layers": layers}
    dt = expert_dtype or compute_dtype(cfg)
    return _draw(keep, [
        ("router", lambda: _dense_init(gen, (m, e), **kw)),
        ("wi", lambda: _dense_init(gen, (e, m, f), in_axes=(1,), dtype=dt, **kw)),
        ("wg", lambda: _dense_init(gen, (e, m, f), in_axes=(1,), dtype=dt, **kw)),
        ("wo", lambda: _dense_init(gen, (e, f, m), in_axes=(1,), dtype=dt, **kw)),
        ("norm", lambda: _zeros((m,), **kw)),
    ])


def _experts(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its capacity buffer xe (E,B,C,M), in xe's
    dtype, with the stacks cast to it as the reference casts its masters.
    Plain products: the reference runs them outside any Pallas kernel."""
    dt = xe.dtype
    with _span("moe.experts"):
        # in place only when no backward needs the product's input
        g = torch.nn.functional.silu(
            torch.einsum("ebcm,emf->ebcf", xe, p["wg"].to(dt)).to(torch.float32),
            inplace=not torch.is_grad_enabled()).to(dt)
        h = torch.einsum("ebcm,emf->ebcf", xe, p["wi"].to(dt)) * g
        return torch.einsum("ebcf,efm->ebcm", h, p["wo"].to(dt))


def top_k(probs: torch.Tensor, k: int):
    """The k largest entries of the last axis and their indices, largest
    first, and among equal values the lower index first, as `jax.lax.top_k`
    orders them (`torch.topk` promises no order among ties, and bf16 router
    logits tie often).  A stable descending sort, cut to k."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_index_path(cfg: ModelConfig, p: Params, xn, idx, gate_vals, keep, pos_ce,
                    cap: int, e_lo: int = 0) -> torch.Tensor:
    """Gather/scatter dispatch with the einsum path's capacity rule: each
    kept (token, choice) is copied into its expert's buffer slot, the
    experts run, and each result is read back and weighted by its gate in
    the compute dtype.  Dropped choices scatter into a dump slot per expert
    (slot `cap`), which is then discarded.  `p` may hold the experts
    `e_lo` .. of a split: only their buffers are filled, and the choices
    of other experts give zeros here (another rank's part of the sum)."""
    b, s, m = xn.shape
    e, k = cfg.n_experts, cfg.top_k
    el = p["wi"].shape[0]
    dt = xn.dtype
    rows = torch.arange(b, device=xn.device)[:, None]
    with _span("moe.dispatch"):
        t_e = idx.transpose(1, 2).reshape(b, k * s)                  # expert per choice
        keep_t = keep.sum(dim=-1) > 0                                 # (B,kS)
        s_t = torch.arange(s, device=xn.device).repeat(k).expand(b, k * s)
        flat_slot = t_e * (cap + 1) + torch.where(keep_t, pos_ce, cap)

        def scat(vals):
            out = torch.zeros((b, e * (cap + 1)), dtype=vals.dtype, device=xn.device)
            out = out.scatter_(1, flat_slot, vals).reshape(b, e, cap + 1)[:, e_lo:e_lo + el]
            return out[..., :cap]

        slot_token = scat(s_t).reshape(b, el * cap)
        slot_valid = scat(keep_t).reshape(b, el * cap, 1)
        xe = torch.where(slot_valid, xn[rows, slot_token], 0)
        xe = xe.reshape(b, el, cap, m).to(dt).movedim(0, 1)          # (E,B,C,M)
    ye = _experts(p, xe)
    with _span("moe.combine"):
        ye_b = ye.movedim(0, 1).reshape(b, el * cap, m)               # (B,E*C,M)
        if el < e:
            mine = keep_t & (t_e >= e_lo) & (t_e < e_lo + el)
            t_e = torch.clamp(t_e - e_lo, 0, el - 1)
        else:
            mine = keep_t
        yt = ye_b[rows, t_e * cap + torch.clamp_max(pos_ce, cap - 1)]
        yt = torch.where(mine[..., None], yt, 0)
        gate_t = gate_vals.transpose(1, 2).reshape(b, k * s)         # choices-major
        return (yt * gate_t[..., None].to(yt.dtype)).reshape(b, k, s, m).sum(dim=1)


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """Top-k routed MoE with capacity, pre-norm, with residual.  Returns
    (x + y, aux): aux is the Switch load-balance loss plus 1e-3 of the
    router z-loss.

    Routing, as in the reference: the router through `linear`, an f32
    softmax, the top k probabilities (`top_k`: among equal probabilities
    the lower expert index first), normalised over the k.  A (token, choice)
    takes the next slot of its expert's buffer of `cap` slots in
    choices-major order: every token's first choice before any second
    choice; past `cap` it is dropped.  `cfg.moe_dispatch` picks the one-hot
    dispatch/combine einsums ("einsum", the default) or `_moe_index_path`;
    each rounds as its reference function does (the einsum path sums the
    gates over k in f32 and casts once, the index path weights and sums in
    the compute dtype).  Each sequence routes on its own (the capacity is per
    sequence), so a sharded step's rank routes its batch shard as the
    reference's batch-manual dispatch does; only the load-balance
    statistics couple the ranks (`batch_mean`).

    Under a split by experts (this rank's `wi`, `wg`, `wo` stacks hold
    experts e_lo ..) or by each expert's `ffn` columns, the routing is
    computed whole on every rank, the rank dispatches to and runs its part
    of the experts, and the partial combines are summed over the split; the
    normed input and the gates enter the split through `tp_copy`."""
    b, s, m = x.shape
    e, k = cfg.n_experts, cfg.top_k
    f32 = torch.float32
    cap = max(1, int(cfg.capacity_factor * s * k / e))
    el = p["wi"].shape[0]
    e_lo = actx.tp_rank() * el if el < e else 0
    split = el < e or p["wi"].shape[-1] < cfg.d_ff

    xn = rms_norm(x, p["norm"])
    with _span("moe.route"):
        logits = linear(cfg, p["router"], xn).to(f32)                 # (B,S,E)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, idx = top_k(probs, k)                              # (B,S,k)
        gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)
        # position of each (token, choice) within its expert's capacity buffer
        onehot = torch.nn.functional.one_hot(idx, e).to(f32)         # (B,S,k,E)
        flat = onehot.transpose(1, 2).reshape(b, k * s, e)            # choices-major
        pos_in_expert = torch.cumsum(flat, dim=1) - flat              # (B,kS,E)
        keep = (pos_in_expert < cap) * flat
        pos_ce = torch.einsum("bte,bte->bt", pos_in_expert, keep)     # (B,kS)
        # load-balance aux loss (Switch) + router z-loss; under a sharded
        # step `me` and `ce` are the global batch's (`batch_mean`), and the
        # z-loss, a mean, is weighted as the step weights the loss
        me = probs.mean(dim=(0, 1))                                   # (E,)
        ce = onehot.sum(dim=2).mean(dim=(0, 1))                       # fraction routed
        if _BATCH_MEAN is not None:
            me, ce = _BATCH_MEAN(me), _BATCH_MEAN(ce)
        aux = e * torch.sum(me * ce) + 1e-3 * torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    if split:
        xn, gate_vals = actx.tp_copy(xn), actx.tp_copy(gate_vals)
    if cfg.moe_dispatch == "index":
        y = _moe_index_path(cfg, p, xn, idx, gate_vals, keep, pos_ce.long(), cap, e_lo)
    else:
        with _span("moe.dispatch"):
            slot = (pos_ce[..., None] == torch.arange(cap, device=x.device)).to(f32)
            disp_flat = keep[..., None] * slot[:, :, None, :]                      # (B,kS,E,C)
            dispatch = disp_flat.reshape(b, k, s, e, cap).transpose(1, 2)         # (B,S,k,E,C)
            if el < e:
                dispatch = dispatch[:, :, :, e_lo:e_lo + el]
            combine = (dispatch * gate_vals[..., None, None]).sum(dim=2)         # (B,S,E,C)
            dispatch = dispatch.sum(dim=2)
            xe = torch.einsum("bsec,bsm->ebcm", dispatch.to(x.dtype), xn)
        ye = _experts(p, xe)
        with _span("moe.combine"):
            y = torch.einsum("bsec,ebcm->bsm", combine.to(x.dtype), ye)
    return x + (actx.tp_sum(y) if split else y), aux


# ---------------------------------------------------------------------------
# Mamba2 block (zamba2 hybrid)
# ---------------------------------------------------------------------------


def init_mamba(cfg: ModelConfig, gen: torch.Generator, *, device, layers: int = 0,
               keep: Keep = None) -> Params:
    m, din, n, hm = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    kw = {"device": device, "layers": layers}
    proj_out = 2 * din + 2 * n + hm  # [z, x, B, C, dt]
    return _draw(keep, [
        ("in_proj", lambda: _dense_init(gen, (m, proj_out), **kw)),
        ("conv", lambda: _dense_init(gen, (cfg.conv_width, din), **kw).mul_(0.1)),
        ("A_log", lambda: _full((hm,), math.log(0.5), **kw)),
        ("D", lambda: _full((hm,), 1.0, **kw)),
        ("dt_bias", lambda: _zeros((hm,), **kw)),
        ("out_proj", lambda: _dense_init(gen, (din, m), **kw)),
        ("norm", lambda: _zeros((m,), **kw)),
        ("gate_norm", lambda: _zeros((din,), **kw)),
    ])


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x (B,L,C), w (W,C), state (B,W-1,C) or None.
    Returns (y, new_state).  The reference's explicit shifted sum, term by
    term in x's dtype: a cuDNN convolution would run f32 in TF32."""
    b, l, c = x.shape
    wlen = w.shape[0]
    if state is None:
        state = torch.zeros((b, wlen - 1, c), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)  # (B, L+W-1, C)
    y = xp[:, 0:l] * w[0]
    for i in range(1, wlen):
        y = y + xp[:, i:i + l] * w[i]
    new_state = xp[:, l:] if wlen > 1 else state
    return y, new_state


def apply_mamba(cfg: ModelConfig, p: Params, x: torch.Tensor,
                cache: Optional[Params] = None):
    """Mamba2-style selective SSM block (scalar per-head decay, matrix state),
    with residual and no MLP (zamba2's blocks apply none, whatever d_ff says).
    Returns (x, cache).

    No cache: the chunked scan over the sequence.  Prefill (S > 1): the same,
    then the final state and the conv window are written into `cache`
    {'state' (B,Hm,P,N) f32, 'conv' (B,W-1,din)}.  Decode (S == 1): one step of
    the recurrence on the cached state."""
    b, l, m = x.shape
    din, n, hm, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    f32 = torch.float32
    xn = rms_norm(x, p["norm"])
    proj = linear(cfg, p["in_proj"], xn)
    z, xs, bmat, cmat, dt = torch.split(proj, [din, din, n, n, hm], dim=-1)

    conv_state = cache["conv"] if cache is not None else None
    xs, new_conv = _causal_conv(xs, p["conv"].to(xs.dtype), conv_state)
    xs = torch.nn.functional.silu(xs.to(f32)).to(x.dtype)

    dt = torch.nn.functional.softplus(dt.to(f32) + p["dt_bias"])       # (B,L,Hm)
    a = torch.exp(-torch.exp(p["A_log"])[None, None, :] * dt)         # (B,L,Hm)
    xh = xs.reshape(b, l, hm, pdim)

    if cache is None or l > 1:
        # (B,L,Hm,P) -> (B*Hm, L, P); decay (B*Hm, L); b and c (B,L,N) are
        # shared by the Hm heads of each batch row, which the scan takes as
        # they are (the reference repeats them per head)
        sdt = compute_dtype(cfg)
        xf = xh.movedim(2, 1).reshape(b * hm, l, pdim).to(sdt)
        af = a.movedim(2, 1).reshape(b * hm, l)
        bf = bmat.to(sdt)
        cf = cmat.to(sdt)
        y = ops.ssm(xf, af, bf, cf, cfg.use_kernels)
        y = y.reshape(b, hm, l, pdim).movedim(1, 2)                   # (B,L,Hm,P)
        if cache is not None:  # prefill: also the final state
            cum = torch.cumsum(torch.log(torch.clamp_min(a, 1e-37)), dim=1)
            w = torch.exp(cum[:, -1:, :] - cum)                        # prod_{r>s} a_r
            s_fin = torch.einsum("blhp,bln->bhpn", xh.to(f32) * w[..., None], bmat.to(f32))
            cache["state"].copy_(s_fin)
            cache["conv"].copy_(new_conv)
    else:
        s_prev = cache["state"]                                        # (B,Hm,P,N)
        upd = xh[:, 0].to(f32)[..., None] * bmat[:, 0].to(f32)[:, None, None, :]
        s_new = a[:, 0, :, None, None] * s_prev + upd
        y = torch.einsum("bhpn,bn->bhp", s_new, cmat[:, 0].to(f32))[:, None]
        cache["state"].copy_(s_new)
        cache["conv"].copy_(new_conv)

    y = y + p["D"][None, None, :, None] * xh.to(f32)
    y = y.reshape(b, l, din).to(x.dtype)
    y = rms_norm(y * torch.nn.functional.silu(z.to(f32)).to(x.dtype), p["gate_norm"])
    return x + linear(cfg, p["out_proj"], y), cache


# ---------------------------------------------------------------------------
# xLSTM blocks
# ---------------------------------------------------------------------------


def init_mlstm(cfg: ModelConfig, gen: torch.Generator, *, device, layers: int = 0,
               keep: Keep = None) -> Params:
    m, dh, h = cfg.d_model, cfg.head_dim_, cfg.n_heads
    din = h * dh
    kw = {"device": device, "layers": layers}
    return _draw(keep, [
        ("wqkv", lambda: _dense_init(gen, (m, 3 * din), **kw)),
        ("wif", lambda: _dense_init(gen, (m, 2 * h), **kw).mul_(0.1)),
        ("wo", lambda: _dense_init(gen, (din, m), **kw)),
        ("norm", lambda: _zeros((m,), **kw)),
    ])


def apply_mlstm(cfg: ModelConfig, p: Params, x: torch.Tensor,
                cache: Optional[Params] = None):
    """mLSTM, matrix-memory LSTM: C_t = f_t C + i_t v k^T, h = C q / max(|n.q|, 1).
    The numerator and the normaliser n are two selective scans (the state C,
    and a one-row state for n).  Returns (x, cache); the cache is
    {'C' (B*H,D,D), 'n' (B*H,1,D)} f32, written in place at prefill and decode."""
    b, l, m = x.shape
    h, dh = cfg.n_heads, cfg.head_dim_
    din = h * dh
    f32 = torch.float32
    xn = rms_norm(x, p["norm"])
    qkv = linear(cfg, p["wqkv"], xn)
    q, k, v = torch.split(qkv, din, dim=-1)
    gates = linear(cfg, p["wif"], xn).to(f32)
    ig, fg = torch.split(gates, h, dim=-1)                             # (B,L,H)
    i = torch.sigmoid(ig)
    f = torch.sigmoid(fg + 3.0)  # bias toward remembering

    qh = q.reshape(b, l, h, dh) * dh ** -0.5
    kh = k.reshape(b, l, h, dh) * dh ** -0.5
    vh = v.reshape(b, l, h, dh)

    def flat(t):  # (B,L,H,D) -> (B*H, L, D) in the compute dtype
        return t.movedim(2, 1).reshape(b * h, l, -1).to(compute_dtype(cfg))

    xf = flat(vh * i[..., None].to(vh.dtype))
    af = f.movedim(2, 1).reshape(b * h, l)
    bf, cf = flat(kh), flat(qh)
    iflat = i.movedim(2, 1).reshape(b * h, l)                          # f32

    if cache is None or l > 1:
        y = ops.ssm(xf, af, bf, cf, cfg.use_kernels)                   # (BH,L,D)
        nsum = ops.ssm(iflat[..., None], af, bf, cf, cfg.use_kernels)  # (BH,L,1)
        if cache is not None:  # prefill: the final (C, n) state
            cum = torch.cumsum(torch.log(torch.clamp_min(af, 1e-37)), dim=1)
            w = torch.exp(cum[:, -1:] - cum)                           # (BH,L)
            # the reference's mixed bf16/f32 products promote to f32
            cache["C"].copy_(torch.einsum("zlp,zln->zpn", xf.to(f32) * w[..., None],
                                          bf.to(f32)))
            cache["n"].copy_(torch.einsum("zl,zln->zn", w * iflat, bf.to(f32))[:, None])
    else:
        a1 = af[:, 0, None, None]
        # x_t b_t^T in the compute dtype (one product per entry, rounded to
        # it as in the reference), added to the f32 state
        c_new = a1 * cache["C"] + xf[:, 0, :, None] * bf[:, 0, None, :]
        n_new = a1 * cache["n"] + (iflat[:, 0, None] * bf[:, 0].to(f32))[:, None]
        y = torch.einsum("zpn,zn->zp", c_new, cf[:, 0].to(f32))[:, None]
        nsum = torch.einsum("zqn,zn->zq", n_new, cf[:, 0].to(f32))[:, None]
        cache["C"].copy_(c_new)
        cache["n"].copy_(n_new)

    hout = y / torch.clamp_min(torch.abs(nsum), 1.0)
    hout = hout.reshape(b, h, l, dh).movedim(1, 2).reshape(b, l, din)
    return x + linear(cfg, p["wo"], hout.to(x.dtype)), cache


def init_slstm(cfg: ModelConfig, gen: torch.Generator, *, device, layers: int = 0,
               keep: Keep = None) -> Params:
    m = cfg.d_model
    kw = {"device": device, "layers": layers}
    return _draw(keep, [
        ("wx", lambda: _dense_init(gen, (m, 4 * m), **kw)),
        ("wr", lambda: _dense_init(gen, (m, 4 * m), **kw).mul_(0.5)),
        ("bias", lambda: _zeros((4 * m,), **kw)),
        ("wo", lambda: _dense_init(gen, (m, m), **kw)),
        ("norm", lambda: _zeros((m,), **kw)),
    ])


def apply_slstm(cfg: ModelConfig, p: Params, x: torch.Tensor,
                cache: Optional[Params] = None):
    """sLSTM with stabilised exponential gating: a sequential loop over the
    sequence in f32 (the inherently recurrent xLSTM component; plain tensor
    code, as in the reference).  Returns (x, cache); the cache {'h','c','n','m'}
    (B,M) f32 is written in place."""
    b, l, m = x.shape
    f32 = torch.float32
    xn = rms_norm(x, p["norm"])
    xproj = (linear(cfg, p["wx"], xn) + p["bias"].to(xn.dtype)).to(f32)

    if cache is None:
        h0 = torch.zeros((b, m), dtype=f32, device=x.device)
        hprev, cprev, nprev, mprev = h0, h0, h0, h0 - 10.0
    else:
        hprev, cprev, nprev, mprev = cache["h"], cache["c"], cache["n"], cache["m"]

    wr = p["wr"].to(f32)
    hs = []
    for t in range(l):
        pre = xproj[:, t] + hprev @ wr
        zt, it, ft, ot = torch.split(pre, m, dim=-1)
        z = torch.tanh(zt)
        o = torch.sigmoid(ot)
        mnew = torch.maximum(ft + mprev, it)
        ig = torch.exp(it - mnew)
        fg = torch.exp(ft + mprev - mnew)
        cprev = fg * cprev + ig * z
        nprev = fg * nprev + ig
        hprev = o * cprev / torch.clamp_min(nprev, 1.0)
        mprev = mnew
        hs.append(hprev)
    hs = torch.stack(hs, dim=1).to(x.dtype)                            # (B,L,M)
    if cache is not None:
        for name, t in (("h", hprev), ("c", cprev), ("n", nprev), ("m", mprev)):
            cache[name].copy_(t)
    return x + linear(cfg, p["wo"], hs), cache
