"""Public wrappers around the kernels, with gradients.

Dispatch, decided by shape alone as in the reference:
  * `photonic_matmul` reaches the tiled path (per-128x128-tile scales, the
    `photonic_mac` kernel) only when K, N and M are all multiples of 128;
    any other shape takes `_tile_quantize_any` (one scale per column) and a
    plain f32 matmul.  The two paths give different numbers by design.
    On either, the weight's quantisation (and a split's MAX of its bank
    maxima) runs inside a `photonic.quantize` profiler range
    (`spans.span`); the product runs outside it.
  * On the tiled path a weight's banked levels are quantised once per
    change of the weight: `_LEVELS` keeps, on the view's root tensor, one
    `(w_q, scale)` per view geometry, bit width and slice, with the
    version it was built at, and a later call whose version still matches
    takes them (a hit: no quantise, no range).  A view shares its root's
    version counter, so a write through any alias makes the next call a
    miss, which replaces the entry.  It engages only where autograd
    records nothing for the weight, the weight tracks a version (not an
    inference tensor), no `TorchDispatchMode` runs and the quantise takes
    no MAX over a split; any other call quantises as before: training,
    the per-column path, a reduced split.
  * `attention` reaches the `flash_attention` kernel when both sequence
    lengths are >= 8 and each is <= 128 or a multiple of 128, and `q_offset`
    is a multiple of the query block; other shapes take `attention_ref`.
  * `ssm` reaches the `ssm_scan` kernel when the length L is >= 8.  The
    reference takes its Pallas kernel for L <= 128 or a multiple of 128, and
    the sequential oracle (the kernel's own function) for other L >= 8;
    shorter lengths take `ssm_scan_chunked_ref`, which rounds to bf16 as the
    reference's chunked form does.

Under a sharded train step (`photonic_matmul(shard=)`, a `Shard` that
`models.layers.linear` makes from `parallel.actx`) the tiled-or-per-column
choice is made on the GLOBAL (M, K, N): the rows across the batch ranks,
and the whole weight's K and N where a rank holds a column or row slice of
it.  Such a slice is quantized as the whole weight is: each bank's max
over every rank's part of it (a MAX over the split, `Shard.reduce_max`),
the slice zero-padded out to the global bank edges (zeros change neither
a product nor a max), the unchanged kernel on whole banks, the padding
sliced off.  A row slice's product is this rank's partial sum.

Each kernel is also a `torch.library.custom_op` (`repro_torch::photonic_mac`,
`::flash_attention`, `::ssm_scan`): its implementation is the wrapper
(the launch on a CUDA tensor, the plain version on a CPU tensor), its
fake implementation gives the output's shape and dtype, and a
`torch.utils.flop_counter` formula its FLOPs.  Under a
`TorchDispatchMode` (`FakeTensorMode` in `launch.dryrun`, a flop counter)
the kernel is reached through its operator, so that the mode runs none of
it and counts it as the card runs it; otherwise the wrapper is called
straight (`_kernel`), without the dispatcher's work on each launch.

Training: kernel forward, plain backward.  The kernels are forward-only;
`photonic_matmul` is straight-through (gradients as if w were unquantized,
the photonic weight banks being programmed from the master weights),
`attention` differentiates `attention_ref` and `ssm` differentiates
`ssm_scan_chunked_ref`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention as _flash_fwd
from repro_torch.kernels.photonic_mac import BANK, bank_absmax, quantize_weights
from repro_torch.kernels.photonic_mac import photonic_mac as _mac_fwd
from repro_torch.kernels.ssm_scan import check_shapes, expand_groups
from repro_torch.kernels.ssm_scan import ssm_scan as _ssm_fwd
from repro_torch.spans import span


# ---------------------------------------------------------------------------
# the kernels as custom operators
# ---------------------------------------------------------------------------


def _kernel(op, fn, *args):
    """`op(*args)`, the kernel's operator, under a `TorchDispatchMode`;
    else the wrapper `fn(*args)` it holds."""
    return op(*args) if torch._C._len_torch_dispatch_stack() else fn(*args)


def _mac_fn(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return _mac_fwd(x, w_q, scale)


_mac_op = torch.library.custom_op("repro_torch::photonic_mac", _mac_fn, mutates_args=())


@_mac_op.register_fake
def _(x, w_q, scale):
    return x.new_empty((x.shape[0], w_q.shape[1]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.photonic_mac)
def _mac_flops(x_shape, w_shape, scale_shape, out_shape=None, **kwargs) -> int:
    return 2 * x_shape[0] * x_shape[1] * w_shape[1]


def _flash_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
              scale: Optional[float], q_offset: int) -> torch.Tensor:
    return _flash_fwd(q, k, v, causal=causal, window=window, scale=scale, q_offset=q_offset)


_flash_op = torch.library.custom_op("repro_torch::flash_attention", _flash_fn,
                                    mutates_args=())


@_flash_op.register_fake
def _(q, k, v, causal, window, scale, q_offset):
    return q.new_empty(tuple(q.shape), dtype=torch.float32)


def _attention_pairs(sq: int, sk: int, causal: bool, window: int, q_offset: int) -> int:
    """The (query, key) pairs the mask keeps: row i (at position q_offset
    + i) sees keys up to itself (causal) and back to window - 1 before it."""
    pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos + 1, sk) if causal else np.full(sq, sk, dtype=np.int64)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(sq, dtype=np.int64)
    return int(np.clip(hi - lo, 0, None).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, scale, q_offset,
                 out_shape=None, **kwargs) -> int:
    """Q K^T and P V over the pairs the mask keeps."""
    b, hq, sq, d = q_shape
    return 4 * b * hq * d * _attention_pairs(sq, k_shape[2], causal, window, q_offset)


def _ssm_fn(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return _ssm_fwd(x, a, b, c)


_ssm_op = torch.library.custom_op("repro_torch::ssm_scan", _ssm_fn, mutates_args=())


@_ssm_op.register_fake
def _(x, a, b, c):
    return x.new_empty(tuple(x.shape), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.ssm_scan)
def _ssm_flops(x_shape, a_shape, b_shape, c_shape, out_shape=None, **kwargs) -> int:
    """Each step's outer product x_t b_t^T into the state and its product
    with c_t, a multiply-add per state entry each."""
    bh, l, p = x_shape
    return 4 * bh * l * p * b_shape[2]


# ---------------------------------------------------------------------------
# photonic matmul with straight-through quantization
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Shard:
    """Where one rank's product sits in the global one: `m` the global
    rows; `split` None (the rank holds the whole weight), "cols" (columns
    `index` * N of the (K, `parts` * N) weight) or "rows" (rows `index` * K
    of the (`parts` * K, N) weight, with the matching columns of x);
    `reduce_max(t)` the elementwise MAX of `t` over the `parts` ranks."""
    m: int
    split: Optional[str] = None
    index: int = 0
    parts: int = 1
    reduce_max: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def global_kn(self, k: int, n: int):
        if self.split == "cols":
            return k, n * self.parts
        if self.split == "rows":
            return k * self.parts, n
        return k, n


def _tile_quantize_any(w: torch.Tensor, bits: int, reduce_max=None):
    """Whole-matrix quantization (per-column scale) for non-tileable shapes;
    returns dequantized f32 weights and the scale.  `reduce_max`, for a row
    slice of the weight, takes each column's max over every rank's rows."""
    qmax = 2 ** (bits - 1) - 1
    absmax = torch.linalg.vector_norm(w, ord=float("inf"), dim=0)
    if reduce_max is not None:
        absmax = reduce_max(absmax)
    scale = absmax.clamp_min(1e-8) / qmax
    w_q = (w / scale[None, :]).round_().clamp_(-qmax, qmax).mul_(scale[None, :])
    return w_q.to(torch.float32), scale


def uses_tiled_path(m: int, k: int, n: int) -> bool:
    """True when `photonic_matmul` of an (m,k) by (k,n) product takes the
    tiled quantization and, with `use_kernel`, the `photonic_mac` kernel."""
    return not (k % BANK or n % BANK or m % 128)


def shard_banks(x: torch.Tensor, w: torch.Tensor, split: str, index: int,
                pad_w: bool = True):
    """A rank's slice of a weight zero-padded out to the global bank edges
    it straddles, with x padded to match (a row slice's columns): returns
    (x, w, first bank, the slice's offset in the padded weight).  With
    `pad_w` False (a weight whose levels are kept) w comes back as given."""
    dim = 1 if split == "cols" else 0
    size = w.shape[dim]
    start = index * size
    lo, hi = start // BANK, -(-(start + size) // BANK)
    before, after = start - lo * BANK, hi * BANK - start - size
    if before or after:
        if dim == 1:
            w = torch.nn.functional.pad(w, (before, after)) if pad_w else w
        else:
            w = torch.nn.functional.pad(w, (0, 0, before, after)) if pad_w else w
            x = torch.nn.functional.pad(x, (before, after))
    return x, w, lo, before


def _global_absmax(absmax: torch.Tensor, split: str, lo: int, banks: int, reduce_max):
    """The MAX over the ranks of each bank's max: this rank's banks
    [lo, lo + its count) placed in the global grid of `banks` along the
    split dimension (zeros elsewhere: a max is >= 0), reduced, cut back."""
    dim = 1 if split == "cols" else 0
    shape = list(absmax.shape)
    count, shape[dim] = shape[dim], banks
    grid = torch.zeros(shape, dtype=absmax.dtype, device=absmax.device)
    grid.narrow(dim, lo, count).copy_(absmax)
    return reduce_max(grid).narrow(dim, lo, count)


def _mac(x, w_q, scale, use_kernel):
    if use_kernel:
        return _kernel(_mac_op, _mac_fn, x.contiguous(), w_q, scale)
    return _ref.photonic_mac_ref(x, w_q, scale)


# a weight's root tensor (the view's `_base`, or the weight) -> {the view's
# offset, sizes, strides and dtype, the bits and the slice: (the version
# the levels were built at, w_q, scale)}; an entry dies with its root
_LEVELS = WeakIdKeyDictionary()


def _photonic_fwd_impl(x, w, bits, use_kernel, shard=None, reuse=False):
    k, n = w.shape
    m = x.shape[0] if shard is None else shard.m
    split = None if shard is None or shard.parts == 1 else shard.split
    kg, ng = (k, n) if split is None else shard.global_kn(k, n)
    if not uses_tiled_path(m, kg, ng):
        with span("photonic.quantize"):
            w_dq, _ = _tile_quantize_any(w, bits, shard.reduce_max if split == "rows" else None)
        return torch.matmul(x.to(torch.float32), w_dq)
    # an unsplit weight is column slice 0 of itself: nothing padded, no MAX
    index = shard.index if split else 0
    reduce_max = shard.reduce_max if split else None
    entries = key = levels = None
    if reuse and reduce_max is None:
        root = w if w._base is None else w._base
        entries = _LEVELS.get(root)
        if entries is None:
            entries = _LEVELS[root] = {}
        key = (w.storage_offset(), w.shape, w.stride(), w.dtype, bits, split, index,
               shard.parts if split else 1)
        kept = entries.get(key)
        if kept is not None and kept[0] == w._version:
            photonic_matmul.quant_hits += 1
            levels = kept[1:]
        else:
            photonic_matmul.quant_misses += 1
    # a hit pads only x (a row slice's columns): the levels are padded already
    xp, wp, lo, off = shard_banks(x, w, split or "cols", index, pad_w=levels is None)
    if levels is None:
        with span("photonic.quantize"):
            absmax = bank_absmax(wp)
            if reduce_max is not None:
                absmax = _global_absmax(absmax, split, lo,
                                        (ng if split == "cols" else kg) // BANK, reduce_max)
            levels = quantize_weights(wp, bits=bits, absmax=absmax)
        if entries is not None:
            entries[key] = (w._version, *levels)
    out = _mac(xp, *levels, use_kernel)
    return out[:, off:off + n] if out.shape[1] != n else out


class _PhotonicMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bits, use_kernel, shard, reuse):
        ctx.save_for_backward(x, w)
        return _photonic_fwd_impl(x, w, bits, use_kernel, shard, reuse)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(torch.float32)
        # straight-through: the gradient flows as if w were unquantized
        dx = torch.matmul(g, w.t().to(torch.float32)).to(x.dtype)
        dw = torch.matmul(x.t().to(torch.float32), g).to(w.dtype)
        return dx, dw, None, None, None, None


def photonic_matmul(x: torch.Tensor, w: torch.Tensor, bits: int = 8,
                    use_kernel: bool = True, shard: Optional[Shard] = None) -> torch.Tensor:
    """out (M,N) f32 = x (M,K) @ quantize(w (K,N)): forward through the
    photonic-MAC numerics, backward straight-through to the master weights.
    On the tiled path a weight that autograd does not record is quantised
    once per change of its version and its levels reused until then
    (module docstring); `.quant_hits` and `.quant_misses` count the calls
    that looked its levels up.  Any other call quantises the master.
    `shard` places this rank's product in a sharded step's global one
    (module docstring); for a row slice the result is this rank's partial
    sum."""
    # decided here: inside the Function's forward autograd records nothing
    reuse = not (torch.is_grad_enabled() and w.requires_grad or w.is_inference()
                 or torch._C._len_torch_dispatch_stack())
    return _PhotonicMatmul.apply(x, w, bits, use_kernel, shard, reuse)


photonic_matmul.quant_hits = 0
photonic_matmul.quant_misses = 0


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def uses_flash_kernel(sq: int, sk: int, q_offset: int, use_kernel: bool = True) -> bool:
    """True when `attention` takes the `flash_attention` kernel for these lengths."""
    return bool(
        use_kernel
        and sq % min(128, sq) == 0
        and sk % min(128, sk) == 0
        and q_offset % min(128, sq) == 0
        and sk >= 8 and sq >= 8
    )


def _attention_impl(q, k, v, causal, window, scale, q_offset, use_kernel, global_sq=None):
    sq, sk = q.shape[2], k.shape[2]
    # a slice of the sequence (seq_tp) takes the kernel when the whole
    # sequence would and the slice's shape can
    kernel = uses_flash_kernel(sq, sk, q_offset, use_kernel) and (
        global_sq is None or uses_flash_kernel(global_sq, sk, 0, use_kernel))
    if kernel:
        return _kernel(_flash_op, _flash_fn, q, k, v, causal, window, scale, q_offset)
    return _ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                              q_offset=q_offset)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset, use_kernel, global_sq):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, scale, q_offset)
        return _attention_impl(q, k, v, causal, window, scale, q_offset, use_kernel, global_sq)

    @staticmethod
    def backward(ctx, g):
        causal, window, scale, q_offset = ctx.args
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = _ref.attention_ref(*qkv, causal=causal, window=window, scale=scale,
                                     q_offset=q_offset)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None, None, None, None


def attention(q, k, v, causal: bool = True, window: int = 0, scale=None,
              q_offset: int = 0, use_kernel: bool = True,
              global_sq: Optional[int] = None) -> torch.Tensor:
    """Flash attention (kernel forward, plain backward).  q (B,Hq,Sq,D);
    k,v (B,Hk,Sk,D) -> (B,Hq,Sq,D) f32.  `global_sq`: the whole sequence's
    length when q holds a slice of it (`q_offset` its start), on which the
    kernel's dispatch is decided as the reference decides it."""
    return _Attention.apply(q, k, v, causal, window, scale, q_offset, use_kernel, global_sq)


# ---------------------------------------------------------------------------
# ssm scan
# ---------------------------------------------------------------------------


def uses_ssm_kernel(l: int, use_kernel: bool = True) -> bool:
    """True when `ssm` takes the `ssm_scan` kernel for length `l`."""
    return bool(use_kernel and l >= 8)


def _ssm_impl(x, a, b, c, use_kernel):
    if uses_ssm_kernel(x.shape[1], use_kernel):
        return _kernel(_ssm_op, _ssm_fn, x.contiguous(), a.contiguous(), b.contiguous(),
                       c.contiguous())
    bh = x.shape[0]
    return _ref.ssm_scan_chunked_ref(x, a, expand_groups(b, bh), expand_groups(c, bh))


class _SSM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, c, use_kernel):
        check_shapes(x, a, b, c)
        ctx.save_for_backward(x, a, b, c)
        return _ssm_impl(x, a, b, c, use_kernel)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            xabc = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            x, a, b, c = xabc
            # grouped b and c are repeated under autograd, so their gradients
            # sum over the heads of each group
            out = _ref.ssm_scan_chunked_ref(x, a, expand_groups(b, x.shape[0]),
                                            expand_groups(c, x.shape[0]))
            dx, da, db, dc = torch.autograd.grad(out, xabc, g)
        return dx, da, db, dc, None


def ssm(x, a, b, c, use_kernel: bool = True) -> torch.Tensor:
    """Chunked selective scan (kernel forward, plain backward).
    x (BH,L,P), a (BH,L), b/c (G,L,N) with G dividing BH (G = BH: one b and
    c per head; else heads g*BH/G .. share b[g] and c[g]) -> y (BH,L,P) f32."""
    return _SSM.apply(x, a, b, c, use_kernel)
