"""Public wrappers around the kernels, with gradients.

Dispatch, decided by shape alone as in the reference:
  * `photonic_matmul` reaches the tiled path (per-128x128-tile scales, the
    `photonic_mac` kernel) only when K, N and M are all multiples of 128;
    any other shape takes `_tile_quantize_any` (one scale per column) and a
    plain f32 matmul.  The two paths give different numbers by design.
  * `attention` reaches the `flash_attention` kernel when both sequence
    lengths are >= 8 and each is <= 128 or a multiple of 128, and `q_offset`
    is a multiple of the query block; other shapes take `attention_ref`.
  * `ssm` reaches the `ssm_scan` kernel when the length L is >= 8.  The
    reference takes its Pallas kernel for L <= 128 or a multiple of 128, and
    the sequential oracle (the kernel's own function) for other L >= 8;
    shorter lengths take `ssm_scan_chunked_ref`, which rounds to bf16 as the
    reference's chunked form does.

Training: kernel forward, plain backward.  The kernels are forward-only;
`photonic_matmul` is straight-through (gradients as if w were unquantized,
the photonic weight banks being programmed from the master weights),
`attention` differentiates `attention_ref` and `ssm` differentiates
`ssm_scan_chunked_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention as _flash_fwd
from repro_torch.kernels.photonic_mac import BANK, photonic_mac as _mac_fwd, quantize_weights
from repro_torch.kernels.ssm_scan import check_shapes, expand_groups
from repro_torch.kernels.ssm_scan import ssm_scan as _ssm_fwd


# ---------------------------------------------------------------------------
# photonic matmul with straight-through quantization
# ---------------------------------------------------------------------------


def _tile_quantize_any(w: torch.Tensor, bits: int):
    """Whole-matrix quantization (per-column scale) for non-tileable shapes;
    returns dequantized f32 weights and the scale."""
    qmax = 2 ** (bits - 1) - 1
    scale = torch.linalg.vector_norm(w, ord=float("inf"), dim=0).clamp_min(1e-8) / qmax
    w_q = (w / scale[None, :]).round_().clamp_(-qmax, qmax).mul_(scale[None, :])
    return w_q.to(torch.float32), scale


def uses_tiled_path(m: int, k: int, n: int) -> bool:
    """True when `photonic_matmul` of an (m,k) by (k,n) product takes the
    tiled quantization and, with `use_kernel`, the `photonic_mac` kernel."""
    return not (k % BANK or n % BANK or m % 128)


def _photonic_fwd_impl(x, w, bits, use_kernel):
    k, n = w.shape
    if not uses_tiled_path(x.shape[0], k, n):
        w_dq, _ = _tile_quantize_any(w, bits)
        return torch.matmul(x.to(torch.float32), w_dq)
    w_q, scale = quantize_weights(w, bits=bits)
    if use_kernel:
        return _mac_fwd(x.contiguous(), w_q, scale)
    return _ref.photonic_mac_ref(x, w_q, scale)


class _PhotonicMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bits, use_kernel):
        ctx.save_for_backward(x, w)
        return _photonic_fwd_impl(x, w, bits, use_kernel)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(torch.float32)
        # straight-through: the gradient flows as if w were unquantized
        dx = torch.matmul(g, w.t().to(torch.float32)).to(x.dtype)
        dw = torch.matmul(x.t().to(torch.float32), g).to(w.dtype)
        return dx, dw, None, None


def photonic_matmul(x: torch.Tensor, w: torch.Tensor, bits: int = 8,
                    use_kernel: bool = True) -> torch.Tensor:
    """out (M,N) f32 = x (M,K) @ quantize(w (K,N)): forward through the
    photonic-MAC numerics, backward straight-through to the master weights.
    The master weight is re-quantized on every call."""
    return _PhotonicMatmul.apply(x, w, bits, use_kernel)


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


def _attention_impl(q, k, v, causal, window, scale, q_offset, use_kernel):
    if uses_flash_kernel(q.shape[2], k.shape[2], q_offset, use_kernel):
        return _flash_fwd(q, k, v, causal=causal, window=window, scale=scale,
                          q_offset=q_offset)
    return _ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                              q_offset=q_offset)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset, use_kernel):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, scale, q_offset)
        return _attention_impl(q, k, v, causal, window, scale, q_offset, use_kernel)

    @staticmethod
    def backward(ctx, g):
        causal, window, scale, q_offset = ctx.args
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = _ref.attention_ref(*qkv, causal=causal, window=window, scale=scale,
                                     q_offset=q_offset)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None, None, None


def attention(q, k, v, causal: bool = True, window: int = 0, scale=None,
              q_offset: int = 0, use_kernel: bool = True) -> torch.Tensor:
    """Flash attention (kernel forward, plain backward).  q (B,Hq,Sq,D);
    k,v (B,Hk,Sk,D) -> (B,Hq,Sq,D) f32."""
    return _Attention.apply(q, k, v, causal, window, scale, q_offset, use_kernel)


# ---------------------------------------------------------------------------
# ssm scan
# ---------------------------------------------------------------------------


def uses_ssm_kernel(l: int, use_kernel: bool = True) -> bool:
    """True when `ssm` takes the `ssm_scan` kernel for length `l`."""
    return bool(use_kernel and l >= 8)


def _ssm_impl(x, a, b, c, use_kernel):
    if uses_ssm_kernel(x.shape[1], use_kernel):
        return _ssm_fwd(x.contiguous(), a.contiguous(), b.contiguous(), c.contiguous())
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
