"""Plain PyTorch versions of the hand-written kernels.

The CPU tests run these, the kernel wrappers take them for a CPU tensor, and
the on-card smoke run holds each CUDA kernel against them.  `ops.attention`
differentiates `attention_ref` for its backward (kernel forward / plain
backward).  f32 products here are full f32: `allow_tf32` is False (set in
`repro_torch/__init__.py`), matching the reference's `Precision.HIGHEST`.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def dequantize_ref(w_q: torch.Tensor, w_scale: torch.Tensor,
                   bk: int = 128, bn: int = 128) -> torch.Tensor:
    """int levels (K,N) times the per-tile scale on the ceil grid -> f32."""
    k, n = w_q.shape
    scale_full = w_scale.repeat_interleave(bk, dim=0).repeat_interleave(bn, dim=1)
    return w_q.to(torch.float32) * scale_full[:k, :n]


def photonic_mac_ref(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                     bk: int = 128, bn: int = 128) -> torch.Tensor:
    """Dequantize-then-matmul: x (M,K) @ (w_q (K,N) int8 * per-tile scale),
    f32 result.  Non-aligned shapes use the scale grid's leading (K,N)
    window, as the kernel's masked edges do."""
    w = dequantize_ref(w_q, w_scale, bk, bn)
    return torch.matmul(x.to(torch.float32), w)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, scale=None,
                  q_offset: int = 0) -> torch.Tensor:
    """Naive softmax attention with GQA and causal / sliding-window masks.
    q (B,Hq,Sq,D); k,v (B,Hk,Sk,D) -> (B,Hq,Sq,D) f32."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group = hq // hk
    scale = scale if scale is not None else d ** -0.5
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
