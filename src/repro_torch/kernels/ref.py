"""Plain PyTorch versions of the hand-written kernels.

The CPU tests run these, the kernel wrappers take them for a CPU tensor, and
the on-card smoke run holds each CUDA kernel against them.  `ops.attention`
differentiates `attention_ref` and `ops.ssm` differentiates
`ssm_scan_chunked_ref` for their backward (kernel forward / plain backward).
f32 products here are full f32: `allow_tf32` is False (set in
`repro_torch/__init__.py`), matching the reference's `Precision.HIGHEST`.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def dequantize_ref(w_q: torch.Tensor, w_scale: torch.Tensor,
                   bk: int = 128, bn: int = 128) -> torch.Tensor:
    """int levels (K,N) times the per-tile scale on the ceil grid -> f32.
    When K fills whole banks the product is taken in place, bank row by
    bank row, so that the only (K,N) f32 tensor is the result (qwen2-vl's
    head is 5 GB in f32)."""
    k, n = w_q.shape
    kt = w_scale.shape[0]
    col_scale = w_scale.repeat_interleave(bn, dim=1)[:, :n]          # (K/bk, N)
    w = w_q.to(torch.float32)
    if k == kt * bk:
        return w.view(kt, bk, n).mul_(col_scale[:, None, :]).view(k, n)
    return w.mul_(col_scale.repeat_interleave(bk, dim=0)[:k])


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


def ssm_scan_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """Sequential scan oracle, in f32 from whatever dtypes arrive:
    S_t = a_t S_{t-1} + x_t (outer) b_t, y_t = S_t c_t.
    x (BH,L,P), a (BH,L), b/c (BH,L,N) -> y (BH,L,P) f32."""
    bh, l, p = x.shape
    n = b.shape[-1]
    f32 = torch.float32
    x, a, b, c = x.to(f32), a.to(f32), b.to(f32), c.to(f32)
    s = torch.zeros((bh, p, n), dtype=f32, device=x.device)
    ys = []
    for t in range(l):
        s = a[:, t, None, None] * s + x[:, t, :, None] * b[:, t, None, :]
        ys.append(torch.einsum("zpn,zn->zp", s, c[:, t]))
    return torch.stack(ys, dim=1)


def ssm_scan_chunked_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """Chunked (SSD block-decomposition) scan, the same math as the TPU
    kernel: what `ops.ssm` runs without the kernel, and what its backward
    differentiates.  A length that does not tile into chunks falls to the
    sequential oracle.

    The decay math is f32 and in log space (no ratio of cumulative products).
    The big operands are rounded where the reference rounds them: to bf16 when
    x is bf16 (b and c follow x's dtype, not their own), and `(m*g)`, the
    decay-weighted x and the decayed c are rounded to that dtype before their
    products.  Every product itself is taken in f32 from those values (the
    reference's `preferred_element_type=f32`), and its result stays f32.

    x (BH,L,P), a (BH,L), b/c (BH,L,N) -> y (BH,L,P) f32."""
    bh, l, p = x.shape
    n = b.shape[-1]
    ch = min(chunk, l)
    if l % ch:
        return ssm_scan_ref(x, a, b, c)
    nc = l // ch
    f32 = torch.float32
    dt = torch.bfloat16 if x.dtype == torch.bfloat16 else f32
    xf = x.reshape(bh, nc, ch, p).to(dt)
    af = a.reshape(bh, nc, ch).to(f32)
    bf = b.reshape(bh, nc, ch, n).to(dt)
    cf = c.reshape(bh, nc, ch, n).to(dt)

    cum_log = torch.cumsum(torch.log(torch.clamp_min(af, 1e-37)), dim=-1)   # (bh,nc,ch)
    # intra-chunk: decay(s,t) = exp(cum_t - cum_s) for s <= t
    dlog = cum_log[..., None, :] - cum_log[..., :, None]                     # (bh,nc,s,t)
    idx = torch.arange(ch, device=x.device)
    mask = idx[:, None] <= idx[None, :]
    m = torch.where(mask, torch.exp(torch.clamp(dlog, -80.0, 0.0)), 0.0)
    g = torch.einsum("zksn,zktn->zkst", bf.to(f32), cf.to(f32))             # gram B C^T
    y_intra = torch.einsum("zkst,zksp->zktp", (m * g).to(dt).to(f32), xf.to(f32))

    # per-chunk state contribution and decay
    cum = torch.exp(cum_log)
    wgt = torch.exp(torch.clamp(cum_log[..., -1:] - cum_log, -80.0, 0.0))
    s_chunk = torch.einsum("zksp,zksn->zkpn", (xf * wgt[..., None].to(dt)).to(f32),
                           bf.to(f32))
    a_chunk = cum[..., -1]                                                   # (bh,nc)

    # inter-chunk scan: the carry-in state of each chunk, f32
    s = torch.zeros((bh, p, n), dtype=f32, device=x.device)
    s_in = []
    for k in range(nc):
        s_in.append(s)
        s = a_chunk[:, k, None, None] * s + s_chunk[:, k]
    s_in = torch.stack(s_in, dim=1)                                          # (bh,nc,p,n)

    c_dec = (cf.to(f32) * cum[..., None]).to(dt).to(f32)
    y_carry = torch.einsum("zktn,zkpn->zktp", c_dec, s_in.to(dt).to(f32))
    return (y_carry + y_intra).reshape(bh, l, p)
