"""The least time the card could take for one launch of a kernel of the
port: the larger of its operations over the peak rate of its inputs' dtype
and its bytes (each input read once, each output written once) over the
HBM bandwidth.  Counted from the shapes alone, whatever implements them."""

from __future__ import annotations

import numpy as np

from bench.counts import peaks


def _peak(esize: int) -> float:
    return peaks.BF16_FLOPS if esize == 2 else peaks.F32_FLOPS


def mac_bound_s(m: int, k: int, n: int, esize: int = 2) -> float:
    """`photonic_mac`: x (M, K) in `esize`-byte activations, the int8
    levels (K, N), the f32 bank scales and the f32 output (M, N); 2MKN
    operations."""
    nbytes = m * k * esize + k * n + 4 * (-(-k // 128)) * (-(-n // 128)) + 4 * m * n
    return max(nbytes / peaks.HBM_BYTES_PER_S, 2.0 * m * k * n / _peak(esize))


def attention_pairs(sq: int, sk: int, causal: bool, window: int, q_offset: int) -> int:
    """The (query, key) pairs the mask keeps: query i (at q_offset + i)
    sees keys up to itself (causal) and back to window - 1 before it."""
    pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos + 1, sk) if causal else np.full(sq, sk, dtype=np.int64)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(sq, dtype=np.int64)
    return int(np.clip(hi - lo, 0, None).sum())


def attn_bound_s(b: int, hq: int, hk: int, sq: int, sk: int, d: int, causal: bool,
                 window: int, q_offset: int = 0, esize: int = 2) -> float:
    """`flash_attention`: q, k, v read once, the f32 output written once;
    4 d operations a kept (query, key) pair and head (Q K^T and P V)."""
    nbytes = esize * b * d * (hq * sq + 2 * hk * sk) + 4 * b * hq * sq * d
    ops = 4.0 * d * attention_pairs(sq, sk, causal, window, q_offset) * b * hq
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / _peak(esize))
