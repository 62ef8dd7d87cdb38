"""Counts of the decoder family (`reference/decoder.py`'s models) as the
port serves them: the products of each call, the kernel launches the
dispatch predicates give them, and the model FLOPs of a token.

Frozen from the port's `models/layers.py` (which products a block runs
through `linear`; the routed experts are plain products) and
`kernels/ops.py` (`uses_tiled_path`: a product of M rows by a (K, N)
weight launches `photonic_mac` when M, K and N are all multiples of 128;
`uses_flash_kernel`: attention launches `flash_attention` when both
lengths are at least 8 and each is at most 128 or a multiple of 128; a
decode step attends by plain tensor code).  `c` is the configuration
file's dict.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from bench.counts.bounds import attention_pairs
from bench.reference.decoder import tiled

Launches = Dict[str, List[Tuple]]

# the kernels this family's calls launch: name -> the program's wrapper
# (module, attribute), whose `.launches` counts them
KERNELS = {"photonic_mac": ("repro_torch.kernels.photonic_mac", "photonic_mac"),
           "flash_attention": ("repro_torch.kernels.flash_attention", "flash_attention")}


def flash(sq: int, sk: int, q_offset: int = 0) -> bool:
    return bool(sq % min(128, sq) == 0 and sk % min(128, sk) == 0
                and q_offset % min(128, sq) == 0 and sk >= 8 and sq >= 8)


def window(c: dict) -> int:
    return c["window"] if c.get("attn_pattern") == "sliding" else 0


def block_products(c: dict) -> List[Tuple[int, int]]:
    """(K, N) of every product one block runs through the photonic
    linear: wq, wk, wv, wo, then the MLP's wg, wi, wo or the router."""
    m, h, hk, d = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"]
    attn = [(m, h * d), (m, hk * d), (m, hk * d), (h * d, m)]
    if c["family"] == "moe":
        return attn + [(m, c["n_experts"])]
    return attn + [(m, c["d_ff"]), (m, c["d_ff"]), (c["d_ff"], m)]


def _macs(c: dict, rows: int) -> List[Tuple[int, int, int]]:
    if not (c["use_photonic_mac"] and c["use_kernels"]):
        return []
    return [(rows, k, n) for k, n in block_products(c) if tiled(rows, k, n)] * c["n_layers"]


def prefill_launches(c: dict, length: int) -> Launches:
    """One batch-1 prefill call of `length` (padded) tokens; its head runs
    on the last row alone."""
    mac = _macs(c, length)
    if c["use_photonic_mac"] and c["use_kernels"] and tiled(1, c["d_model"], c["vocab"]):
        mac.append((1, c["d_model"], c["vocab"]))
    fa = []
    if c["use_kernels"] and flash(length, length):
        fa = [(1, c["n_heads"], c["n_kv_heads"], length, length, c["head_dim"], True,
               window(c), 0)] * c["n_layers"]
    return {"photonic_mac": mac, "flash_attention": fa}


def decode_launches(c: dict, slots: int) -> Launches:
    """One decode step of `slots` rows, the head on every row."""
    mac = _macs(c, slots)
    if c["use_photonic_mac"] and c["use_kernels"] and tiled(slots, c["d_model"], c["vocab"]):
        mac.append((slots, c["d_model"], c["vocab"]))
    return {"photonic_mac": mac, "flash_attention": []}


def _layer_matmul_params(c: dict) -> int:
    """Matmul parameters one token uses in a block (the experts: top_k)."""
    m, f = c["d_model"], c["d_ff"]
    attn = sum(k * n for k, n in block_products(c)[:4])
    if c["family"] == "moe":
        return attn + m * c["n_experts"] + c["top_k"] * 3 * m * f
    return attn + 3 * m * f


def prefill_flops(c: dict, n_real: int) -> float:
    """Model FLOPs of prefilling `n_real` real prompt tokens (no padding,
    no head: the batcher reads no prefill logits)."""
    per_tok = 2 * _layer_matmul_params(c) * c["n_layers"]
    pairs = attention_pairs(n_real, n_real, True, window(c), 0)
    return float(per_tok * n_real + 4 * c["n_heads"] * c["head_dim"] * pairs * c["n_layers"])


def decode_flops(c: dict, pos: int) -> float:
    """Model FLOPs of decoding one token at position `pos`, the head
    included."""
    keys = min(pos + 1, window(c)) if window(c) else pos + 1
    return float(2 * _layer_matmul_params(c) * c["n_layers"] + 2 * c["d_model"] * c["vocab"]
                 + 4 * c["n_heads"] * c["head_dim"] * keys * c["n_layers"])
