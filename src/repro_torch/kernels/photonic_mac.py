"""Photonic MAC: the paper's broadcast-and-weight numerics as a quantized
matmul, `out = x @ (w_q * per-tile scale)`.

Each 128x128 weight tile is one MR weight bank whose dynamic range is set by
its own tuning: int8 levels with one f32 scale per tile.  Activations stay
bf16/f32 and the sum is f32 (the photodetector's analog accumulation).

  x        (M, K)   bf16/f32 activations
  w_q      (K, N)   int8 levels
  w_scale  (ceil(K/128), ceil(N/128)) f32 per-tile scales
  out      (M, N)   f32

`photonic_mac` launches a CUDA kernel of `csrc/photonic_mac.cu` for a CUDA
tensor and takes the plain version (`ref.photonic_mac_ref`) only for a CPU
tensor.  `photonic_mac.launches` counts kernel launches.  Which kernel, and
on what plan, is `dispatch`'s answer: bf16 activations with K and N
multiples of 128 go to the tensor-core kernel `mac_kernel_sm90` on the tiles
and K split `mac_plan` gives; everything else to the f32 FMA kernel
`mac_kernel`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build, ref

BANK = 128   # weight-bank tile edge; the CUDA kernels are written for this value
SMS = 132    # streaming multiprocessors of an H100 SXM
SEQ_BLOCKS = 128   # unsplit 128-row blocks from which `mac_plan` sums K ranges in turn
QUANT_CHUNK = 1 << 26   # f32 elements of the quantized quotient held at once


def bank_absmax(w: torch.Tensor, bk: int = BANK, bn: int = BANK) -> torch.Tensor:
    """max |w| of each (bk x bn) bank of w (K, N) on the zero-padded ceil
    grid, (ceil(K/bk), ceil(N/bn)), in w's dtype: one pass (the inf-norm)."""
    k, n = w.shape
    kp, np_ = -(-k // bk) * bk, -(-n // bn) * bn
    if (kp, np_) != (k, n):
        w = torch.nn.functional.pad(w, (0, np_ - n, 0, kp - k))
    return torch.linalg.vector_norm(w.reshape(kp // bk, bk, np_ // bn, bn), ord=float("inf"),
                                    dim=(1, 3))


def quantize_weights(w: torch.Tensor, bits: int = 8, bk: int = BANK, bn: int = BANK,
                     absmax: torch.Tensor = None):
    """Per-(bk x bn)-tile symmetric quantization: one scale per MR weight
    bank, range set by the bank's own max |w| (`bank_absmax`), or by
    `absmax` when given: a shard of a weight split across ranks takes its
    banks' maxima over every rank's part of them.

    Non-aligned weights quantize on the zero-padded ceil grid (padding is
    exact zero, so it never widens a bank's range; an all-zero tile gets the
    epsilon scale) and `w_q` is sliced back to (K, N).  `w_scale` comes back
    f32 (ceil(K/bk), ceil(N/bn)), what `photonic_mac` expects.

    The levels are computed a few bank rows at a time, so that the f32
    quotient never exceeds `QUANT_CHUNK` elements (about 256 MB; qwen2-vl's
    head would otherwise need a 5 GB one); each element's arithmetic is the
    same."""
    k, n = w.shape
    kp, np_ = -(-k // bk) * bk, -(-n // bn) * bn
    if (kp, np_) != (k, n):
        w = torch.nn.functional.pad(w, (0, np_ - n, 0, kp - k))
    tiles = w.reshape(kp // bk, bk, np_ // bn, bn)
    qmax = 2 ** (bits - 1) - 1
    if absmax is None:
        absmax = bank_absmax(w, bk, bn)
    scale = absmax.clamp_min(1e-8) / qmax
    w_q = torch.empty((kp, np_), dtype=torch.int8, device=w.device)
    q_tiles = w_q.view(kp // bk, bk, np_ // bn, bn)
    rows = max(1, QUANT_CHUNK // (bk * np_))           # bank rows a pass
    for i in range(0, kp // bk, rows):
        part = tiles[i:i + rows] / scale[i:i + rows, None, :, None]
        q_tiles[i:i + rows] = part.round_().clamp_(-qmax, qmax)
    return w_q[:k, :n].contiguous(), scale.to(torch.float32)


@dataclass(frozen=True)
class MacPlan:
    """Launch plan of `mac_kernel_sm90` for one (M, K, N): a grid of
    `cluster` x `n_tiles` x `m_tiles` blocks of `bm` x 128 outputs.  K is
    summed as `splits` ranges of whole banks (the kernel derives them from
    K and `splits`) whose sums are added in range order, either by the
    `splits` blocks of one thread-block cluster (`cluster == splits`) or by
    each block in turn (`cluster == 1`); the two give the same bits.
    `m_fast` puts row tiles fastest in the grid, so that the blocks that
    share a weight tile run together."""
    bm: int
    splits: int
    cluster: int
    m_tiles: int
    n_tiles: int
    m_fast: bool

    @property
    def blocks(self) -> int:
        return self.cluster * self.m_tiles * self.n_tiles

    def as_dict(self) -> dict:
        return {"bm": self.bm, "bn": BANK, "splits": self.splits, "cluster": self.cluster,
                "m_tiles": self.m_tiles, "n_tiles": self.n_tiles, "blocks": self.blocks,
                "m_fast": self.m_fast}


def mac_splits(k: int, n: int) -> int:
    """How many bank-aligned K ranges `mac_kernel_sm90` splits a (K, N)
    weight into: a function of K and N alone, so that the order in which any
    output's terms are summed never depends on M.

    The largest power of two that keeps the column tiles times the ranges
    within 64, at most one range per bank and at most 16 (the cluster size
    limit).  Each range costs its blocks a ring fill and a cluster
    reduction, so a split pays only where the column tiles alone leave most
    SMs idle; at 64 or more column tiles none is made."""
    banks, n_tiles = k // BANK, n // BANK
    splits = 1
    while splits * 2 * n_tiles <= 64 and splits * 2 <= min(banks, 16):
        splits *= 2
    return splits


def mac_ranges(k: int, splits: int) -> list:
    """The bank ranges [lo, hi) that `mac_kernel_sm90` sums K as: range q
    holds banks [q * banks // splits, (q + 1) * banks // splits), so where
    `splits` does not divide the banks, neighbouring ranges differ by one
    (gemma3's 42 banks over 4: 10, 11, 10, 11)."""
    banks = k // BANK
    return [(q * banks // splits, (q + 1) * banks // splits) for q in range(splits)]


def mac_plan(m: int, k: int, n: int) -> MacPlan:
    """The plan for an (m,k) by (k,n) product with K, N multiples of 128:
    the split from `mac_splits`.  Where 128-row tiles alone make SEQ_BLOCKS
    blocks or more, a split buys no parallelism, so each block sums the
    ranges in turn on 128-row tiles.  Otherwise a cluster of `splits`
    blocks sums them, on the tallest row tile (128, 64, 32, no taller than
    m needs) that still gives at least one block per SM.  Row tiles run
    fastest at up to 8 of them, so that the few blocks reading one weight
    tile run together; beyond that column tiles do, so that the blocks
    reading one tile of x do (`PERF.md` has the sweep's readings)."""
    if k % BANK or n % BANK or m <= 0:
        raise ValueError(f"mac_plan: ({m},{k},{n}) is not a bank-aligned product")
    splits, n_tiles = mac_splits(k, n), n // BANK
    if -(-m // BANK) * n_tiles >= SEQ_BLOCKS:
        bm, cluster = BANK, 1
    else:
        fits = [bm for bm in (128, 64, 32) if bm <= max(32, m)]
        bm = next((b for b in fits if -(-m // b) * n_tiles * splits >= SMS), fits[-1])
        cluster = splits
    m_tiles = -(-m // bm)
    return MacPlan(bm=bm, splits=splits, cluster=cluster, m_tiles=m_tiles, n_tiles=n_tiles,
                   m_fast=m_tiles <= 8)


def dispatch(x: torch.Tensor, w_q: torch.Tensor, tensor_cores: bool = True):
    """("mac_kernel_sm90", plan) when the tensor-core kernel takes this
    product (bf16 x, K and N multiples of 128, x and w_q 16-byte aligned,
    `tensor_cores`), else ("mac_kernel", None), the f32 FMA kernel."""
    m, k = x.shape
    n = w_q.shape[1]
    if (tensor_cores and x.dtype == torch.bfloat16 and k % BANK == 0 and n % BANK == 0
            and x.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0):
        return "mac_kernel_sm90", mac_plan(m, k, n)
    return "mac_kernel", None


def _entry(name: str, n_int: int):
    fn = getattr(_build.library(), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch_sm90(x, w_q, w_scale, out, plan: MacPlan) -> int:
    """Launch `mac_kernel_sm90` on `plan` into `out`; returns the CUDA error
    code.  Checks nothing and counts nothing: `photonic_mac` does both."""
    m, k = x.shape
    with torch.cuda.device(x.device):
        return _entry("photonic_mac_sm90_launch", 7)(
            x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
            m, k, w_q.shape[1], plan.bm, plan.splits, plan.cluster, int(plan.m_fast),
            torch.cuda.current_stream(x.device).cuda_stream)


def photonic_mac(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, *,
                 tensor_cores: bool = True) -> torch.Tensor:
    """Quantized-weight matmul; shapes need not be tile-aligned (the FMA
    kernel masks ragged edges).  Rows are bit-identical whatever M is.

    bf16 activations go to the tensor-core kernel when K and N are multiples
    of 128, else to the f32 FMA kernel, which f32 activations always take;
    `tensor_cores=False` keeps bf16 on the FMA kernel as well (`dispatch`)."""
    if x.ndim != 2 or w_q.ndim != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"photonic_mac: bad shapes x{tuple(x.shape)} w_q{tuple(w_q.shape)}")
    m, k = x.shape
    n = w_q.shape[1]
    if tuple(w_scale.shape) != (-(-k // BANK), -(-n // BANK)):
        raise ValueError(f"photonic_mac: w_scale {tuple(w_scale.shape)} is not the ceil "
                         f"grid of a ({k},{n}) weight")
    if w_q.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise TypeError("photonic_mac: w_q must be int8 and w_scale float32")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"photonic_mac: x must be float32 or bfloat16, got {x.dtype}")
    if not (x.device == w_q.device == w_scale.device):
        raise ValueError("photonic_mac: x, w_q and w_scale lie on different devices")
    if x.device.type == "cpu":
        return ref.photonic_mac_ref(x, w_q, w_scale)
    if x.device.type != "cuda":
        raise ValueError(f"photonic_mac: unsupported device {x.device}")
    if not (x.is_contiguous() and w_q.is_contiguous() and w_scale.is_contiguous()):
        raise ValueError("photonic_mac: x, w_q and w_scale must be contiguous")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    kernel, plan = dispatch(x, w_q, tensor_cores)
    if plan is not None:
        err = _launch_sm90(x, w_q, w_scale, out, plan)
    else:
        with torch.cuda.device(x.device):
            err = _entry("photonic_mac_launch", 4)(
                x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
                m, k, n, int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, f"photonic_mac ({kernel})")
    photonic_mac.launches += 1
    return out


photonic_mac.launches = 0
