"""Selective state-space scan (Mamba2 / SSD recurrence) for the zamba2 hybrid
and the xLSTM mLSTM blocks.

Per batch*head, with a scalar decay per step and a (P x N) matrix state:

    S_t = a_t * S_{t-1} + x_t (outer) b_t          y_t = S_t c_t

  x  (BH, L, P)   bf16/f32
  a  (BH, L)      f32
  b  (G, L, N)    bf16/f32      G divides BH: heads g*H .. g*H+H-1 (H = BH/G)
  c  (G, L, N)    bf16/f32      share b[g] and c[g]   ->  y (BH, L, P) f32

G = BH is the plain per-head form; zamba2's heads share one B and C per
batch row (G = batch), which is the reference's `jnp.repeat(..., axis=0)`
layout without the repeat.  x, b and c may each be bf16 or f32 (mLSTM's
normaliser has f32 x with bf16 b and c); the scan is computed in f32 from
their values.

`ssm_scan` launches the CUDA kernel of `csrc/ssm_scan.cu` on the plan
`ssm_plan` gives for CUDA tensors, and takes the plain version
(`ref.ssm_scan_ref`, the sequential oracle, on b and c repeated per head)
only for CPU tensors.  `ssm_scan.launches` counts wrapper calls that
launched.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import asdict, dataclass

import torch

from repro_torch.kernels import _build, ref

MAX_N = 512               # state width the CUDA kernel takes (32 threads of 16 entries per row)
THREADS = 256             # threads a block of `ssm_scan_kernel_ring` has at most
RING_VARIANTS = ((1, 4), (1, 8), (4, 16))   # (rt, ns) instantiated
SMS = 132                 # streaming multiprocessors of an H100 SXM
SMEM_PER_SM = 233472      # shared memory of one SM; each block also reserves 1 KB
SMEM_PER_BLOCK = 232448   # the most one block may take
T_TILES = (32, 16, 8, 4)  # steps a staged tile, longest first
CHUNK = 512               # steps a chunk where the scan is chunk-parallel
CHUNKED_STATE = 1 << 19   # chunk-parallel when BH * P * N is at most this (and L >= 4 chunks)


def _esize(dtype: str) -> int:
    return 2 if dtype == "bf16" else 4


def _pow2(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def _align16(v: int) -> int:
    return (v + 15) // 16 * 16


@dataclass(frozen=True)
class SSMPlan:
    """Launch plan of `ssm_scan_kernel_ring`: a grid of BH x `row_tiles`
    blocks of `threads`.  A block owns `rows` rows of one head (rows past P
    fill it up to whole warps); a thread holds `ns` entries of each of `rt`
    rows, and `r` threads share a row (r * ns >= N).  Time is staged
    `t_tile` steps at a time; `smem` is the block's shared memory in bytes.
    With `chunks` > 1 the grid has a third axis of chunks of `chunk` steps
    (chunk-parallel: each chunk from a zero state, then a carry between
    chunks and a pass that adds what the carried states give); else
    `chunk` covers L.  `blocks` counts the first pass's blocks."""
    rt: int
    ns: int
    r: int
    rows: int
    row_tiles: int
    threads: int
    t_tile: int
    smem: int
    blocks: int
    chunk: int = 0
    chunks: int = 1

    def as_dict(self) -> dict:
        return asdict(self)


def ring_smem(rt: int, ns: int, r: int, rows: int, row_tiles: int, p: int, n: int,
              t: int, dtypes) -> int:
    """Shared memory of one block, as `layout_of` in csrc/ssm_scan.cu lays it
    out: the rows' partial dot products [2][t][r][rows + pad] f32, then two
    slots of b and c [t][r*ns] in their dtype, x [t][p or rows] in its own,
    and a [t] f32."""
    ex = _esize(dtypes[0])
    ebc = max(_esize(dtypes[1]), _esize(dtypes[2]))     # mixed b, c go as f32
    npad = r * ns
    xp = p if row_tiles == 1 else rows
    ypitch = rows + max(4, 32 // r)
    slot = _align16(2 * _align16(t * npad * ebc) + _align16(t * xp * ex) + 4 * t)
    return 2 * 4 * t * r * ypitch + 2 * slot


@functools.lru_cache(maxsize=None)     # a pure function of its arguments, asked every call
def ssm_plan(bh: int, groups: int, l: int, p: int, n: int,
             dtypes=("bf16", "bf16", "bf16"), *, rt: int | None = None,
             ns: int | None = None, t_tile: int | None = None,
             chunk: int | None = None) -> SSMPlan:
    """The plan for x (bh, l, p), b and c (groups, l, n); `dtypes` are those
    of x, b and c ("bf16" or "f32").  `rt`, `ns`, `t_tile` and `chunk` (0:
    none) override the rule (for the plan sweep and forced-plan checks).

    Rule (from `tools/torch_ssm_plan_sweep.py` on the card): chunks of 512
    steps, run in parallel, where L is at least four chunks and the state
    at most 2^19 entries (zamba2 at 4096 tokens: chunking won at batch 1
    and 2, lost at 4, 8 and 16); the grid's size below counts the chunks.  16 entries of
    each of 4 rows a thread (128 registers) where the grid is wide: each b
    and c value a thread reads serves four rows.  One row a thread, 8
    entries of it, where there are fewer blocks than SMs or P < 4.  One
    head a block: blocks of 2 or 4 heads sharing a staged b/c tile ran
    slower.  The time tile: the longest that still lets the whole grid run
    in one wave, else the longest whose shared memory lets the registers'
    number of blocks share an SM."""
    if min(bh, groups, l, p, n) < 1 or bh % groups or n > MAX_N:
        raise ValueError(f"ssm_plan: no plan for bh={bh} groups={groups} l={l} p={p} n={n}")
    if chunk is None:
        chunk = CHUNK if l >= 4 * CHUNK and bh * p * n <= CHUNKED_STATE else 0
    nc = -(-l // chunk) if chunk else 1
    rt_rule = rt is None
    if ns is None:
        ns = 4 if n <= 4 else 8 if rt == 1 or p < 4 else 16
    if rt is None:
        rt = 1 if p < 4 or ns < 16 else 4
    if (rt, ns) not in RING_VARIANTS:
        raise ValueError(f"ssm_plan: (rt, ns) = {(rt, ns)} is not instantiated")
    r = _pow2(-(-n // ns))
    if r > 32:
        raise ValueError(f"ssm_plan: N={n} needs more than 32 threads a row at ns={ns}")
    rows = min(rt * THREADS // r, max(rt, _pow2(p)))
    while r * (rows // rt) < 32:       # whole warps: idle rows past P
        rows *= 2
    threads = r * (rows // rt)
    row_tiles = -(-p // rows)
    blocks = bh * row_tiles * nc
    resident = max(1, min(65536 // (128 * threads), 32))      # blocks an SM, by registers

    def fits(t: int, want: int) -> bool:
        smem = ring_smem(rt, ns, r, rows, row_tiles, p, n, t, dtypes)
        return smem <= SMEM_PER_BLOCK and want * (smem + 1024) <= SMEM_PER_SM

    if t_tile:
        t = t_tile
    else:
        one_wave = [t for t in T_TILES
                    if any(fits(t, k) and k * SMS >= blocks for k in range(1, resident + 1))]
        t = one_wave[0] if one_wave else next(
            (t for t in T_TILES if fits(t, resident)), T_TILES[-1])
    smem = ring_smem(rt, ns, r, rows, row_tiles, p, n, t, dtypes)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"ssm_plan: {smem} bytes of shared memory at bh={bh} p={p} n={n}")
    if rt_rule and rt > 1 and blocks < SMS:      # too few blocks: one row a thread
        return ssm_plan(bh, groups, l, p, n, dtypes, rt=1, t_tile=t_tile, chunk=chunk)
    return SSMPlan(rt=rt, ns=ns, r=r, rows=rows, row_tiles=row_tiles,
                   threads=threads, t_tile=t, smem=smem, blocks=blocks,
                   chunk=chunk if chunk else -(-l // t) * t, chunks=nc)


def _dtype_name(t: torch.Tensor) -> str:
    return "bf16" if t.dtype == torch.bfloat16 else "f32"


def _entry():
    fn = _build.library().ssm_scan_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
    return fn


def launch(x, a, b, c, y, plan: SSMPlan, scratch=(None, None)) -> int:
    """Launch `ssm_scan_kernel_ring` on `plan` into `y`; returns the CUDA
    error code.  b and c share one dtype; `scratch` is `chunk_scratch`'s
    pair for a chunked plan.  Checks nothing and counts nothing: `ssm_scan`
    does both."""
    bh, l, p = x.shape
    lg = lambda v: v.bit_length() - 1   # noqa: E731  (powers of two)
    bf16 = torch.bfloat16
    with torch.cuda.device(x.device):
        return _entry()(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                        bh, b.shape[0], l, p, b.shape[2], int(x.dtype == bf16),
                        int(b.dtype == bf16), plan.rt, plan.ns,
                        lg(plan.r), lg(plan.rows // plan.rt), plan.t_tile,
                        plan.chunk, *(t.data_ptr() if t is not None else None for t in scratch),
                        torch.cuda.current_stream(x.device).cuda_stream)


def chunk_scratch(x: torch.Tensor, n: int, plan: SSMPlan):
    """(states (BH, chunks, P, N), decay products (BH, L)) f32 for a chunked
    plan, (None, None) otherwise."""
    if plan.chunks == 1:
        return None, None
    bh, l, p = x.shape
    return (torch.empty((bh, plan.chunks, p, n), dtype=torch.float32, device=x.device),
            torch.empty((bh, l), dtype=torch.float32, device=x.device))


def expand_groups(t: torch.Tensor, bh: int) -> torch.Tensor:
    """b or c (G, L, N) repeated per head to (BH, L, N), the reference's layout.
    An expand, not `repeat_interleave`: the same values, and its gradient is
    a sum over each group's heads, where `repeat_interleave`'s adds them with
    atomics on the card, in no fixed order."""
    if t.shape[0] == bh:
        return t
    g = t.shape[0]
    return t[:, None].expand(g, bh // g, *t.shape[1:]).reshape(bh, *t.shape[1:])


def check_shapes(x, a, b, c) -> None:
    if x.ndim != 3 or a.ndim != 2 or b.ndim != 3 or c.shape != b.shape:
        raise ValueError(f"ssm_scan: bad shapes x{tuple(x.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)} c{tuple(c.shape)}")
    bh, l, _ = x.shape
    g = b.shape[0]
    if tuple(a.shape) != (bh, l) or b.shape[1] != l or g < 1 or bh % g:
        raise ValueError(f"ssm_scan: x{tuple(x.shape)}, a{tuple(a.shape)} and "
                         f"b{tuple(b.shape)} do not match")


def ssm_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The scan over any length L >= 1; see the module docstring for shapes."""
    check_shapes(x, a, b, c)
    bh, l, p = x.shape
    g, n = b.shape[0], b.shape[2]
    if a.dtype != torch.float32:
        raise TypeError(f"ssm_scan: a must be float32, got {a.dtype}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"ssm_scan: {name} must be float32 or bfloat16, got {t.dtype}")
    if not (x.device == a.device == b.device == c.device):
        raise ValueError("ssm_scan: x, a, b and c lie on different devices")
    if x.device.type == "cpu":
        return ref.ssm_scan_ref(x, a, expand_groups(b, bh), expand_groups(c, bh))
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {x.device}")
    if min(bh, l, p, n) < 1 or n > MAX_N:
        raise ValueError(f"ssm_scan: the kernel takes 1 <= N <= {MAX_N} and non-empty "
                         f"x, got x{tuple(x.shape)} N={n}")
    if not all(t.is_contiguous() for t in (x, a, b, c)):
        raise ValueError("ssm_scan: x, a, b and c must be contiguous")
    plan = ssm_plan(bh, g, l, p, n, tuple(_dtype_name(t) for t in (x, b, c)))
    if b.dtype != c.dtype:      # the kernel reads b and c in one dtype
        b, c = b.float(), c.float()
    y = torch.empty((bh, l, p), dtype=torch.float32, device=x.device)
    _build.check_launch(launch(x, a, b, c, y, plan, chunk_scratch(x, n, plan)), "ssm_scan")
    ssm_scan.launches += 1
    return y


ssm_scan.launches = 0
