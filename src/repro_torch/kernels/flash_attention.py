"""Flash attention forward: online softmax over KV tiles with GQA, causal and
sliding-window masks and a query offset.

  q (B, Hq, Sq, D) ; k, v (B, Hk, Sk, D), bf16/f32  ->  out (B, Hq, Sq, D) f32

`flash_attention` launches a CUDA kernel of `csrc/flash_attention.cu` for
CUDA tensors and takes the plain version (`ref.attention_ref`) only for CPU
tensors.  The inputs may be strided views (the model hands over transposed
(B,S,H,D) projections); only the last dimension must be contiguous.
`flash_attention.launches` counts kernel launches.  Which kernel, and on
what plan, is `dispatch`'s answer: bf16 inputs with D = 64 or 128, 16-byte
aligned storage and strides that are multiples of 8 go to the tensor-core
kernel `attn_kernel_sm90` in the grid order `attn_plan` gives; everything
else to the f32 FMA kernel `attn_kernel`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128)   # head sizes the FMA kernel is instantiated for
SM90_HEAD_DIMS = (64, 128)      # head sizes of the tensor-core kernel
BQ = 64    # query rows per block of `attn_kernel_sm90`: one warpgroup
BKV = 64   # keys per KV tile (128 at D = 64 needs more than 255 registers a thread)


def attn_skip(sq: int, sk: int, causal: bool, window: int, q_offset: int) -> bool:
    """True when there is a mask and KV tiles outside its band may be
    skipped: only if no query row is masked everywhere (such a row averages
    V over all keys; see the note in csrc/flash_attention.cu).  Row q_offset
    + i sees keys from q_offset + i - window + 1 (with a window) up to
    itself (causal) or Sk - 1, so the last row, and with it some row, sees
    none exactly when a window ends before key 0 .. Sk - 1 do:
    q_offset + Sq >= Sk + window."""
    if not (causal or window > 0):
        return False
    return not (window > 0 and q_offset + sq >= sk + window)


@dataclass(frozen=True)
class AttnPlan:
    """Launch plan of `attn_kernel_sm90`: a 1-D grid of `blocks` =
    B * Hq * `q_tiles` blocks of BQ query rows, each looping over KV tiles
    of BKV keys.  With `heavy_first` the grid runs the query tiles in
    decreasing order (the last query tile, which visits the most KV tiles
    of a causal mask, first), each over all (batch, head) pairs; otherwise
    the query tiles of one (batch, head) are neighbours.  With `skip`, a
    block visits only the KV tiles that meet its rows' band."""
    q_tiles: int
    blocks: int
    heavy_first: bool
    skip: bool

    def as_dict(self) -> dict:
        return {"bq": BQ, "bkv": BKV, "q_tiles": self.q_tiles, "blocks": self.blocks,
                "heavy_first": self.heavy_first, "skip": self.skip}


def attn_plan(b: int, hq: int, hk: int, sq: int, sk: int, d: int, causal: bool = True,
              window: int = 0, q_offset: int = 0) -> AttnPlan:
    """The plan of `attn_kernel_sm90` for these shapes and this mask.

    Query tiles are 64 rows at every shape: two or three such blocks share
    an SM and overlap one another's softmax and products, which two
    warpgroups of one 128-row block, held together by its barriers, did not
    (slower at all six timed prefills; `PERF.md` has the readings).  A
    causal mask makes the last query tiles the longest, so with tile
    skipping and more than two query tiles they run first.  With two (the
    batch-128 prefills of 128 tokens) the imbalance is small, and keeping a
    head's query tiles together lets its K and V be read from L2 the second
    time."""
    if d not in SM90_HEAD_DIMS or min(b, hq, hk, sq, sk) <= 0 or hq % hk:
        raise ValueError(f"attn_plan: no plan for b={b} hq={hq} hk={hk} sq={sq} sk={sk} d={d}")
    skip = attn_skip(sq, sk, causal, window, q_offset)
    q_tiles = -(-sq // BQ)
    return AttnPlan(q_tiles=q_tiles, blocks=b * hq * q_tiles,
                    heavy_first=bool(causal and skip and q_tiles > 2), skip=skip)


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def dispatch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tensor_cores: bool = True, *,
             causal: bool = True, window: int = 0, q_offset: int = 0):
    """("attn_kernel_sm90", plan) when the tensor-core kernel takes these
    inputs (bf16, D = 64 or 128, storage 16-byte aligned and the batch,
    head and sequence strides multiples of 8, `tensor_cores`), else
    ("attn_kernel", None), the f32 FMA kernel."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if (tensor_cores and q.dtype == torch.bfloat16 and d in SM90_HEAD_DIMS
            and _aligned(q) and _aligned(k) and _aligned(v)):
        return "attn_kernel_sm90", attn_plan(b, hq, hk, sq, sk, d, causal, window, q_offset)
    return "attn_kernel", None


def _entry(name: str, n_int: int):
    fn = getattr(_build.library(), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
                       + [ctypes.c_int] * n_int + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch_sm90(q, k, v, out, scale: float, causal: bool, window: int, q_offset: int,
                 plan: AttnPlan) -> int:
    """Launch `attn_kernel_sm90` on `plan` into `out`; returns the CUDA error
    code.  Checks nothing and counts nothing: `flash_attention` does both."""
    b, hq, sq, d = q.shape
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    with torch.cuda.device(q.device):
        return _entry("flash_attention_sm90_launch", 5)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, k.shape[1], sq, k.shape[2], d, strides, scale, int(causal), int(window),
            int(q_offset), int(plan.skip), int(plan.heavy_first),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, scale=None,
                    q_offset: int = 0, tensor_cores: bool = True) -> torch.Tensor:
    """GQA when Hq > Hk.  `q_offset` is the absolute position of q[..., 0, :]
    (queries that sit at the end of a longer key sequence).

    bf16 inputs with D = 64 or 128 go to the tensor-core kernel when their
    strides are multiples of 8 elements and their storage is 16-byte
    aligned, else to the f32 FMA kernel, which f32 inputs always take;
    `tensor_cores=False` keeps bf16 on the FMA kernel as well (`dispatch`)."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    bk_, hk, sk, dk = k.shape
    if bk_ != b or dk != d or hq % hk:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} and k{tuple(k.shape)} do not match")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("flash_attention: q, k, v must share one dtype, float32 or bfloat16")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v lie on different devices")
    scale = float(scale) if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                                 q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the last dimension of q, k, v must be contiguous")
    out = torch.empty((b, hq, sq, d), dtype=torch.float32, device=q.device)
    kernel, plan = dispatch(q, k, v, tensor_cores, causal=causal, window=window,
                            q_offset=q_offset)
    if plan is not None:
        err = _launch_sm90(q, k, v, out, scale, causal, window, q_offset, plan)
    else:
        strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
        with torch.cuda.device(q.device):
            err = _entry("flash_attention_launch", 5)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, hq, hk, sq, sk, d, strides, scale, int(causal), int(window),
                int(q_offset), int(attn_skip(sq, sk, causal, window, q_offset)),
                int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(err, f"flash_attention ({kernel})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
