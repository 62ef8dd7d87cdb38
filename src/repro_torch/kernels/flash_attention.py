"""Flash attention forward: online softmax over KV tiles with GQA, causal and
sliding-window masks and a query offset.

  q (B, Hq, Sq, D) ; k, v (B, Hk, Sk, D), bf16/f32  ->  out (B, Hq, Sq, D) f32

`flash_attention` launches the CUDA kernel of `csrc/flash_attention.cu` for
CUDA tensors and takes the plain version (`ref.attention_ref`) only for CPU
tensors.  The inputs may be strided views (the model hands over transposed
(B,S,H,D) projections); only the last dimension must be contiguous.
`flash_attention.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128)   # head sizes the CUDA kernel is instantiated for


def _entry():
    fn = _build.library().flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, scale=None,
                    q_offset: int = 0, tensor_cores: bool = True) -> torch.Tensor:
    """GQA when Hq > Hk.  `q_offset` is the absolute position of q[..., 0, :]
    (queries that sit at the end of a longer key sequence).

    bf16 inputs go to the tensor-core kernel when their strides are multiples
    of 8 elements and their storage is 16-byte aligned, else to the f32 FMA
    kernel, which f32 inputs always take; `tensor_cores=False` keeps bf16 on
    the FMA kernel as well."""
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
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    # KV tiles outside the mask's band may be skipped only if no query row is
    # masked everywhere (see the note in csrc/flash_attention.cu)
    skip = int((causal or window > 0) and q_offset + sq <= sk)
    out = torch.empty((b, hq, sq, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                       b, hq, hk, sq, sk, d, strides, scale, int(causal), int(window),
                       int(q_offset), skip, int(q.dtype == torch.bfloat16), int(tensor_cores),
                       torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
