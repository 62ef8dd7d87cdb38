"""Selective state-space scan (Mamba2 / SSD recurrence) for the zamba2 hybrid
and the xLSTM mLSTM blocks.

Per batch*head, with a scalar decay per step and a (P x N) matrix state:

    S_t = a_t * S_{t-1} + x_t (outer) b_t          y_t = S_t c_t

  x  (BH, L, P)   bf16/f32
  a  (BH, L)      f32
  b  (BH, L, N)   bf16/f32
  c  (BH, L, N)   bf16/f32      ->  y (BH, L, P) f32

x, b and c may each be bf16 or f32 (mLSTM's normaliser has f32 x with bf16
b and c); the scan is computed in f32 from their values.

`ssm_scan` launches the CUDA kernel of `csrc/ssm_scan.cu` for CUDA tensors
and takes the plain version (`ref.ssm_scan_ref`, the sequential oracle) only
for CPU tensors.  `ssm_scan.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

MAX_N = 512     # state width the CUDA kernel takes (32 threads of 16 entries per row)


def _entry():
    fn = _build.library().ssm_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ssm_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The scan over any length L >= 1; see the module docstring for shapes."""
    if x.ndim != 3 or a.ndim != 2 or b.ndim != 3 or c.shape != b.shape:
        raise ValueError(f"ssm_scan: bad shapes x{tuple(x.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)} c{tuple(c.shape)}")
    bh, l, p = x.shape
    n = b.shape[2]
    if tuple(a.shape) != (bh, l) or tuple(b.shape[:2]) != (bh, l):
        raise ValueError(f"ssm_scan: x{tuple(x.shape)}, a{tuple(a.shape)} and "
                         f"b{tuple(b.shape)} do not match")
    if a.dtype != torch.float32:
        raise TypeError(f"ssm_scan: a must be float32, got {a.dtype}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"ssm_scan: {name} must be float32 or bfloat16, got {t.dtype}")
    if not (x.device == a.device == b.device == c.device):
        raise ValueError("ssm_scan: x, a, b and c lie on different devices")
    if x.device.type == "cpu":
        return ref.ssm_scan_ref(x, a, b, c)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {x.device}")
    if min(bh, l, p, n) < 1 or n > MAX_N:
        raise ValueError(f"ssm_scan: the kernel takes 1 <= N <= {MAX_N} and non-empty "
                         f"x, got x{tuple(x.shape)} N={n}")
    if not all(t.is_contiguous() for t in (x, a, b, c)):
        raise ValueError("ssm_scan: x, a, b and c must be contiguous")
    y = torch.empty((bh, l, p), dtype=torch.float32, device=x.device)
    bf16 = torch.bfloat16
    with torch.cuda.device(x.device):
        err = _entry()(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                       bh, l, p, n, int(x.dtype == bf16), int(b.dtype == bf16),
                       int(c.dtype == bf16), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "ssm_scan")
    ssm_scan.launches += 1
    return y


ssm_scan.launches = 0
