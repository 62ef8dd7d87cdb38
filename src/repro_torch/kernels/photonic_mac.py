"""Photonic MAC: the paper's broadcast-and-weight numerics as a quantized
matmul, `out = x @ (w_q * per-tile scale)`.

Each 128x128 weight tile is one MR weight bank whose dynamic range is set by
its own tuning: int8 levels with one f32 scale per tile.  Activations stay
bf16/f32 and the sum is f32 (the photodetector's analog accumulation).

  x        (M, K)   bf16/f32 activations
  w_q      (K, N)   int8 levels
  w_scale  (ceil(K/128), ceil(N/128)) f32 per-tile scales
  out      (M, N)   f32

`photonic_mac` launches the CUDA kernel of `csrc/photonic_mac.cu` for a CUDA
tensor and takes the plain version (`ref.photonic_mac_ref`) only for a CPU
tensor.  `photonic_mac.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

BANK = 128   # weight-bank tile edge; the CUDA kernel is written for this value


def quantize_weights(w: torch.Tensor, bits: int = 8, bk: int = BANK, bn: int = BANK):
    """Per-(bk x bn)-tile symmetric quantization: one scale per MR weight
    bank, range set by the bank's own max |w|.

    Non-aligned weights quantize on the zero-padded ceil grid (padding is
    exact zero, so it never widens a bank's range; an all-zero tile gets the
    epsilon scale) and `w_q` is sliced back to (K, N).  `w_scale` comes back
    f32 (ceil(K/bk), ceil(N/bn)), what `photonic_mac` expects."""
    k, n = w.shape
    kp, np_ = -(-k // bk) * bk, -(-n // bn) * bn
    if (kp, np_) != (k, n):
        w = torch.nn.functional.pad(w, (0, np_ - n, 0, kp - k))
    tiles = w.reshape(kp // bk, bk, np_ // bn, bn)
    qmax = 2 ** (bits - 1) - 1
    # max |w| per tile in one pass (the inf-norm), (ceil(k/bk), ceil(n/bn))
    absmax = torch.linalg.vector_norm(tiles, ord=float("inf"), dim=(1, 3))
    scale = absmax.clamp_min(1e-8) / qmax
    w_q = (tiles / scale[:, None, :, None]).round_().clamp_(-qmax, qmax).to(torch.int8)
    return w_q.reshape(kp, np_)[:k, :n].contiguous(), scale.to(torch.float32)


def _entry():
    fn = _build.library().photonic_mac_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def photonic_mac(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, *,
                 tensor_cores: bool = True) -> torch.Tensor:
    """Quantized-weight matmul; shapes need not be tile-aligned (the kernel
    masks ragged edges).  Rows are bit-identical whatever M is.

    bf16 activations go to the tensor-core kernel when K % 8 == 0 and
    N % 16 == 0, else to the f32 FMA kernel, which f32 activations always
    take; `tensor_cores=False` keeps bf16 on the FMA kernel as well."""
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
    with torch.cuda.device(x.device):
        err = _entry()(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
                       m, k, n, int(x.dtype == torch.bfloat16), int(tensor_cores),
                       torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "photonic_mac")
    photonic_mac.launches += 1
    return out


photonic_mac.launches = 0
