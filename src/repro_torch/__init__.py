"""PyTorch + CUDA (NVIDIA Hopper) port of the `repro` package.

Same sub-package and file names as the JAX package, so a reader finds each
counterpart.  This package imports `torch` and never `jax` or `repro`.

Every entry point takes an explicit `device` that defaults to ``"cuda"`` and
raises when there is no card; the CPU is used only when the caller asks for it
(`device="cpu"`), as the parity tests do.  f32 matrix products run in full f32
(`torch.backends.cuda.matmul.allow_tf32` is set False here, which is also
PyTorch's default), because the reference multiplies with
`Precision.HIGHEST`.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False


def require_device(device) -> torch.device:
    """Resolve `device` and raise if it names a card this process cannot
    reach.  There is no fallback: a caller who wants the CPU says so."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU")
    return dev
