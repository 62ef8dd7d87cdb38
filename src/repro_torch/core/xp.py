"""Array namespaces for the analytic engine's columnar kernels.

The topology kernels, the planner and the fault algebra are written once
against an `xp` namespace, as in the JAX package: `numpy` itself for the
scalar and host path, and `TorchNS(device)` for the batched engine on a
device.  torch is not numpy-compatible in the places these kernels touch
(`torch.maximum(1.0, t)` needs tensor arguments, `torch.frexp` returns an
int32 exponent, a Python scalar has no device), so `TorchNS` supplies the
numpy spelling: scalars become float64 tensors on its device, and every
tensor it makes is float64 whatever `torch.get_default_dtype()` says.

Two functions are exact by construction on both namespaces and every
device: `pow2` (2**e for integral e, built from the exponent bits) and
`pow10` (10**x from IEEE +, *, / and a fixed polynomial).  torch's own
`pow` is not position-independent on the CPU: its vectorised lanes (Sleef)
and its tail lanes (libm) may round differently, so the same element could
come out one ulp apart in a chunk and in the whole grid, and the streaming
engine's bitwise contracts would not hold there.  `pow10` performs the same
correctly rounded operations on every element, so it is bit-identical
across chunkings and between the CPU and the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64

# 10**x = 2**(x * log2(10)); 2**f = exp(f * ln 2) for |f| <= 1/2 by its
# Taylor series to degree 13 (truncation below 1e-17 relative).  log2(10) is
# carried as hi + lo (lo = log2(10) - hi to 1e-33) and x * hi as an exact
# product hi + err by Dekker's splitting, so the argument keeps ~100 bits.
_SPLIT = 134217729.0  # 2**27 + 1: Veltkamp's split into two 26-bit halves


def _split(v: float):
    c = _SPLIT * v
    hi = c - (c - v)
    return hi, v - hi


_LOG2_10 = math.log2(10.0)
_LOG2_10_LO = 1.661617516973592e-16  # log2(10) - _LOG2_10
_LOG2_10_H, _LOG2_10_L = _split(_LOG2_10)
_LN2 = math.log(2.0)
_EXP_COEFFS = tuple(1.0 / math.factorial(k) for k in range(13, -1, -1))


class TorchNS:
    """numpy-like namespace over float64 tensors on one device."""

    def __init__(self, device):
        self.device = torch.device(device)

    def asarray(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v if v.dtype == F64 else v.to(F64)
        if np.ndim(v) == 0:
            # a fill on the device, not a copy from the host: a host copy
            # would wait for the work already queued on the card
            return torch.full((), float(v), dtype=F64, device=self.device)
        return torch.as_tensor(np.asarray(v, np.float64), device=self.device)

    # elementwise -------------------------------------------------------
    def maximum(self, a, b):
        return torch.maximum(self.asarray(a), self.asarray(b))

    def minimum(self, a, b):
        return torch.minimum(self.asarray(a), self.asarray(b))

    def where(self, cond, a, b):
        return torch.where(cond, self.asarray(a), self.asarray(b))

    def clip(self, x, lo, hi):
        # minimum(maximum(.)) rather than torch.clamp: the same values, and
        # the gradient at a bound splits as numpy-style max/min does (half)
        return torch.minimum(torch.maximum(self.asarray(x), self.asarray(lo)),
                             self.asarray(hi))

    def ceil(self, x):
        return torch.ceil(self.asarray(x))

    def floor(self, x):
        return torch.floor(self.asarray(x))

    def round(self, x):
        return torch.round(self.asarray(x))

    def sqrt(self, x):
        return torch.sqrt(self.asarray(x))

    def log2(self, x):
        return torch.log2(self.asarray(x))

    def frexp(self, x):
        """(mantissa, exponent) with the exponent widened to float64."""
        m, e = torch.frexp(self.asarray(x))
        return m, e.to(F64)

    def detach(self, x):
        return self.asarray(x).detach()

    # construction ------------------------------------------------------
    def full_like(self, x, v):
        return torch.full_like(x, v, dtype=F64)

    def ones_like(self, x):
        return torch.ones_like(x, dtype=F64)

    def broadcast_to(self, x, shape):
        return torch.broadcast_to(self.asarray(x), tuple(shape))

    # exact powers ------------------------------------------------------
    def pow2(self, e):
        """2**e for integral float64 e in [-1022, 1023], exactly: the
        exponent field is written directly.  Piecewise constant, so it
        carries no gradient, as 2**round(.) carries none."""
        bits = (self.asarray(e).detach().to(torch.int64) + 1023) << 52
        return bits.view(F64)

    def pow10(self, x):
        """10**x in float64 from correctly rounded operations only (see the
        module docstring); within about one ulp of the exact value, with the
        gradient 10**x * ln(10) (the correction term is below an ulp of t
        and carries none)."""
        x = self.asarray(x)
        t = x * _LOG2_10
        # t + err = x * log2(10) to ~100 bits: Dekker's exact product error
        # of x * _LOG2_10, plus x times the constant's own rounding error
        xs, ts = x.detach(), t.detach()
        c = xs * _SPLIT
        xh = c - (c - xs)
        xl = xs - xh
        err = (((xh * _LOG2_10_H - ts) + xh * _LOG2_10_L + xl * _LOG2_10_H)
               + xl * _LOG2_10_L) + xs * _LOG2_10_LO
        n = torch.round(ts)
        z = ((t - n) + err) * _LN2
        p = torch.full_like(z, _EXP_COEFFS[0])
        for c in _EXP_COEFFS[1:]:
            p = p * z + c
        big = n > 1023
        out = p * self.pow2(torch.clamp(n, -1022.0, 1023.0))
        out = torch.where(n < -1022, torch.zeros_like(out), out)
        return torch.where(big, torch.full_like(out, math.inf), out)


def pow2(xp, e):
    """2**e for integral e on either namespace, exact."""
    return 2.0 ** e if xp is np else xp.pow2(e)
