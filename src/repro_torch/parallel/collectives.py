"""The TRINE-inspired collectives' one-device parts: the int8 chunk
quantizer of the compressed all-reduce and the byte model of every
schedule.

The JAX package's `parallel/collectives.py` runs three all-reduce schedules
as shard_map programs over a device mesh: `flat_all_reduce` (one stage over
every device, the bus analog), `trine_all_reduce` (reduce-scatter inside
the pod, all-reduce across pods, all-gather back: the slow axis crossed
once) and `compressed_all_reduce` (the cross-pod stage at int8 with
per-chunk scales and an error-feedback residual).  Those schedules need
several devices and are not ported (ROADMAP.md, Queue 1 item 8).  This
module carries what one device runs and what prices them:

  * `_quantize_int8` / `_dequantize_int8`: the cross-pod stage's
    symmetric int8 quantization with per-chunk max-abs scales, on the
    tensor's own device;
  * `collective_bytes_estimate`: per-device total and cross-pod bytes of
    each schedule, op for op as the shard_map programs issue them, on a
    mesh's geometry alone (`MeshGeometry`: the benches price meshes that no
    process holds);
  * `plan_channels`: the bandwidth-matching planner for collective
    chunking (`core.planner.plan_collective_channels`).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch

from repro_torch.core.planner import plan_collective_channels as plan_channels  # noqa: F401 (re-export)

__all__ = ["MeshGeometry", "collective_bytes_estimate", "plan_channels"]


def _pad_to(x: torch.Tensor, mult: int):
    """`x` zero-padded on its first axis to a multiple of `mult`, and the
    original length."""
    n = x.shape[0]
    pad = (-n) % mult
    if pad:
        x = torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                                      device=x.device)])
    return x, n


def _quantize_int8(v: torch.Tensor, chunk_elems: Optional[int] = None):
    """Symmetric int8 quantization of a 1-D tensor with per-chunk max-abs
    scales.  `chunk_elems=None` degenerates to one global scale (a single
    chunk spanning the tensor).

    Returns (q, scale): q is (n_chunks, chunk_elems) int8 (v zero-padded up
    to a chunk multiple), scale is (n_chunks,) f32.  Per-chunk scales keep
    an outlier from widening every other chunk's step, at a wire cost of
    one f32 per chunk."""
    n = v.shape[0]
    chunk = n if chunk_elems is None else max(1, min(int(chunk_elems), n))
    vp, _ = _pad_to(v, chunk)
    blocks = vp.reshape(-1, chunk)
    scale = (torch.amax(torch.abs(blocks), dim=1).clamp_min(1e-20) / 127.0).to(torch.float32)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of `_quantize_int8`: (n_chunks, chunk) int8 x (n_chunks,)
    scales -> the first `n` dequantized f32 elements."""
    return (q.to(torch.float32) * scale[:, None]).reshape(-1)[:n]


class MeshGeometry:
    """A mesh's axis names and shape, without devices: what
    `collective_bytes_estimate` reads of a mesh."""

    def __init__(self, shape, names=("pod", "data", "model")):
        self.axis_names = tuple(names)
        self.devices = SimpleNamespace(shape=tuple(shape))


def collective_bytes_estimate(n_elems: int, dtype_bytes: int, mesh, schedule: str,
                              chunk_elems: Optional[int] = None) -> dict:
    """Napkin-math model: bytes per device, in all and across the slow (pod)
    links, of the gradient all-reduce under each schedule ("flat", "trine",
    "trine_int8"), with the ring-algorithm factors and padding of the
    shard_map programs (for "trine_int8", the residual all-gather and the
    per-chunk f32 scales too).  `mesh` is anything with `axis_names` and
    `devices.shape` (a `MeshGeometry` will do).  `chunk_elems` must be
    the compressed all-reduce's (None = one global scale per shard)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n_pod = sizes.get("pod", 1)
    n_data = sizes.get("data", 1)
    total = n_elems * dtype_bytes
    if schedule == "flat":
        n = n_pod * n_data
        ring = 2 * (n - 1) / n * total
        # a flat ring crosses pod boundaries ~ (n_pod-1)/n_pod of its hops
        cross = ring * (n_pod - 1) / max(n_pod, 1)
        return {"total_bytes": ring, "cross_pod_bytes": cross}
    if schedule == "trine":
        rs = (n_data - 1) / n_data * total
        ar = 2 * (n_pod - 1) / n_pod * (total / n_data)
        ag = (n_data - 1) / n_data * total
        return {"total_bytes": rs + ar + ag, "cross_pod_bytes": ar}
    if schedule == "trine_int8":
        shard = -(-n_elems // n_data)          # the program pads to a data multiple
        padded = shard * n_data * dtype_bytes
        chunk = shard if chunk_elems is None else max(1, min(int(chunk_elems), shard))
        n_chunks = -(-shard // chunk)
        rs = (n_data - 1) / n_data * padded
        # cross-pod all-gathers: int8 shard + f32 per-chunk scales
        q_ag = (n_pod - 1) * n_chunks * chunk * 1
        scale_ag = (n_pod - 1) * n_chunks * 4
        # intra-pod all-gathers: the f32 result and the f32 error-feedback
        # residual, both gathered back to full shape
        ag = 2 * (n_data - 1) / n_data * padded
        cross = q_ag + scale_ag
        return {"total_bytes": rs + cross + ag, "cross_pod_bytes": cross}
    raise ValueError(schedule)
