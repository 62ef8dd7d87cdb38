"""TRINE-inspired collective schedules over a device mesh, and their byte
model.

The paper's interposer insight mapped to mesh collectives (the JAX
package's `parallel/collectives.py`, where each schedule is a shard_map
program; here each is a sequence of `torch.distributed` collectives on the
process groups of a `DeviceMesh`'s named dimensions, NCCL on the card and
gloo on the CPU).  Each rank's local tensor takes the place of the
reference's replicated input, and each rank returns the whole result:

  * `flat_all_reduce`: one all-reduce over the (pod, data) ranks that share
    a `model` index: the bus analog, a ring through every device;
  * `trine_all_reduce`: reduce-scatter inside the pod (`data`), all-reduce
    across pods (`pod`), all-gather back inside the pod: the slow axis is
    crossed once, by a 1/data share of the bytes (TRINE's 2-stage tree);
  * `compressed_all_reduce`: the same with the cross-pod stage at int8
    (each pod's levels and per-chunk f32 scales gathered on `pod`,
    dequantized and summed locally) and an error-feedback residual;
  * `_quantize_int8` / `_dequantize_int8`: that stage's symmetric int8
    quantization with per-chunk max-abs scales;
  * `all_gather`: a group's tensors stacked on a new leading axis (the
    schedules' last stage);
  * `gather_shards` / `reduce_to_shard`: the sharded train step's pair for
    one leaf (`runtime.trainer`): a DTensor's local shard all-gathered
    whole, and the gradient of that whole turned straight into the
    rank's gradient shard (reduce-scatter on the batch axes the leaf is
    sharded on, all-reduce on those it is not, the rank's slice on its
    other shard axes): over (pod, data) for a leaf sharded on `data`,
    TRINE's reduce-scatter and cross-pod all-reduce without the last
    all-gather;
  * `collective_bytes_estimate`: per-device total and cross-pod bytes of
    each schedule, op for op as the schedules issue them, on a mesh's
    geometry alone (`MeshGeometry`: the benches price meshes that no
    process holds; `mesh_axis_sizes` and `has_pod_axis` read either);
  * `plan_channels`: the bandwidth-matching planner for collective
    chunking (`core.planner.plan_collective_channels`).
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.planner import plan_collective_channels as plan_channels  # noqa: F401 (re-export)

__all__ = ["MeshGeometry", "mesh_axis_sizes", "has_pod_axis", "all_gather", "gather_shards",
           "reduce_to_shard", "flat_all_reduce", "trine_all_reduce", "compressed_all_reduce",
           "collective_bytes_estimate", "plan_channels"]


class MeshGeometry:
    """A mesh's axis names and shape, without devices: what
    `collective_bytes_estimate` and the sharding rules read of a mesh."""

    def __init__(self, shape, names=("pod", "data", "model")):
        self.axis_names = tuple(names)
        self.devices = SimpleNamespace(shape=tuple(shape))


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh` or a `MeshGeometry`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def has_pod_axis(mesh) -> bool:
    return "pod" in mesh_axis_sizes(mesh)


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
    # a divisor on the device: CUDA turns division by a host scalar into a
    # product with its reciprocal, which may round the scale differently
    qmax = torch.full((), 127.0, dtype=blocks.dtype, device=v.device)
    scale = (torch.amax(torch.abs(blocks), dim=1).clamp_min(1e-20) / qmax).to(torch.float32)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of `_quantize_int8`: (n_chunks, chunk) int8 x (n_chunks,)
    scales -> the first `n` dequantized f32 elements."""
    return (q.to(torch.float32) * scale[:, None]).reshape(-1)[:n]


# the tensor forms of all-gather and reduce-scatter, under their newer
# names where this torch has them
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)


def _axis_group(mesh, axes: Sequence[str]):
    """The process group of this rank's ranks along `axes` of a
    `DeviceMesh` (several axes: their flattened group, made once on every
    rank)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The group's `x`s stacked on a new leading axis, in group-rank order."""
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _ALL_GATHER(out, x.contiguous(), group=group)
    return out.view((n,) + tuple(x.shape))


def _reduce_scatter(flat: torch.Tensor, group) -> torch.Tensor:
    """This rank's tile of the group's sum of `flat` (a length divisible by
    the group's size), tiles in group-rank order."""
    out = torch.empty(flat.shape[0] // dist.get_world_size(group), dtype=flat.dtype,
                      device=flat.device)
    _REDUCE_SCATTER(out, flat.contiguous(), group=group)
    return out


def gather_shards(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The full tensor of which `x` is this rank's shard, laid out as the
    DTensor `placements` over `mesh` (a collective: every rank of the mesh
    calls it).  All-gathered along each sharded mesh dimension, the
    innermost first, which undoes DTensor's nested (major-first) split; a
    dimension of size 1 holds the whole, so at one rank the result is `x`
    itself (no copy)."""
    for i in reversed(range(mesh.ndim)):
        p = placements[i]
        if p.is_shard() and mesh.size(i) > 1:
            x = torch.cat(tuple(all_gather(x, mesh.get_group(i))), dim=p.dim)
    return x


def _reduce_scatter_axis(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """This rank's block (kept as a size-1 axis) of the group's sum of `x`
    along `axis`, whose length is the group's size."""
    moved = x.movedim(axis, 0)
    piece = _reduce_scatter(moved.reshape(-1), group)
    return piece.view((1,) + tuple(moved.shape[1:])).movedim(0, axis)


def reduce_to_shard(g: torch.Tensor, mesh, placements, batch_axes: Optional[Sequence[str]],
                    share: float = 1.0) -> torch.Tensor:
    """`g`, this rank's gradient of the full tensor `gather_shards` made
    from its shard, as the rank's gradient shard of the batch's sum: `g`
    times `share` (the rank's share of the tokens), summed over the ranks of
    the mesh dimensions named in `batch_axes` and cut to the rank's block
    on the others (their ranks hold the same batch shard).

    A tensor dimension sharded on mesh dimensions i < j < ... is viewed as
    (size_i, size_j, ..., rest), so each mesh dimension owns one axis of
    the view.  The cuts come first (no communication); then, innermost mesh
    dimension first, a reduce-scatter on each batch dimension the leaf is
    sharded on and an all-reduce on each it is not (the scaling comes
    between, on the cut tensor).  So the slow `pod`
    axis is crossed last, by the smallest tensor, and the blocks land as
    DTensor's pod-major split lays them out.  Size-1 mesh dimensions are
    skipped: at one rank the result is a view of `g` (times `share`)."""
    names = mesh.mesh_dim_names
    batch = set(batch_axes or ())
    coord = mesh.get_coordinate()
    on_dim: dict = {}                      # tensor dimension -> its mesh dimensions
    for i, p in enumerate(placements):
        if p.is_shard():
            on_dim.setdefault(p.dim, []).append(i)
    view, axis_of, local = [], {}, []
    for d, n in enumerate(g.shape):
        blocks = [mesh.size(i) for i in on_dim.get(d, ())]
        for i in on_dim.get(d, ()):
            axis_of[i] = len(view)
            view.append(mesh.size(i))
        view.append(n // math.prod(blocks))
        local.append(n // math.prod(blocks))
    g = g.reshape(view)
    for i in axis_of:
        if names[i] not in batch and mesh.size(i) > 1:
            g = g.narrow(axis_of[i], coord[i], 1)
    if share != 1:
        g = g * share
    for i in reversed(range(mesh.ndim)):
        if names[i] not in batch or mesh.size(i) == 1:
            continue
        if i in axis_of:
            g = _reduce_scatter_axis(g, mesh.get_group(i), axis_of[i])
        else:
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=mesh.get_group(i))
    return g.reshape(local)


def flat_all_reduce(x: torch.Tensor, mesh, axes: Sequence[str] = ("pod", "data")) -> torch.Tensor:
    """Baseline: one all-reduce (sum) over every rank of `axes` that the
    mesh has (the bus-topology analog).  Returns a new tensor."""
    axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
    if not axes:
        return x.clone()
    return _all_reduce(x, _axis_group(mesh, axes))


def trine_all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """Hierarchical: reduce-scatter on `data`, all-reduce on `pod`,
    all-gather on `data`, the flattened tensor zero-padded to a multiple of
    the data size.  Cross-pod bytes drop by the data-axis size against the
    flat schedule.  Without a `pod` axis: `flat_all_reduce` over `data`."""
    if "pod" not in mesh.mesh_dim_names:
        return flat_all_reduce(x, mesh, axes=("data",))
    data = mesh.get_group("data")
    flat, orig = _pad_to(x.reshape(-1), dist.get_world_size(data))
    piece = _reduce_scatter(flat, data)
    dist.all_reduce(piece, group=mesh.get_group("pod"))
    full = all_gather(piece, data).reshape(-1)
    return full[:orig].reshape(x.shape)


def compressed_all_reduce(x: torch.Tensor, mesh, residual: Optional[torch.Tensor] = None,
                          chunk_elems: Optional[int] = None):
    """Hierarchical all-reduce with int8 compression on the cross-pod stage
    and error feedback.  Returns (result, new_residual).

    Inside the pod it runs at full precision (fast links); only the pod
    stage carries 8-bit payloads: each pod's int8 shard and its per-chunk
    f32 scales are all-gathered on `pod` and dequantized and summed
    locally (an int8 sum would overflow, and an f32 one would put full-width
    bytes on the slow link).  `chunk_elems` sets the quantization
    granularity (None: one scale per shard).  The local quantization error
    is gathered back as the residual, to be fed into the next call (EF-SGD).
    On a mesh without `pod` nothing is quantized: the residual is folded
    into the payload and drained."""
    if residual is None:
        residual = torch.zeros_like(x)
    if "pod" not in mesh.mesh_dim_names:
        return flat_all_reduce(x + residual, mesh, axes=("data",)), torch.zeros_like(x)
    data = mesh.get_group("data")
    flat, orig = _pad_to((x + residual).reshape(-1), dist.get_world_size(data))
    piece = _reduce_scatter(flat, data)
    q, scale = _quantize_int8(piece, chunk_elems)
    new_res = piece - _dequantize_int8(q, scale, piece.shape[0])
    pod = mesh.get_group("pod")
    qg, sg = all_gather(q, pod), all_gather(scale, pod)
    deq = qg.to(torch.float32) * sg[:, :, None]
    summed = torch.sum(deq.reshape(deq.shape[0], -1)[:, :piece.shape[0]], dim=0)
    full = all_gather(summed, data).reshape(-1)
    res_full = all_gather(new_res, data).reshape(-1)
    return full[:orig].reshape(x.shape), res_full[:orig].reshape(x.shape)


def collective_bytes_estimate(n_elems: int, dtype_bytes: int, mesh, schedule: str,
                              chunk_elems: Optional[int] = None) -> dict:
    """Napkin-math model: bytes per device, in all and across the slow (pod)
    links, of the gradient all-reduce under each schedule ("flat", "trine",
    "trine_int8"), with the ring-algorithm factors and padding of the
    schedules above (for "trine_int8", the residual all-gather and the
    per-chunk f32 scales too).  `mesh` is a `DeviceMesh` or anything with
    `axis_names` and `devices.shape` (a `MeshGeometry` will do).
    `chunk_elems` must be the compressed all-reduce's (None = one global
    scale per shard)."""
    sizes = mesh_axis_sizes(mesh)
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
