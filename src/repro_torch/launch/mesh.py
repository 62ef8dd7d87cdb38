"""Device meshes over `torch.distributed`.

The counterpart of the JAX package's `launch/mesh.py`.  A mesh here is a
`torch.distributed.device_mesh.DeviceMesh` with named dimensions; building
one needs a process group whose world size is the mesh's size.  This module
sets up no process group itself: its caller does (`torchrun`, which sets
the rendezvous variables, then `torch.distributed.init_process_group`; or a
test harness with a `file://` rendezvous).  A world size that does not
match raises, as `jax.make_mesh` does without the devices, so
`make_production_mesh` needs 256 ranks, or 512 with `multi_pod`.

Mesh semantics:
  pod    the cross-pod axis (slow links): TRINE's "subnetwork" axis, which
         the hierarchical collectives cross once;
  data   the intra-pod FSDP/data-parallel axis (the memory-chiplet axis:
         parameters live sharded here, gradients are reduced here);
  model  the tensor-parallel axis (compute chiplets).

`device_type` defaults to "cuda" (NCCL); "cpu" (gloo) is used only when
the caller asks.  `mesh_axis_sizes` and `has_pod_axis` (re-exported from
`parallel.collectives`) also read a `MeshGeometry`, a mesh's shape without
a process group.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.parallel.collectives import has_pod_axis, mesh_axis_sizes  # noqa: F401 (re-export)

__all__ = ["make_production_mesh", "make_test_mesh", "mesh_axis_sizes", "has_pod_axis"]


def _make(shape, names, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of {math.prod(shape)} ranks: "
                           f"run under torchrun, or call torch.distributed.init_process_group "
                           f"first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """(data 16, model 16), or (pod 2, data 16, model 16) with `multi_pod`."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, names, device_type)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0, device_type: str = "cuda"):
    """A small mesh: (pod, data, model) when `pod`, else (data, model)."""
    if pod:
        return _make((pod, data, model), ("pod", "data", "model"), device_type)
    return _make((data, model), ("data", "model"), device_type)
