"""Meshes, the port of ``repro.launch.mesh``. Functions, never
module-level constants: importing this module touches no device and no
process group.

A ``DeviceMesh`` spans the ranks of the default process group, one
device each, so the production meshes need a world of 256 or 512 ranks
(``torchrun``, or the fake process group in the tests).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.dist.sharding import abstract_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: 16x16 = 256 devices (data, model). Multi-pod: 2 pods =
    512 devices with a leading 'pod' axis (cross-pod data parallelism, or
    pod-level prefill/decode disaggregation per DESIGN.md section 5)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, device_type: str = "cuda"):
    """What this process has: one device per rank of the default process
    group, as a ``DeviceMesh`` (data, model). A process with no process
    group has one device, and gets the one-device mesh (1, 1) as an
    ``AbstractMesh`` naming ``device_type``: it needs no group."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = n // model_axis
    if data < 1 or data * model_axis != n:
        raise ValueError(f"model_axis {model_axis} does not divide the "
                         f"{n} devices of this process group")
    if not dist.is_initialized():
        return abstract_mesh((data, model_axis), ("data", "model"),
                             device_type)
    return init_device_mesh(device_type, (data, model_axis),
                            mesh_dim_names=("data", "model"))
