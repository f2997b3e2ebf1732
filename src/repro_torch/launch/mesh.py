"""Mesh constructors, as ``repro/launch/mesh.py``: functions, never
module-level constants, so importing this module touches no process
group and no device.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group.  The production meshes need a world of at
least 256 or 512 ranks (a fake one for the dry run, ``launch/dryrun.py``),
as the reference's need 256 or 512 devices; ``make_host_mesh`` covers the
world that exists, and brings up a world of one in process (a
``HashStore``, no ``MASTER_ADDR``) when there is none.
"""
from __future__ import annotations

import torch.distributed as dist


def _mesh(device_type: str, shape: tuple[int, ...], names: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 ``("data", "model")`` or 2x16x16 ``("pod", "data",
    "model")`` over the first 256 or 512 ranks of the default process
    group (as the reference's takes the first devices).  Raises
    RuntimeError in a smaller world."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(f"the production mesh {shape} needs a world of "
                           f"{need} ranks; this one has {have}")
    return DeviceMesh(device_type, torch.arange(need).view(shape),
                      mesh_dim_names=axes)


def _ensure_world(device_type: str) -> int:
    """The default process group's size, after bringing up a world of one
    rank in process when there is none (gloo for the CPU, NCCL for the
    card)."""
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_world_size()


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """``(world // model, model)`` ``("data", "model")`` over the world
    that exists — for tests and local runs."""
    n = _ensure_world(device_type)
    if n % model:
        raise ValueError(f"model axis {model} does not divide {n} ranks")
    return _mesh(device_type, (n // model, model), ("data", "model"))
