"""Device meshes over the ranks of the default process group.

The counterpart of `flasht5_tpu/parallel/mesh.py`: a ("data", "tensor")
mesh with "tensor" innermost, so that tensor-parallel partners are
neighbouring ranks (the cards of one host, on NVLink), and the pipeline's
("pipe", "data") mesh (JAX pp_step.py:44-46). Each is a
`torch.distributed.device_mesh.DeviceMesh`, one process group per
dimension.

The model takes the groups of its collectives from the current mesh
(`use_mesh`), by the dimension `config.tp_axis` names, where the JAX model
reads the axis of the enclosing `shard_map`.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

_CURRENT = []


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the default process group: call "
                           "parallel.distributed.initialize_multihost() "
                           "(or torch.distributed.init_process_group) first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape, names) -> DeviceMesh:
    device_type = _device_type()
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {n} ranks; "
                         f"the process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_mesh(data: int = 1, tensor: int = 1) -> DeviceMesh:
    """The (data, tensor) mesh over every rank; tensor innermost."""
    return _mesh((data, tensor), ("data", "tensor"))


def make_pp_mesh(pipe: int, data: int = 1) -> DeviceMesh:
    """The (pipe, data) mesh of the pipeline step; data innermost."""
    return _mesh((pipe, data), ("pipe", "data"))


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh):
    """Make `mesh` the current mesh inside the block."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh() -> Optional[DeviceMesh]:
    return _CURRENT[-1] if _CURRENT else None


def axis_group(name: str, mesh: Optional[DeviceMesh] = None):
    """The process group of mesh dimension `name` (of the current mesh by
    default); raises where there is none."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        raise RuntimeError(f"no current mesh with a {name!r} dimension: run "
                           f"the model inside parallel.mesh.use_mesh(mesh)")
    return mesh.get_group(name)
