"""Production mesh construction, the PyTorch counterpart of
``repro/launch/mesh.py``: the reference's mesh shapes (256 devices a
pod, 2 pods) as ``torch.distributed`` ``DeviceMesh``es.

FUNCTIONS (not module-level constants) so importing this module never
touches a process group: the caller initializes one of the mesh's size
first (NCCL or gloo across processes, or the dry-run's fake group of 256
or 512 ranks in one process), and the mesh takes its device type.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    backend = str(dist.get_backend()).lower()
    return "cuda" if "nccl" in backend else "cpu"


def _mesh(shape, names) -> DeviceMesh:
    need = 1
    for n in shape:
        need *= n
    if not dist.is_initialized() or dist.get_world_size() != need:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of "
            f"world size {need}; this one has {have}")
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_debug_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """Tiny mesh over the process group's ranks (tests)."""
    return _mesh((data, model), ("data", "model"))
