"""Device meshes over `torch.distributed` (counterpart of
`repro.launch.mesh`).

Defined as FUNCTIONS (never module-level constants), so importing this
module touches no process group.  Each builds a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the process
group the caller has initialised (`torch.distributed.init_process_group`,
given its address, world size and rank), with the reference's dimension
names: a rank is a card, as a JAX device is a chip.  Every rank of the
world calls them, as `init_device_mesh` requires; a mesh smaller than
the world takes the first ranks, and the others get no coordinate in it.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from repro_torch.device import resolve


def _world() -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def _mk(shape: Tuple[int, ...], axes: Sequence[str], device):
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    world = _world()
    if n > world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh over {tuple(axes)} needs {n} "
                         f"ranks, and the world has {world}")
    dev = resolve(device)
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: Union[str, torch.device] = "cuda"):
    """16x16 over ("data", "model") (256 ranks), or 2x16x16 over ("pod",
    "data", "model") (512); raises where the world has fewer ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device)


def make_dev_mesh(data: int = 1, model: int = 1, device: Union[str, torch.device] = "cuda"):
    """A small ("data", "model") mesh over whatever ranks exist (tests,
    one card): `data` clamped to the world size, `model` to what is left."""
    n = _world()
    data = min(data, n)
    model = max(1, min(model, n // data))
    return _mk((data, model), ("data", "model"), device)


def mesh_sizes(mesh) -> dict:
    """The mesh's size along each named dimension."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def dp_size(mesh) -> int:
    """Data-parallel width: the `data` dimension times the `pod` one."""
    s = mesh_sizes(mesh)
    return s.get("data", 1) * s.get("pod", 1)
