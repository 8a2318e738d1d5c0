"""Mesh construction (the port of ``repro.launch.mesh``): DeviceMeshes over
the current process group, with the reference's axis names.

Importing this module touches no device and starts no process group.
``make_local_mesh`` builds the small meshes of tests and the card (starting
a one-rank group itself when there is none); ``make_production_mesh`` builds
the 16x16 and 2x16x16 meshes, which need a group of at least 256 / 512
ranks: the dry run gives them a ``fake`` group (:func:`init_fake_group`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import resolve_device


def _start_single_rank(device_type: str) -> None:
    """A one-rank group on an in-process store: NCCL on ``cuda`` (a failed
    start raises; there is no fallback), gloo on ``cpu``. No port, no
    network."""
    if device_type == "cuda":
        dev = resolve_device("cuda")
        torch.cuda.set_device(dev.index or 0)
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"make_local_mesh: device type {device_type!r}")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device_type: str = "cuda"):
    """A ``("data", "model")`` DeviceMesh over the current process group,
    whose world must be ``data * model`` ranks. With no group yet and a
    world of one, a one-rank group is started first (NCCL on ``cuda``, gloo
    on ``cpu``)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = data * model
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"mesh ({data}, {model}) needs a process group "
                               f"of {n} ranks; none is initialised")
        _start_single_rank(device_type)
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"mesh ({data}, {model}) needs {n} ranks, the "
                           f"process group has {world}")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def init_fake_group(world: int, rank: int = 0) -> None:
    """A ``fake`` process group of ``world`` ranks in this one process (no
    communication happens): enough to build production meshes and their
    placements without the devices."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks a pod; multi-pod adds a leading pod axis (2 pods).

    Axis semantics: ``pod`` = cross-pod DP; ``data`` = in-pod DP + FSDP;
    ``model`` = TP/EP. Raises when the process group has fewer ranks than
    the mesh, as the reference raises with too few devices."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, found {world} — run on a "
            "process group that large (init_fake_group for a dry run)")
    ranks = torch.arange(need).reshape(shape)
    return DeviceMesh("cpu", ranks, mesh_dim_names=axes)
