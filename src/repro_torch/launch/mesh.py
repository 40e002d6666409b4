"""Production meshes on ``torch.distributed``.  Functions, not module
constants: importing this module touches no distributed state.

A mesh needs an initialised default process group of the mesh's size
(NCCL on the card, ``gloo`` on the CPU, the ``"fake"`` backend for the
dry run: :mod:`repro_torch.launch.dryrun`); these functions say so when
it is missing and never start one themselves.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _world(need: int | None) -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs an initialised process group: call "
            "torch.distributed.init_process_group (backend, rank, world "
            "size, init_method) first")
    world = dist.get_world_size()
    if need is not None and world != need:
        raise RuntimeError(f"this mesh takes {need} ranks; the process "
                           f"group has {world}")
    return world


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; the "pod" axis is
    the slow boundary between pods: the async-local replica axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _world(2 * 16 * 16 if multi_pod else 16 * 16)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int | None = None,
                   device_type: str = "cuda") -> DeviceMesh:
    """(data, model) over the whole world: ``model`` ranks (1 unless
    given) to a model replica."""
    n = _world(None)
    model = model or 1
    if n % model:
        raise ValueError(f"model={model} does not divide the world of {n}")
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))
