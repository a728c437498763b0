"""Process groups and device meshes.

Port of ``repro/launch/mesh.py``. Torch runs one process per rank: every
mesh is a ``DeviceMesh`` over the default process group's world, built
by a function (never a module constant), so importing this module starts
no process group. A mesh asked for without a process group raises
``NoProcessGroupError``; it never becomes a one-rank group or the CPU.

Layouts: one pod ``(data=16, model=16)``, 256 ranks; two pods ``(pod=2,
data=16, model=16)``, 512 ranks. ``model`` carries TP / EP / decode
sequence parallelism, ``data`` FSDP and batch parallelism, ``pod`` pure
data parallelism. The elastic mesh derives pod x data from the live world
size with ``model`` fixed, so a relaunch on fewer ranks re-derives every
sharding from the mesh shape.

``init_distributed`` starts the default group from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): ``nccl`` for ``cuda`` (each rank on card
``LOCAL_RANK``), ``gloo`` for ``cpu``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from ..distributed.sharding import (NoProcessGroupError, device_mesh,
                                    world_size)

__all__ = ["NoProcessGroupError", "device_mesh", "elastic_mesh_shape",
           "free_port", "init_distributed", "make_debug_mesh",
           "make_elastic_mesh", "make_production_mesh"]


def init_distributed(device_type: str = "cuda") -> Tuple[int, int]:
    """Start the default process group from torchrun's environment and set
    this rank's device; returns ``(rank, world_size)``. A group already
    started is kept (its backend must suit ``device_type``)."""
    import torch
    import torch.distributed as dist

    if device_type not in ("cuda", "cpu"):
        raise ValueError(
            f"device_type must be 'cuda' or 'cpu'; got {device_type!r}")
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if not dist.is_initialized() and missing:
        raise NoProcessGroupError(
            f"init_distributed reads torchrun's environment, but {missing} "
            "are not set: launch with torchrun, or set RANK, WORLD_SIZE, "
            "MASTER_ADDR and MASTER_PORT")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed('cuda') but torch.cuda.is_available() is "
                "False; pass device_type='cpu' for gloo ranks on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        dist.init_process_group(
            backend="nccl" if device_type == "cuda" else "gloo",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_rank(), dist.get_world_size()


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now, for ``MASTER_PORT`` or a
    ``tcp://127.0.0.1:<port>`` init method of ranks on this machine."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return device_mesh(device_type, shape, names)


def elastic_mesh_shape(n_devices: int,
                       model_parallel: int = 16) -> Tuple[int, int, int]:
    """(pods, data, model) for ``n_devices`` live ranks.

    Pure shape arithmetic, testable at any count. The data-parallel
    product dp = n / model splits into pods x data aiming at ~16 data
    shards a pod: pods is the largest divisor of dp not above max(dp //
    16, 1), so pods * data * model == n_devices for every divisible
    count. Raises ``ValueError`` when ``model_parallel`` does not divide
    the count: an elastic relaunch shrinks the data dims, never the TP
    dim, from which the parameter shardings derive.
    """
    if n_devices <= 0:
        raise ValueError(
            f"elastic mesh needs at least one device (got {n_devices})")
    if n_devices % model_parallel:
        raise ValueError(
            f"elastic mesh: device count {n_devices} is not a multiple "
            f"of model_parallel={model_parallel} — the TP axis is fixed "
            "across relaunches (parameter shardings derive from it); "
            "adjust model_parallel or the device reservation")
    dp = n_devices // model_parallel
    pods = max(dp // 16, 1)
    while dp % pods:            # keep pods a divisor: pods*data == dp
        pods -= 1
    return pods, dp // pods, model_parallel


def make_elastic_mesh(world: Optional[int] = None, model_parallel: int = 16,
                      device_type: str = "cuda"):
    """A ``(pod, data, model)`` mesh over the live world (``world``
    defaults to the process group's size, and must equal it), pod x data
    derived from the count (``elastic_mesh_shape``, whose ``ValueError``
    it raises)."""
    n = world_size("make_elastic_mesh") if world is None else world
    shape = elastic_mesh_shape(n, model_parallel)
    return device_mesh(device_type, shape, ("pod", "data", "model"))


def make_debug_mesh(n_data: int = 1, n_model: int = 1,
                    device_type: str = "cpu"):
    """A small ``(data, model)`` mesh for tests (``n_data * n_model``
    ranks)."""
    return device_mesh(device_type, (n_data, n_model), ("data", "model"))
