"""Meshes over ``torch.distributed`` ranks. Twin of ``repro.launch.mesh``.

FUNCTIONS, not module constants: importing this module never touches the
process group. A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with the reference's axis names and shapes: single pod = (data=16,
model=16), multi-pod adds a leading ``pod`` axis (2 pods = 512 ranks). One
rank holds one device, so a mesh of N devices needs a process group of N
ranks: :func:`ensure_process_group` joins the launcher's (``torchrun``) or
starts a one-rank group in the process. The dry run
(``launch.dryrun``) builds the production meshes over a fake process group
of 256 or 512 ranks in one process, which touches no device.

Every builder takes an explicit ``device``: ``None`` is the card (it raises
without one), ``"cpu"`` the CPU (the ``gloo`` backend).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Union

import torch

from repro_torch.device import resolve_device

__all__ = [
    "make_production_mesh",
    "make_debug_mesh",
    "make_worker_mesh",
    "ensure_process_group",
    "HardwareSpec",
    "V5E",
]

DeviceLike = Optional[Union[str, torch.device]]
AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """A chip's peak rates. :data:`V5E` describes the reference's TPU
    target, kept as the reference exports it; nothing in the port reads
    it, and its numbers are not the port's hardware."""

    name: str
    peak_bf16_tflops: float      # per chip
    hbm_gbps: float              # per chip
    ici_link_gbps: float         # per link
    hbm_gib: float


V5E = HardwareSpec(
    name="tpu-v5e", peak_bf16_tflops=197.0, hbm_gbps=819.0,
    ici_link_gbps=50.0, hbm_gib=16.0,
)


def ensure_process_group(device: DeviceLike = None,
                         world_size: Optional[int] = None) -> int:
    """Join or start the default process group; returns its world size.

    An initialized group is kept. Else the launcher's environment
    (``torchrun`` sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) is joined. With no launcher a one-rank group starts in
    the process over a ``HashStore``, so nothing listens on a port:
    ``nccl`` on the card, ``gloo`` on the CPU. On the card each rank binds
    ``cuda:LOCAL_RANK``. A ``world_size`` that the group does not have
    raises ``ValueError``.
    """
    import torch.distributed as dist

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dev.index or 0)))
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    have = dist.get_world_size()
    if world_size is not None and world_size != have:
        raise ValueError(f"the mesh needs {world_size} ranks, the process group has {have} "
                         f"(start it with torchrun --nproc-per-node {world_size})")
    return have


def _mesh(device: torch.device, shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    ensure_process_group(device, math.prod(shape))
    return init_device_mesh(device.type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None):
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return _mesh(resolve_device(device), shape, POD_AXES if multi_pod else AXES)


def make_debug_mesh(data: int = 1, model: int = 1, *, device: DeviceLike = None):
    """A small (data, model) mesh over the process group's ranks (tests,
    the training driver)."""
    return _mesh(resolve_device(device), (data, model), AXES)


def make_worker_mesh(n_workers: int, *, device: DeviceLike = None):
    """Mesh for a sharded worker axis of ``n_workers`` logical workers.

    The ``data`` axis takes gcd(n_workers, world size): each rank runs an
    integer number of local workers. With one rank this is data = 1 (the
    whole worker axis runs on it), so the same program runs everywhere. A
    world size that the gcd does not fill raises (a worker mesh spans every
    rank)."""
    import torch.distributed as dist

    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    data = math.gcd(n_workers, world)
    return _mesh(dev, (data, 1), AXES)
