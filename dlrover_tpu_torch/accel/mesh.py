"""Device mesh of the port — counterpart of ``dlrover_tpu/accel/mesh.py``.

The JAX package lays its devices out as one ``jax.sharding.Mesh`` whose
axes are named in ``AXIS_ORDER``; on CPU or odd topologies the layout is
a plain reshape of the device list (``mesh.py:83-95``). The port builds a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names, in
the same order, over ranks laid out by that same plain reshape, so rank
``r`` holds the block that JAX device ``r`` holds. An axis may have size
1 (a world of one card still has the axis, and its branch runs).

Each process drives one device: ``cuda:LOCAL_RANK`` under NCCL, or the
CPU under gloo when the caller names it. ``init_process_group`` reads
torchrun's launch contract (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``).
"""

import os
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.log import logger

# Outermost (slowest link) to innermost (fastest): the JAX package's order.
AXIS_ORDER = ("data", "fsdp", "pipe", "seq", "expert", "tensor")


@dataclass
class MeshConfig:
    """Named axes with sizes; -1 means "absorb the remaining ranks"."""

    axes: List[Tuple[str, int]] = field(default_factory=list)

    def resolved(self, n_devices: int) -> List[Tuple[str, int]]:
        sizes = dict(self.axes)
        known = 1
        wildcard = None
        for name, size in self.axes:
            if size == -1:
                if wildcard is not None:
                    raise ValueError("at most one axis may be -1")
                wildcard = name
            else:
                known *= size
        if wildcard is not None:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by {known}"
                )
            sizes[wildcard] = n_devices // known
            known *= sizes[wildcard]
        if known != n_devices:
            raise ValueError(
                f"mesh axes {dict(self.axes)} use {known} devices, have "
                f"{n_devices}"
            )
        return [(name, sizes[name]) for name, _ in self.axes]


def _canonical_order(axes: Sequence[Tuple[str, int]]) -> List[Tuple[str, int]]:
    known = [a for a in axes if a[0] in AXIS_ORDER]
    extra = [a for a in axes if a[0] not in AXIS_ORDER]
    return sorted(known, key=lambda a: AXIS_ORDER.index(a[0])) + extra


def init_process_group(device: torch.device) -> None:
    """Join the job's process group, once: NCCL for a card, gloo for the
    CPU, from torchrun's environment (``env://``). A group that exists
    must use that backend: a card never runs over gloo."""
    want = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise RuntimeError(
                f"the process group runs {have}, but {device} needs {want}")
        return
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        if name not in os.environ:
            raise RuntimeError(
                f"{name} is not set: start the workers with torchrun, or "
                "set RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT")
    kwargs = {"device_id": device} if device.type == "cuda" else {}
    dist.init_process_group(
        want, init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]), **kwargs)
    logger.info("process group: %s, rank %s of %s", want, dist.get_rank(),
                dist.get_world_size())


def create_mesh(axes: Sequence[Tuple[str, int]], device: torch.device,
                reorder: bool = True):
    """A ``DeviceMesh`` over every rank of the process group, with the
    named ``(axis, size)`` dims (one size may be -1). ``reorder=True``
    puts the axes in ``AXIS_ORDER`` whatever the argument's order. The
    ranks are ``arange(world)`` reshaped to the axes' sizes, as the JAX
    package reshapes its device list."""
    from torch.distributed.device_mesh import DeviceMesh

    init_process_group(device)
    world = dist.get_world_size()
    resolved = MeshConfig(list(axes)).resolved(world)
    if reorder:
        resolved = _canonical_order(resolved)
    names = tuple(n for n, _ in resolved)
    shape = tuple(s for _, s in resolved)
    mesh = DeviceMesh(device.type, torch.arange(world).reshape(shape),
                      mesh_dim_names=names)
    logger.info("created mesh %s", dict(zip(names, shape)))
    return mesh


def axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a mesh, in its order."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
