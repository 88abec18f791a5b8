"""The 1-D device mesh (port of ``chiron_tpu/parallel/mesh.py``).

Where the JAX package holds a ``jax.sharding.Mesh`` of devices, a process of
the port drives one device, and the mesh is the ``torch.distributed`` group
of the processes: its axis name, the group (None when this process runs
alone), this process's rank, the group's size and this process's device.

A sharding says which part of an array's leading axis this process holds:
``replica_sharding`` its contiguous block (``NamedSharding(mesh,
P("replica"))``: block ``rank`` of ``size`` equal blocks), and
``replicated_sharding`` the whole axis (``NamedSharding(mesh, P())``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """One axis of processes, one device each.  With ``group`` None the
    mesh is this process alone and nothing runs a collective."""

    axis_name: str
    group: Optional[object]
    rank: int
    size: int
    device: torch.device


def make_replica_mesh(n_devices: Optional[int] = None,
                      axis_name: str = "replica", *, device="cuda") -> Mesh:
    """A 1-D mesh over the default process group when ``torch.distributed``
    is initialised (``n_devices``, if given, must be its size), otherwise
    this process alone (``n_devices`` None or 1).  ``device`` is this
    process's device: the card unless the caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} devices needs torch.distributed with "
                "one process a device (see parallel.distributed)"
            )
        return Mesh(axis_name, None, 0, 1, device)
    size = dist.get_world_size()
    if n_devices not in (None, size):
        raise ValueError(
            f"n_devices={n_devices}, but the process group has {size} "
            "processes (one device each)"
        )
    return Mesh(axis_name, dist.group.WORLD, dist.get_rank(), size, device)


@dataclass(frozen=True)
class Sharding:
    """How a leading axis lies on ``mesh``: split into ``mesh.size`` equal
    contiguous blocks, block ``rank`` on this process (``replicated``
    False), or whole on every process."""

    mesh: Mesh
    replicated: bool = False

    def local_slice(self, length: int) -> slice:
        """This process's part of an axis of ``length``; a split axis must
        divide by the mesh size."""
        if self.replicated:
            return slice(0, length)
        size, rank = self.mesh.size, self.mesh.rank
        if length % size != 0:
            raise ValueError(
                f"an axis of {length} does not split over a mesh of {size}"
            )
        per = length // size
        return slice(rank * per, (rank + 1) * per)


def replica_sharding(mesh: Mesh, axis_name: Optional[str] = None) -> Sharding:
    """The sharding that splits the leading (replica) axis over the mesh.
    ``axis_name``, if given, must be the mesh's."""
    if axis_name is not None and axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not "
                         f"{axis_name!r}")
    return Sharding(mesh)


def replicated_sharding(mesh: Mesh) -> Sharding:
    """The sharding that keeps the whole array on every process."""
    return Sharding(mesh, replicated=True)
