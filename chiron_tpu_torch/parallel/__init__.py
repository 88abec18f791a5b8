"""Multi-device execution for chiron_tpu_torch (port of
``chiron_tpu/parallel``).

* :mod:`.distributed` -- ``initialize_cluster``: the ``torch.distributed``
  process group (NCCL on the card, gloo on the CPU), one process a device.
* :mod:`.mesh` -- ``make_replica_mesh``: the 1-D mesh over that group (or
  this process alone); ``replica_sharding`` and ``replicated_sharding``:
  which block of a replica axis a process holds.
* :mod:`.tempering` -- ``ParallelTemperingSampler``: the replicas stacked on
  a leading axis, a process's block propagated by one chain with the
  temperature as data (on the dense path one launch of K1 over the block a
  step), U all-gathered, swaps on the host.
* :mod:`.multistate` -- ``MeshMultiStateSampler``: replica exchange with a
  potential family's parameters stacked as data and the replicas batched.
* :mod:`.spatial` -- particle-axis sharding: the row-sharded pair kernel
  (``make_sharded_lj_force``), the dense spatial Langevin runner
  (``make_spatial_lj_runner``, one positions all-gather a step) and the
  banded one for large N (``make_spatial_band_lj_runner``).
"""

from . import distributed
from .mesh import Mesh, make_replica_mesh, replica_sharding, replicated_sharding
from .multistate import MeshMultiStateSampler
from .spatial import (make_sharded_lj_force, make_spatial_band_lj_runner,
                      make_spatial_lj_runner)
from .tempering import ParallelTemperingSampler

__all__ = [
    "distributed",
    "Mesh",
    "make_replica_mesh",
    "replica_sharding",
    "replicated_sharding",
    "MeshMultiStateSampler",
    "ParallelTemperingSampler",
    "make_sharded_lj_force",
    "make_spatial_lj_runner",
    "make_spatial_band_lj_runner",
]
