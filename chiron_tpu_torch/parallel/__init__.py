"""Multi-device execution for chiron_tpu_torch (port of
``chiron_tpu/parallel``).

* :mod:`.distributed` -- ``initialize_cluster``: the ``torch.distributed``
  process group (NCCL on the card, gloo on the CPU), one process a device.
* :mod:`.mesh` -- ``make_replica_mesh``: the 1-D mesh over that group (or
  this process alone).
* :mod:`.spatial` -- particle-axis sharding: the row-sharded pair kernel
  (``make_sharded_lj_force``), the dense spatial Langevin runner
  (``make_spatial_lj_runner``, one positions all-gather a step) and the
  banded one for large N (``make_spatial_band_lj_runner``).

Parallel tempering and the mesh multistate sampler are not ported yet.
"""

from . import distributed
from .mesh import Mesh, make_replica_mesh
from .spatial import (make_sharded_lj_force, make_spatial_band_lj_runner,
                      make_spatial_lj_runner)

__all__ = [
    "distributed",
    "Mesh",
    "make_replica_mesh",
    "make_sharded_lj_force",
    "make_spatial_lj_runner",
    "make_spatial_band_lj_runner",
]
