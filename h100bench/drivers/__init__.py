"""One module a kind of traffic (the traffic file's ``kind``), each with a
``Sim`` that sets the program up from a configuration and a traffic file
and runs one frame at a time, and a ``judge_segments`` that holds what the
frames produced to the plain reference."""

from __future__ import annotations

import numpy as np


def lj_objects(fluid):
    """The program's potential, topology and (3, 3) box for ``fluid``."""
    from chiron_tpu_torch import units
    from chiron_tpu_torch.potential import LJPotential
    from chiron_tpu_torch.topology import Topology

    topology = Topology.uniform(fluid.n, fluid.lng.mass)
    potential = LJPotential(
        topology, sigma=fluid.lj.sigma * units.nanometer,
        epsilon=fluid.lj.epsilon * units.kilojoule_per_mole,
        cutoff=fluid.lj.cutoff * units.nanometer)
    box = np.eye(3, dtype=np.float32) * np.float32(fluid.box)
    return potential, topology, box
