"""chiron_tpu_torch: the PyTorch and CUDA port of chiron-tpu.

The JAX package ``chiron_tpu`` is the reference; this package mirrors its
file layout (each module here has one counterpart there) and runs its main
path -- the LJ-fluid NVT workload of ``bench.py`` -- NpT, the general API
(spaces, pair lists, potentials, states, ``LangevinIntegrator``, the
minimizers), the Metropolis moves (``mcmc``), replica exchange
(``multistate``) and MBAR (``analysis``) on an NVIDIA Hopper card through
hand-written CUDA kernels (``csrc/``, built on first use by
``ops/_build.py``).  Every kernel wrapper runs its plain PyTorch version for
a tensor on the CPU, which is how the CPU tests compare the two packages.

This package imports ``torch`` and numpy only, never jax or ``chiron_tpu``.
"""

__version__ = "0.1.0"

from . import units
from .topology import Topology


# the JAX package's top-level names, from modules that import torch
_LAZY_NAMES = {"Space": "space", "OrthogonalPeriodicSpace": "space",
               "OrthogonalNonPeriodicSpace": "space", "PRNG": "utils"}


def __getattr__(name):
    # lazy submodules and names keep `import chiron_tpu_torch` free of torch
    # imports
    import importlib

    if name in _LAZY_NAMES:
        module = importlib.import_module(f".{_LAZY_NAMES[name]}", __name__)
        return getattr(module, name)
    submodules = {
        "analysis", "checkpoint", "config", "integrators", "interop", "io",
        "mcmc", "minimize", "multistate", "native", "neighbors",
        "observables", "ops", "oracles", "parallel", "potential",
        "profiling", "reporters", "runtime", "space", "states",
        "testsystems", "utils",
    }
    if name in submodules:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "units",
    "Space",
    "OrthogonalPeriodicSpace",
    "OrthogonalNonPeriodicSpace",
    "Topology",
    "PRNG",
    "__version__",
]
