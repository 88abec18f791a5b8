"""chiron_tpu_torch: the PyTorch and CUDA port of chiron-tpu.

The JAX package ``chiron_tpu`` is the reference; this package mirrors its
file layout (each module here has one counterpart there) and runs its main
path -- the LJ-fluid NVT workload of ``bench.py`` -- and NpT on an NVIDIA
Hopper card through hand-written CUDA kernels (``csrc/``, built on first use
by ``ops/_build.py``).  Every kernel wrapper runs its plain PyTorch version for
a tensor on the CPU, which is how the CPU tests compare the two packages.

This package imports ``torch`` and numpy only, never jax or ``chiron_tpu``.
"""

__version__ = "0.1.0"

from . import units
from .topology import Topology


def __getattr__(name):
    # lazy submodules keep `import chiron_tpu_torch` free of torch imports
    import importlib

    submodules = {
        "integrators", "interop", "ops", "oracles", "parallel", "potential",
        "runtime", "testsystems",
    }
    if name in submodules:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["units", "Topology", "__version__"]
