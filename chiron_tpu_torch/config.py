"""Run configuration dataclasses for workload scripts (port of
``chiron_tpu/config.py``).

The library is configured by constructor arguments, as the reference chiron
is; this small dataclass layer serves the example and benchmark scripts,
with the JAX package's fields and defaults.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class LangevinConfig:
    timestep_fs: float = 2.0
    collision_rate_per_ps: float = 1.0
    temperature_K: float = 300.0
    n_steps: int = 1000
    report_interval: int = 100
    seed: int = 1234


@dataclass
class LJFluidConfig:
    n_particles: int = 1000
    reduced_density: float = 0.1
    sigma_nm: float = 0.34
    epsilon_kcal_mol: float = 0.238
    cutoff_factor: float = 3.0
    mass_amu: float = 39.948


@dataclass
class NeighborConfig:
    skin_nm: float = 0.5
    n_max_neighbors: int = 180


@dataclass
class RunConfig:
    """Top-level config for the benchmark/example workloads."""

    system: LJFluidConfig = field(default_factory=LJFluidConfig)
    dynamics: LangevinConfig = field(default_factory=LangevinConfig)
    neighbors: NeighborConfig = field(default_factory=NeighborConfig)
    use_dense_kernel: bool = True
    output_dir: Optional[str] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "RunConfig":
        raw = json.loads(text)
        return cls(
            system=LJFluidConfig(**raw.get("system", {})),
            dynamics=LangevinConfig(**raw.get("dynamics", {})),
            neighbors=NeighborConfig(**raw.get("neighbors", {})),
            use_dense_kernel=raw.get("use_dense_kernel", True),
            output_dir=raw.get("output_dir"),
        )

    @classmethod
    def from_file(cls, path: str) -> "RunConfig":
        with open(path) as fh:
            return cls.from_json(fh.read())
