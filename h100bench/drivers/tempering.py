"""Traffic of the kind ``tempering``: a temperature ladder of one LJ fluid
on the program's ``parallel.tempering.ParallelTemperingSampler``, dense
chain (``initialize(dense=None)``: K1 over replicas).  The ladder is
geometric, ``rungs`` temperatures from the configuration's up by
``ratio``.  A frame is ``run(1, steps_per_frame)``: the steps, the energy
read and the swap sweep.

The judge follows each replica of a captured iteration from the program's
state at its start with the reference's BAOAB, on the stream seeds it
splits from the replicas' keys itself, and compares the positions, the
energies returned, the swap decisions taken on them and the velocities
after the swap.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..reference import lj as ref
from . import lj_objects
from .culled import melt


class Sim:
    kind = "tempering"

    def __init__(self, fluid, config, traffic, seed: int, device):
        from chiron_tpu_torch.parallel.tempering import (
            ParallelTemperingSampler)

        self.fluid, self.traffic, self.seed = fluid, traffic, seed
        self.device = torch.device(device)
        potential, topology, box = lj_objects(fluid)
        positions = melt(fluid, config, potential, topology, box, seed,
                         device)
        positions = torch.as_tensor(positions).cpu().numpy()
        self.chains = traffic["rungs"]
        temps = [fluid.temperature * traffic["ratio"] ** k
                 for k in range(self.chains)]
        self.sampler = ParallelTemperingSampler(
            potential, temps, timestep=fluid.lng.dt,
            collision_rate=fluid.lng.gamma, device=device)
        self.sampler.initialize(positions, box, seed=seed)
        if self.sampler._dense_op is None:
            raise RuntimeError("the sampler did not take the dense chain")
        self.n_pad = self.sampler._dense_op.n_pad
        self.steps_per_frame = traffic["steps_per_frame"]
        self.iteration = 0
        self.steps = 0

    def frame(self, keep=None):
        """One iteration.  Returns (failed, drawn, last): the iteration's
        (start, end) as ``last``, and as ``drawn`` too unless ``keep`` is
        None."""
        s = self.sampler
        start = dict(x=s.positions, v=s.velocities, keys=list(s.keys),
                     kTs=np.asarray(s.kTs, dtype=np.float32).copy())
        try:
            with record_function("iteration"):
                s.run(1, self.steps_per_frame, seed=self.seed)
            failed = False
        except RuntimeError:
            failed = True
        self.iteration += 1
        self.steps += self.steps_per_frame
        end = dict(x=s.positions, v=s.velocities,
                   kTs=np.asarray(s.kTs, dtype=np.float32).copy(),
                   U=np.asarray(s._u_history[-1], dtype=np.float32).copy(),
                   iteration=self.iteration)
        return failed, (None if keep is None else (start, end)), (start, end)

    def end_positions(self, capture):
        """(R, N, 3) positions at a captured iteration's end."""
        return capture[1]["x"][:, :, :self.fluid.n].transpose(1, 2)

    def box(self):
        return torch.full((self.chains, 3), self.fluid.box,
                          dtype=torch.float64, device=self.device)


def judge_segments(sim, captures, control_dtype=None):
    """The numbers that decide ``correct`` over the captured iterations:
    the program's (or, with ``control_dtype``, the reference's in that
    precision) against the float64 reference."""
    f = sim.fluid
    n = f.n
    L = sim.box()
    worst = dict(x_err_nm=0.0, v_err_nm_per_ps=0.0, energy_rel_err=0.0,
                 swap_mismatch=0)
    for start, end in captures:
        x0 = start["x"][:, :, :n].transpose(1, 2).double()
        v0 = start["v"][:, :, :n].transpose(1, 2).double()
        kT0 = start["kTs"]
        _, seeds = ref.propagation_seeds(start["keys"])
        args = (L, f.lj, f.lng, kT0, seeds, 0, sim.steps_per_frame,
                sim.n_pad)
        xr, vr, _, _ = ref.baoab(x0, v0, *args, dtype=torch.float64)
        it = end["iteration"]
        if control_dtype is None:
            xo = end["x"][:, :, :n].transpose(1, 2).double()
            vo = end["v"][:, :, :n].transpose(1, 2).double()
            Uo, kTo = end["U"], end["kTs"]
        else:
            xo, vo, _, Uo = ref.baoab(x0, v0, *args, dtype=control_dtype)
            Uo = Uo.float().cpu().numpy()
            kTo = ref.swap_sweep(kT0, Uo, it, sim.seed)
            xo = xo.double()
            vo = vo.double() * torch.as_tensor(
                np.sqrt(kTo / kT0), dtype=torch.float64,
                device=vo.device).reshape(-1, 1, 1)
        kTr = ref.swap_sweep(kT0, Uo, it, sim.seed)
        scale = torch.as_tensor(np.sqrt(kTr.astype(np.float64) / kT0),
                                device=vr.device).reshape(-1, 1, 1)
        dx = ref.min_image(xo - xr, L[:, None, :]).norm(dim=-1)
        dv = (vo - vr * scale).norm(dim=-1)
        _, Ur = ref.force_energy(xo, L, f.lj,
                                 ref.pair_list(xo, L, f.lj.cutoff + 0.3))
        Ur = Ur.cpu().numpy()
        e_err = np.abs(np.asarray(Uo, dtype=np.float64) - Ur) / np.abs(Ur)
        worst["x_err_nm"] = ref.worse(worst["x_err_nm"], dx.max())
        worst["v_err_nm_per_ps"] = ref.worse(worst["v_err_nm_per_ps"],
                                             dv.max())
        worst["energy_rel_err"] = ref.worse(worst["energy_rel_err"],
                                            np.max(e_err))
        worst["swap_mismatch"] += int(np.sum(kTo != kTr))
    return worst
