"""The card's peaks and the work a force evaluation of the LJ fluid needs,
whatever implements it.

The peaks are NVIDIA's data sheet for the H100 SXM at 700 W: float32
outside the tensor cores, and HBM3.  A pair of particles within the cutoff
needs a distance test (21 float32 operations: the three minimum-image axes
at 5 each, r^2 at 5 and the compare; an FMA is 2) and an LJ term (15: the
reciprocal, i6, the coefficient, three force products and six sums into
both particles).  A force evaluation reads the positions once and writes
the forces once: 24 bytes a particle.  Pairs beyond the cutoff are work of
an implementation's list, not of the problem, and are not counted.
"""

from __future__ import annotations

PEAK_F32 = 67e12      # float32 operations a second
PEAK_BYTES = 3.35e12  # HBM bytes a second
TEST_FLOPS = 21
LJ_FLOPS = 15
PAIR_FLOPS = TEST_FLOPS + LJ_FLOPS
BYTES_PER_PARTICLE = 2 * 3 * 4


def force_work(pairs: int, particles: int):
    """(operations, bytes) of force evaluations over ``pairs`` pairs within
    the cutoff and ``particles`` particles in all."""
    return PAIR_FLOPS * pairs, BYTES_PER_PARTICLE * particles


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the bandwidth."""
    return max(ops / PEAK_F32, nbytes / PEAK_BYTES)
