"""The kernel wrappers' time a step: the ``chiron.op.*`` spans (each
wrapper's checks, allocations, torch ops and C call), in the program's
record of the traced window."""

from h100bench.metrics import _spans


def read(r):
    return _spans.per_step(r, "wrapper")
