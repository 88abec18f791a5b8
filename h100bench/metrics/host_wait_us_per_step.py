"""The host's waits on the card a step: the ``chiron.sync.*`` spans (the
latch read, the step read, the tempering energies' read), in the
program's record of the traced window: near 0 where the host sets the
pace."""

from h100bench.metrics import _spans


def read(r):
    return _spans.per_step(r, "wait")
