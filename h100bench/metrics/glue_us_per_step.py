"""The runners' glue a step: the ``chiron.segment`` and
``chiron.pt.iteration`` spans' time less the kernel wrappers' and the
syncs' spans inside them, in the program's record of the traced window."""

from h100bench.metrics import _spans


def read(r):
    return _spans.per_step(r, "glue")
