"""The culled pair pass's LJ lanes over the pairs it tested in the traced
window (the share of the tested pairs' lanes that ran the LJ term): the
program's ``chiron.count.cull_force_lanes`` over
``chiron.count.cull_pairs_tested`` (``chiron_tpu_torch.profiling.counters``,
read once, after the window).  A program without the counters, or a window
that ran no culled pass, gives None."""


def read(r):
    try:
        from chiron_tpu_torch import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters()
    tested = c.get("chiron.count.cull_pairs_tested", 0)
    if not tested:
        return None
    return c.get("chiron.count.cull_force_lanes", 0) / tested
