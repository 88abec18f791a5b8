"""The share of K1's column chunks that passed its bounding-box cull in the
traced window, and so took the distance test: the program's
``chiron.count.dense_chunks_tested`` over
``chiron.count.dense_chunks_visited`` (``chiron_tpu_torch.profiling.counters``,
read once, after the window).  A program without the counters, or a window
that ran no K1, gives None."""


def read(r):
    try:
        from chiron_tpu_torch import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters()
    visited = c.get("chiron.count.dense_chunks_visited", 0)
    if not visited:
        return None
    return c.get("chiron.count.dense_chunks_tested", 0) / visited
