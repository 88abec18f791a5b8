"""The 95th percentile of the wall time between frames reaching the host,
the first frame timed from the window's start (host clock)."""

import numpy as np


def read(r):
    if not r["frame_s"]:
        return None
    return float(np.percentile(np.asarray(r["frame_s"]), 95)) * 1e3
