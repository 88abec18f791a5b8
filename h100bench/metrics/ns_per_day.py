"""Simulated time a day of wall time: the steps the window completed,
times the chains that each step advances and the timestep, over the
window's wall time (host clock)."""


def read(r):
    if not r["steps"] or r["window_s"] <= 0:
        return None
    return r["steps"] * r["chains"] * r["dt_ps"] * 1e-3 / r["window_s"] * 86400.0
