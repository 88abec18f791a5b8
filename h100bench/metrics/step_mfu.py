"""The traced window's share of the card's float32 peak, in percent: the
operations its force evaluations need (36 a pair within the cutoff, every
chain every step; ``yardstick``) over the peak times the window's wall
time, idle time included."""

from h100bench import yardstick


def read(r):
    t = r.get("trace")
    if not t or t["window_s"] <= 0 or not r.get("pairs") or not r["steps"]:
        return None
    ops, _ = yardstick.force_work(r["pairs"], r["n"] * r["chains"])
    return 100.0 * r["steps"] * ops / (yardstick.PEAK_F32 * t["window_s"])
