"""The least time of the traced window's force evaluations over the
device's busy time, in percent: each step evaluates every chain's forces,
whose least time is the larger of 36 operations a pair within the cutoff
over the float32 peak and 24 bytes a particle over the bandwidth
(``yardstick``).  The pairs are counted by the reference on states sampled
from the window."""

from h100bench import yardstick


def read(r):
    t = r.get("trace")
    if not t or t["busy_s"] <= 0 or not r.get("pairs") or not r["steps"]:
        return None
    ops, nbytes = yardstick.force_work(r["pairs"], r["n"] * r["chains"])
    return 100.0 * r["steps"] * yardstick.least_seconds(ops, nbytes) / t["busy_s"]
