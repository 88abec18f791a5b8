"""The share of the traced window in which no operation ran on the
device: 1 minus the union of the device intervals over the window."""


def read(r):
    t = r.get("trace")
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
