"""Device operations (kernels, copies, fills) in the traced window over
the steps it covers; a step advances every chain once."""


def read(r):
    t = r.get("trace")
    if not t or not t["device_ops"] or not r["steps"]:
        return None
    return t["device_ops"] / r["steps"]
