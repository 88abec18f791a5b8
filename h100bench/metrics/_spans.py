"""The program's own span record of the traced window
(``chiron_tpu_torch.profiling.spans()``), split three ways: the runners'
glue (``chiron.segment`` and ``chiron.pt.iteration`` less the wrapper and
sync spans inside them), the kernel wrappers (``chiron.op.*``) and the
host's waits on the card (``chiron.sync.*``).  A program that keeps no
record gives None, and so does an empty record."""

ROOTS = ("chiron.segment", "chiron.pt.iteration")
OP, SYNC = "chiron.op.", "chiron.sync."


def record():
    """The record of the last recording session, or None where the program
    has no span recorder."""
    try:
        from chiron_tpu_torch import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    return None if spans is None else spans()


def _kind(name):
    if name in ROOTS:
        return "glue"
    if name.startswith(OP):
        return "wrapper"
    if name.startswith(SYNC):
        return "wait"
    return None


def split(spans):
    """{"glue", "wrapper", "wait"}: nanoseconds of each in ``spans``
    ((name, parent, t0_ns, t1_ns) a span; open spans are left out), or None
    where ``spans`` is empty.  A span counts once in its own part, however
    deep; a wrapper or sync span whose nearest counted ancestor is a glue
    span is taken out of that glue."""
    if not spans:
        return None
    out = dict(glue=0, wrapper=0, wait=0)
    # each span's nearest ancestor of a counted kind (parents come first)
    above = []
    for name, parent, t0, t1 in spans:
        if parent < 0 or _kind(spans[parent][0]):
            above.append(parent)
        else:
            above.append(above[parent])
        kind = _kind(name)
        up = above[-1]
        up_kind = _kind(spans[up][0]) if up >= 0 else None
        if kind is None or t1 is None or up_kind == kind:
            continue
        out[kind] += t1 - t0
        if up_kind == "glue" and spans[up][3] is not None:
            out["glue"] -= t1 - t0
    return out


def per_step(r, part):
    """``part`` of the traced window's record in microseconds a step (a
    step advances every chain), or None."""
    parts = split(record())
    if parts is None or not r.get("steps"):
        return None
    return parts[part] * 1e-3 / r["steps"]
