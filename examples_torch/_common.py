"""What the example programs share: the device check and the command line."""

import argparse
import inspect
import time


def require_device(device):
    """``device`` as a ``torch.device``; raises where it is the card and no
    card is visible, so a run never goes on on the CPU unasked."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' (--device cpu) to "
            "run a small example on the CPU")
    return dev


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(device, fn):
    """``(fn(), seconds)``, the device's queue drained on both sides."""
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t0


def run_cli(main, check, doc=None) -> None:
    """Run ``check(main(**arguments))`` with ``main``'s keyword arguments of
    plain types read from the command line (``--n-steps 100``,
    ``--device cpu``, ``--write``)."""
    parser = argparse.ArgumentParser(description=doc)
    for name, p in inspect.signature(main).parameters.items():
        flag = "--" + name.replace("_", "-")
        if isinstance(p.default, bool):
            parser.add_argument(flag, action=argparse.BooleanOptionalAction,
                                default=p.default)
        elif isinstance(p.default, (int, float, str)):
            parser.add_argument(flag, type=type(p.default), default=p.default)
    check(main(**vars(parser.parse_args())))
