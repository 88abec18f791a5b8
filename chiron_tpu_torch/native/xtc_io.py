"""XTC trajectory writer and reader over the native codec (port of
``chiron_tpu/native/xtc_io.py``).

The API mirrors the DCD writer in ``reporters``: positions in nm,
orthorhombic boxes as 3x3 nm matrices.  Frames are encoded by the C codec
(``xtc.c``) into the GROMACS XTC format (readable by GROMACS/mdtraj/VMD).
"""

from __future__ import annotations

import ctypes as ct
from typing import Optional

import numpy as np

from . import xtc_library


class XTCWriter:
    """Streaming XTC writer (append one frame at a time)."""

    def __init__(self, path: str, precision: float = 1000.0):
        lib = xtc_library()
        if lib is None:
            raise RuntimeError(
                "native XTC codec unavailable (no C compiler?)"
            )
        self._lib = lib
        self._fh = open(path, "wb")
        self.precision = float(precision)
        self.n_frames = 0

    def write(self, positions_nm: np.ndarray,
              box_nm: Optional[np.ndarray] = None,
              step: Optional[int] = None, time_ps: float = 0.0):
        pos = np.ascontiguousarray(positions_nm, dtype=np.float32)
        n = pos.shape[0]
        box = (
            np.zeros((3, 3), np.float32) if box_nm is None
            else np.ascontiguousarray(box_nm, dtype=np.float32)
        )
        cap = 64 + 4 * 3 * n + 1024
        out = np.empty(cap, dtype=np.uint8)
        nbytes = self._lib.xtc_encode_frame(
            n,
            self.n_frames if step is None else int(step),
            ct.c_float(time_ps),
            box.ravel().ctypes.data_as(ct.POINTER(ct.c_float)),
            pos.ravel().ctypes.data_as(ct.POINTER(ct.c_float)),
            ct.c_float(self.precision),
            out.ctypes.data_as(ct.POINTER(ct.c_ubyte)),
            cap,
        )
        if nbytes < 0:
            raise RuntimeError(f"XTC encode failed (code {nbytes})")
        self._fh.write(out[:nbytes].tobytes())
        self.n_frames += 1

    def flush(self):
        self._fh.flush()

    def close(self):
        if not self._fh.closed:
            self._fh.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_xtc(path: str):
    """Read a whole XTC file: (positions (F, N, 3) nm, boxes (F, 3, 3),
    times (F,), steps (F,))."""
    lib = xtc_library()
    if lib is None:
        raise RuntimeError("native XTC codec unavailable (no C compiler?)")
    blob = np.fromfile(path, dtype=np.uint8)
    frames, boxes, times, steps = [], [], [], []
    pos = 0
    natoms = ct.c_int()
    step = ct.c_int()
    time = ct.c_float()
    precision = ct.c_float()
    box = np.empty(9, np.float32)
    # first pass peeks natoms from the header of frame 0
    if blob.size < 8:
        raise ValueError(f"{path}: not an XTC file")
    n0 = int.from_bytes(blob[4:8].tobytes(), "big")
    coords = np.empty(3 * n0, np.float32)
    while pos < blob.size:
        used = lib.xtc_decode_frame(
            blob[pos:].ctypes.data_as(ct.POINTER(ct.c_ubyte)),
            blob.size - pos,
            ct.byref(natoms), ct.byref(step), ct.byref(time),
            box.ctypes.data_as(ct.POINTER(ct.c_float)),
            coords.ctypes.data_as(ct.POINTER(ct.c_float)),
            n0,
            ct.byref(precision),
        )
        if used < 0:
            raise ValueError(f"{path}: XTC decode failed (code {used})")
        frames.append(coords[: 3 * natoms.value].reshape(-1, 3).copy())
        boxes.append(box.reshape(3, 3).copy())
        times.append(float(time.value))
        steps.append(int(step.value))
        pos += used
    return (
        np.stack(frames), np.stack(boxes),
        np.asarray(times), np.asarray(steps),
    )
