"""Native (C) runtime components, loaded through ctypes (port of
``chiron_tpu/native/__init__.py``).

The trajectory codecs that the reference delegated to third-party libraries
live here as small C sources (``xtc.c``, a copy of the JAX package's, byte
for byte) compiled on first use with the host compiler (``cc -O2 -shared``;
``$CC`` names another) into ``chiron_tpu_torch/_build/native/``, a directory
that git ignores.  This is host code for the trajectory files, not a device
kernel.  As in the JAX package, a failed build logs a warning and turns the
native path off.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

log = logging.getLogger("chiron_tpu_torch")

_SRC_DIR = Path(__file__).parent
BUILD_DIR = _SRC_DIR.parent / "_build" / "native"
_lib_cache: dict = {}


def _build_and_load(name: str) -> Optional[ctypes.CDLL]:
    """Compile ``<name>.c`` into a shared object named by its hash, once,
    and dlopen it; None when the build or the load fails."""
    if name in _lib_cache:
        return _lib_cache[name]
    src = _SRC_DIR / f"{name}.c"
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = BUILD_DIR / f"{name}-{tag}.so"
    if not so_path.exists():
        cc = os.environ.get("CC", "cc")
        tmp = so_path.with_suffix(f".so.{os.getpid()}.tmp")
        cmd = [cc, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(src), "-lm"]
        try:
            subprocess.run(
                cmd, check=True, capture_output=True, text=True, timeout=120
            )
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired) as e:
            log.warning("native %s build failed (%s); native path disabled",
                        name, e)
            _lib_cache[name] = None
            return None
        os.replace(tmp, so_path)
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError as e:
        log.warning("native %s load failed (%s)", name, e)
        lib = None
    _lib_cache[name] = lib
    return lib


def xtc_library() -> Optional[ctypes.CDLL]:
    """The XTC codec, its entry points typed; None without a compiler."""
    lib = _build_and_load("xtc")
    if lib is not None and not getattr(lib, "_xtc_configured", False):
        ct = ctypes
        lib.xtc_encode_frame.restype = ct.c_long
        lib.xtc_encode_frame.argtypes = [
            ct.c_int, ct.c_int, ct.c_float, ct.POINTER(ct.c_float),
            ct.POINTER(ct.c_float), ct.c_float, ct.POINTER(ct.c_ubyte),
            ct.c_long,
        ]
        lib.xtc_decode_frame.restype = ct.c_long
        lib.xtc_decode_frame.argtypes = [
            ct.POINTER(ct.c_ubyte), ct.c_long, ct.POINTER(ct.c_int),
            ct.POINTER(ct.c_int), ct.POINTER(ct.c_float),
            ct.POINTER(ct.c_float), ct.POINTER(ct.c_float), ct.c_int,
            ct.POINTER(ct.c_float),
        ]
        lib._xtc_configured = True
    return lib


def has_native_xtc() -> bool:
    return xtc_library() is not None
