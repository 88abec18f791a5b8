"""Build the CUDA kernels of ``csrc/`` and bind them with ctypes.

``library()`` compiles every ``csrc/*.cu`` into an object file, one ``nvcc``
process for each source, all started together, links them into a shared
library with a plain C interface under ``_build/<hash>/`` beside the package
(listed in ``.gitignore``), and loads it.  The directory name is a
hash of the sources and the flags, so an edited source never loads a stale
library and a fresh checkout builds on first use.  A missing ``nvcc``, a
failed build and a nonzero error code from a launch all raise.

Each wrapper in ``ops/`` calls its kernel through ``launch``, which adds one
to that kernel's entry in ``launches``: the count a caller resets before a
run and reads after it, to show which kernels the run went through.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
LIB_NAME = "libchiron_kernels.so"
# the band pair pass (csrc/common.cuh, pair_pass) splits each row tile's work
# over this many blocks
PASS_SPLIT = 4
# the drift latch (csrc/drift.cu) leaves 4 ints of partial for each this
# many lanes
LATCH_BLOCK_LANES = 1024

launches: collections.Counter = collections.Counter()

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
_SIGNATURES = {
    "chiron_lj_dense": (
        _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _I, _I, _P, _P),
    "chiron_cull_force": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _I, _P, _P),
    "chiron_baoab": (
        _P, _P, _P, _P, _P, _P, _P, _I, _U, _I, _F, _F, _F, _F, _P),
    "chiron_cull_md_segment": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _U, _I,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _F, _F, _F, _F, _F, _F, _F, _F, _F, _I, _P, _P),
    "chiron_drift": (_P, _P, _P, _I, _I, _P, _P, _P, _P, _P),
    "chiron_band_force": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _F, _F, _F, _F, _F, _I, _I, _P),
    "chiron_strip_baoab": (
        _P, _P, _P, _P, _P, _P, _P, _I, _U, _I, _I, _I, _F, _F, _F, _F, _P),
    "chiron_strip_wrap": (_P, _I, _P, _P, _I, _I, _I, _I, _P),
    "chiron_strip_force": (
        _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _I, _P),
    "chiron_row_slab_force": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _I, _P),
    "chiron_row_band_force": (
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P),
    "chiron_fused_md": (
        _P, _P, _P, _P, _P, _P, _U, _U, _I, _I, _I,
        _F, _F, _F, _F, _F, _F, _F, _F, _P),
    "chiron_sort_build": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _F, _F, _F, _I, _P),
    "chiron_tile_build": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I,
        _P),
    "chiron_mega_repair": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    "chiron_repair_scratch_lanes": (_I, _I),
    "chiron_mega_segment": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U, _I,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I,
        _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _I, _I, _P, _P),
}


def reset_launch_counts():
    launches.clear()


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the CUDA kernels of chiron_tpu_torch cannot be built"
    )


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


@functools.cache
def library() -> ctypes.CDLL:
    """Build (when the sources changed) and load the kernel library."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = os.getpid()
        nvcc = _nvcc()
        t0 = time.perf_counter()
        jobs = []
        for src in _sources():
            if src.suffix != ".cu":
                continue
            obj = out_dir / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                   str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], False
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"$ {' '.join(cmd)}\n# exit {proc.returncode}\n{out}")
            failed |= proc.returncode != 0
        if not failed:
            tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *(str(obj) for _, obj, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(f"$ {' '.join(cmd)}\n# exit {proc.returncode}\n"
                       f"{proc.stdout}{proc.stderr}")
            failed = proc.returncode != 0
        log.append(f"# {time.perf_counter() - t0:.1f} s in all")
        log = "".join(log)
        (out_dir / "build.log").write_text(log)
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed building the kernels:\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.chiron_error_string.argtypes = [ctypes.c_int]
    lib.chiron_error_string.restype = ctypes.c_char_p
    return lib


def launch(kernel: str, entry: str, *args, enqueued=()):
    """Call the C entry ``entry`` and count one launch of ``kernel``; an
    entry that enqueues other kernels names them in ``enqueued``, as
    (kernel, launches) pairs, and each is counted too."""
    lib = library()
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        msg = lib.chiron_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {rc} ({msg})")
    launches[kernel] += 1
    for name, k in enqueued:
        launches[name] += k


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, shape=None, dtype=None, device=None):
    """Raise ValueError unless ``t`` is a contiguous tensor as described."""
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def pass_buffers(n_pad: int, n_row_tiles: int, n_slots: int, width: int,
                 with_energy: bool, device):
    """Outputs and scratch of a tiled pair pass: the (3, n_pad) force, the
    row partials (PASS_SPLIT, 3, n_pad), the column partials (n_slots, 3,
    width), the energy partials (n_row_tiles PASS_SPLIT,) and the (1,)
    energy or None."""
    import torch

    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((3, n_pad), **f32),
            torch.empty((PASS_SPLIT, 3, n_pad), **f32),
            torch.empty((n_slots, 3, width), **f32),
            torch.empty(n_row_tiles * PASS_SPLIT, **f32),
            torch.empty(1, **f32) if with_energy else None)


def check_cuda(t, name: str):
    """The kernel path takes CUDA tensors only (no CPU carry-on)."""
    if not t.is_cuda:
        raise ValueError(
            f"{name}: on {t.device}; kernels run on CUDA tensors and the "
            "plain version on CPU tensors"
        )
