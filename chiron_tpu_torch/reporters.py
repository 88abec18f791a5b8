"""Simulation reporters: buffered HDF5 logging and binary trajectories
(port of ``chiron_tpu/reporters.py``).

They write the same files as the JAX package's: the same HDF5 datasets (a
buffered dict of lists flushed to appendable datasets), the same DCD bytes,
and XTC through the native codec (``native``), or mdtraj where it is
importable and no C compiler is.  The output directory is the reference's
global classvar, the current directory unless ``BaseReporter.set_directory``
names another.

Values may arrive as tensors on any device (the integrator reports whole
chunks): each is moved to the host when it is written.  h5py is imported at
the first write or read of an HDF5 file, not with this module, so the moves
import without it.
"""

from __future__ import annotations

import logging
import os
import struct
from pathlib import Path
from typing import List, Optional

import numpy as np

log = logging.getLogger("chiron_tpu_torch")

try:  # optional: enables XTC parity output
    import mdtraj as _mdtraj  # noqa: F401

    _HAS_MDTRAJ = True
except Exception:  # pragma: no cover - environment without mdtraj
    _HAS_MDTRAJ = False


def _h5py():
    import h5py

    return h5py


def _host(value) -> np.ndarray:
    """A reported value as a numpy array (a tensor goes to the host)."""
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class DCDWriter:
    """Minimal CHARMM-format DCD trajectory writer.

    Binary layout per the X-PLOR/CHARMM spec: Fortran-style records
    (4-byte length prefix/suffix), a 'CORD' header, one title record, the
    atom count, then per frame an optional unit-cell record (6 float64:
    A, gamma, B, beta, alpha, C) and three float32 records (x, y, z).
    """

    def __init__(self, path: str, n_atoms: int, with_unitcell: bool = True):
        self.path = str(path)
        self.n_atoms = int(n_atoms)
        self.with_unitcell = with_unitcell
        self.n_frames = 0
        self._fh = open(self.path, "wb")
        self._write_header()

    def _record(self, payload: bytes) -> None:
        self._fh.write(struct.pack("<i", len(payload)))
        self._fh.write(payload)
        self._fh.write(struct.pack("<i", len(payload)))

    def _write_header(self) -> None:
        # icntrl[0]=nframes (patched on close), [7]=ndegf, [10]=crystal flag,
        # [19]=CHARMM version (24 -> "has extra blocks").
        icntrl = [0] * 20
        icntrl[0] = 0
        icntrl[1] = 1  # istart
        icntrl[2] = 1  # nsavc
        icntrl[9] = 0
        icntrl[10] = 1 if self.with_unitcell else 0
        icntrl[19] = 24
        payload = b"CORD" + struct.pack("<20i", *icntrl)
        self._record(payload)
        title = b"Created by chiron-tpu DCDWriter".ljust(80)
        self._record(struct.pack("<i", 1) + title)
        self._record(struct.pack("<i", self.n_atoms))
        self._header_pos_nframes = 4 + 4  # record marker + 'CORD'
        self._fh.flush()

    def write(self, positions: np.ndarray, box_lengths: Optional[np.ndarray] = None):
        """Append one frame.  positions in Angstrom, (N, 3)."""
        positions = np.asarray(positions, dtype=np.float32)
        if positions.shape != (self.n_atoms, 3):
            raise ValueError(
                f"positions must be ({self.n_atoms}, 3), got {positions.shape}"
            )
        if self.with_unitcell:
            if box_lengths is None:
                box_lengths = np.zeros(3)
            a, b, c = (float(x) for x in box_lengths)
            # A, gamma, B, beta, alpha, C with 90-degree angles encoded as
            # cos(angle)=0 per the CHARMM convention.
            cell = struct.pack("<6d", a, 0.0, b, 0.0, 0.0, c)
            self._record(cell)
        for axis in range(3):
            self._record(positions[:, axis].tobytes())
        self.n_frames += 1

    def flush(self):
        # Patch the frame count in the header.
        pos = self._fh.tell()
        self._fh.seek(self._header_pos_nframes)
        self._fh.write(struct.pack("<i", self.n_frames))
        self._fh.seek(pos)
        self._fh.flush()

    def close(self):
        if not self._fh.closed:
            self.flush()
            self._fh.close()


def read_dcd(path: str) -> np.ndarray:
    """Read a DCD written by :class:`DCDWriter` back as (n_frames, N, 3)."""
    with open(path, "rb") as fh:
        def record():
            (n,) = struct.unpack("<i", fh.read(4))
            payload = fh.read(n)
            fh.read(4)
            return payload

        header = record()
        icntrl = struct.unpack("<20i", header[4:84])
        n_frames, has_cell = icntrl[0], icntrl[10]
        record()  # title
        (n_atoms,) = struct.unpack("<i", record())
        frames = []
        for _ in range(n_frames):
            if has_cell:
                record()
            xyz = np.stack(
                [np.frombuffer(record(), dtype=np.float32) for _ in range(3)],
                axis=1,
            )
            frames.append(xyz)
        return np.stack(frames) if frames else np.zeros((0, n_atoms, 3))


class BaseReporter:
    """Global output-directory holder."""

    _directory = None

    @classmethod
    def set_directory(cls, directory: str):
        cls._directory = directory

    @classmethod
    def get_directory(cls) -> Path:
        if cls._directory is None:
            log.debug("No directory set, using cwd: %s", Path.cwd())
            return Path.cwd()
        return Path(cls._directory)


class _SimulationReporter:
    """Buffered HDF5 reporter."""

    def __init__(self, file_name: str, buffer_size: int = 10):
        workdir = BaseReporter.get_directory()
        self.file_path_base = workdir / f"{file_name}"
        self.log_file_path = self.file_path_base.with_suffix(".h5")
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        log.info("Writing simulation log data to %s", self.log_file_path)
        self.buffer_size = buffer_size
        self.buffer = {}

    @property
    def properties_to_report(self) -> List[str]:
        return self._default_properties

    @properties_to_report.setter
    def properties_to_report(self, properties: List[str]):
        self._default_properties = properties

    def get_available_keys(self):
        keys = []
        with _h5py().File(self.log_file_path, "r") as h5file:
            for key in h5file:
                keys.append(key)
        return keys

    def report(self, data_dict: dict):
        """Buffer new data; flush when every key exceeds the buffer size."""
        for key, value in data_dict.items():
            if key not in self.buffer:
                self.buffer[key] = []
            self.buffer[key].append(value)
        self._flush_buffer_if_necessary()

    def _flush_buffer_if_necessary(self):
        if self.buffer and all(
            len(self.buffer[key]) > self.buffer_size for key in self.buffer
        ):
            self.flush_buffer()

    def _write_to_disk(self, key: str):
        if key == "positions" and hasattr(self, "_write_to_trajectory"):
            xyz = np.stack([_host(p) for p in self.buffer[key]])
            self._write_to_trajectory(positions=xyz)

        data = np.array([_host(v) for v in self.buffer[key]])
        with _h5py().File(self.log_file_path, "a") as h5file:
            if key in h5file:
                dset = h5file[key]
                dset.resize((dset.shape[0] + data.shape[0],) + data.shape[1:])
                dset[-data.shape[0]:] = data
            else:
                h5file.create_dataset(
                    key, data=data, maxshape=(None,) + data.shape[1:], chunks=True
                )

    def reset_reporter_file(self):
        if os.path.exists(self.log_file_path):
            log.debug("Deleting %s", self.log_file_path)
            os.remove(self.log_file_path)

    def flush_buffer(self) -> None:
        for key in self.buffer:
            if self.buffer[key]:
                self._write_to_disk(key)
        self._reset_buffer()

    def _reset_buffer(self) -> None:
        self.buffer = {key: [] for key in self.buffer}

    def get_property(self, name: str):
        """Read a property from file (or the live buffer)."""
        if name == "positions" and hasattr(self, "read_from_trajectory"):
            return self.read_from_trajectory()

        if not os.path.exists(self.log_file_path):
            if name in self.buffer:
                return np.array([_host(v) for v in self.buffer[name]])
            log.warning("%s not found (no file, not in buffer)", name)
            return None

        with _h5py().File(self.log_file_path, "r") as h5file:
            if name in h5file:
                data = np.array(h5file[name])
                # include rows still pending in the in-memory buffer so
                # mid-run readers (e.g. the MBAR update each iteration) see
                # every reported frame, not just the flushed ones
                if self.buffer.get(name):
                    pending = np.array(
                        [_host(v) for v in self.buffer[name]]
                    )
                    if pending.shape[1:] == data.shape[1:]:
                        data = np.concatenate([data, pending], axis=0)
                return data
            elif name in self.buffer:
                return np.array([_host(v) for v in self.buffer[name]])
            log.warning("%s not in HDF5 file", name)
            return None


class MCReporter(_SimulationReporter):
    """MC-move reporter."""

    _name = "mc_reporter"
    _default_properties = [
        "step", "potential_energy", "volume", "acceptance_probability",
    ]

    def __init__(self, file_name: Optional[str] = None, buffer_size: int = 1):
        if file_name is None:
            file_name = MCReporter.get_name()
        super().__init__(file_name=file_name, buffer_size=buffer_size)

    @classmethod
    def get_name(cls):
        return cls._name


class LangevinDynamicsReporter(_SimulationReporter):
    """MD reporter with trajectory output."""

    _name = "langevin_reporter"
    _default_properties = ["positions", "box_vectors", "potential_energy", "step"]

    def __init__(
        self,
        file_name: Optional[str] = None,
        buffer_size: int = 1,
        topology=None,
    ):
        if file_name is None:
            file_name = LangevinDynamicsReporter.get_name()
        super().__init__(file_name=file_name, buffer_size=buffer_size)
        self.topology = topology
        self._dcd_writer: Optional[DCDWriter] = None
        self.dcd_file_path = f"{self.file_path_base}.dcd"
        # XTC written natively (``native``) whenever a C compiler is
        # available; mdtraj is the fallback, in the same format
        self.xtc_file_path = f"{self.file_path_base}.xtc"
        self._write_xtc_file_handle = None
        self._native_xtc_writer = None

    @classmethod
    def get_name(cls):
        return cls._name

    def _write_to_trajectory(self, positions: np.ndarray) -> None:
        """Append buffered frames to the DCD (and XTC when available)."""
        n_frames, n_atoms, _ = positions.shape
        if self._dcd_writer is None:
            log.debug("Creating trajectory in %s", self.dcd_file_path)
            self._dcd_writer = DCDWriter(
                self.dcd_file_path, n_atoms,
                with_unitcell=self.buffer.get("box_vectors") is not None,
            )
        boxes = self.buffer.get("box_vectors")
        for i in range(n_frames):
            box_lengths = None
            if boxes is not None and i < len(boxes) and boxes[i] is not None:
                # nm -> Angstrom
                box_lengths = np.diagonal(_host(boxes[i])) * 10.0
            self._dcd_writer.write(positions[i] * 10.0, box_lengths)
        self._dcd_writer.flush()

        from .native import has_native_xtc

        if has_native_xtc():
            if self._native_xtc_writer is None:
                from .native.xtc_io import XTCWriter

                self._native_xtc_writer = XTCWriter(self.xtc_file_path)
            for i in range(n_frames):
                box_nm = None
                if boxes is not None and i < len(boxes) and boxes[i] is not None:
                    box_nm = _host(boxes[i])
                # positions arrive in nm (the DCD write above scales x10
                # for Angstroms); XTC stores nm directly
                self._native_xtc_writer.write(positions[i], box_nm)
        elif _HAS_MDTRAJ:
            if self._write_xtc_file_handle is None:
                self._write_xtc_file_handle = _mdtraj.formats.XTCTrajectoryFile(
                    self.xtc_file_path, mode="w"
                )
            # parity with the native path: write the unit cell too, or a
            # periodic run's .xtc carries zero boxes and PBC-aware
            # analysis downstream silently misbehaves
            box_arr = None
            if boxes is not None and len(boxes) >= n_frames and all(
                b is not None for b in boxes[:n_frames]
            ):
                box_arr = np.asarray(
                    [_host(b) for b in boxes[:n_frames]],
                    dtype=np.float32,
                )
            self._write_xtc_file_handle.write(positions, box=box_arr)

    def read_from_trajectory(self) -> np.ndarray:
        """Positions (n_frames, N, 3) in nm: DCD-flushed frames plus any
        still pending in the reporter buffer (so mid-run readers see every
        reported frame, matching the scalar properties' pending-concat
        semantics -- and a pre-first-flush read returns the buffered
        frames instead of raising FileNotFoundError)."""
        if self._dcd_writer is not None:
            self._dcd_writer.flush()
        flushed = None
        if os.path.exists(self.dcd_file_path):
            flushed = read_dcd(self.dcd_file_path) / 10.0
        pending = self.buffer.get("positions") or []
        if pending:
            p = np.array([_host(v) for v in pending])
            if flushed is None:
                return p
            if p.shape[1:] == flushed.shape[1:]:
                return np.concatenate([flushed, p], axis=0)
        if flushed is None:
            log.warning(
                "no trajectory frames written or buffered for %s",
                self.dcd_file_path,
            )
            return None
        return flushed

    def flush_buffer(self):
        super().flush_buffer()
        if self._dcd_writer is not None:
            self._dcd_writer.flush()
        if self._native_xtc_writer is not None:
            self._native_xtc_writer.flush()
        if self._write_xtc_file_handle is not None:
            self._write_xtc_file_handle.flush()


class MultistateReporter(_SimulationReporter):
    """Multistate reporter with per-replica trajectory fan-out."""

    _name = "multistate_reporter"
    _default_properties = ["positions", "box_vectors", "u_kn", "state_index", "step"]

    def __init__(self, file_name: Optional[str] = None, buffer_size: int = 1):
        if file_name is None:
            file_name = MultistateReporter.get_name()
        super().__init__(file_name=file_name, buffer_size=buffer_size)
        self._replica_reporter = {}

    @classmethod
    def get_name(cls):
        return cls._name

    def _write_to_trajectory(self, positions: np.ndarray) -> None:
        nr_of_frames, n_replicas, n_atoms, _ = positions.shape
        for replica_id in range(n_replicas):
            key = f"replica_{replica_id}"
            if self._replica_reporter.get(key) is None:
                self._replica_reporter[key] = LangevinDynamicsReporter(key)
            reporter = self._replica_reporter[key]
            for frame_id in range(nr_of_frames):
                data = {"positions": positions[frame_id, replica_id]}
                boxes = self.buffer.get("box_vectors")
                if boxes is not None and frame_id < len(boxes):
                    data["box_vectors"] = _host(boxes[frame_id])[replica_id]
                reporter.report(data)

    def flush_buffer(self):
        # parent FIRST: super().flush_buffer() drains this reporter's
        # pending frames INTO the per-replica child reporters
        # (_write_to_trajectory -> child.report), so the children must be
        # flushed afterwards or the final frames of every replica are
        # stranded in their in-memory buffers.
        out = super().flush_buffer()
        for reporter in self._replica_reporter.values():
            reporter.flush_buffer()
        return out
