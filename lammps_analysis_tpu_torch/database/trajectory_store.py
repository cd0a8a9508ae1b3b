"""Append-able on-disk trajectory store: one ``.npy`` file per dataset.

Counterpart of ``lammps_analysis_tpu/database/trajectory_store.py`` with the
same public API and the same layout rules:

* datasets live at ``"{species}/{property}"`` with shape
  ``(n_configurations, n_particles, n_dims)`` — time leading, so a batch of
  frames is one contiguous read that goes straight into a host-to-device
  copy;
* each dataset has an append cursor (``starting_index``) so ingestion can
  resume after a crash.

Why not HDF5, as the JAX package: the machines the port runs on cannot be
assumed to have ``h5py``, so the store uses numpy alone. Each dataset is
``<store>/<species>/<property>.npy``, written and read through
``np.lib.format.open_memmap``; the cursors live in ``<store>/cursors.json``.
A dataset grows along time by rewriting it into a larger file (ingestion
sizes the datasets for the whole source up front, so this happens once per
appended source). ``database/convert.py`` carries a JAX-package
``database.h5`` across.

The dtype is always explicit: ``float32`` unless the caller says otherwise
(the JAX package's default without x64).

``load`` runs in the span ``store.load`` and counts the bytes and frames it
returns in ``store.bytes`` and ``store.frames`` (``utils/profiling.py``).
"""

from __future__ import annotations

import json
import os
import pathlib
import threading
from typing import Dict, List, Sequence, Union

import numpy as np

from ..utils import profiling
from .contracts import TrajectoryChunkData, TrajectoryMetadata

_CURSORS = "cursors.json"


def join_path(*parts: str) -> str:
    """Join store path components (``"Na"``, ``"Positions"`` -> ``"Na/Positions"``)."""
    return "/".join(str(p) for p in parts)


class TrajectoryStore:
    """Append-able npy tensor store for trajectories, rooted at a directory."""

    #: the methods that write files; the others read
    WRITES = frozenset({
        "set_cursor", "initialize", "ensure_dataset", "resize_datasets", "add_chunk", "append",
        "drop",
    })

    def __init__(self, path: Union[str, pathlib.Path], dtype: str = "float32"):
        self.path = pathlib.Path(path)
        self.dtype = np.dtype(dtype)
        # the prefetch thread reads while the caller may set cursors
        self._lock = threading.RLock()

    def _file(self, path: str) -> pathlib.Path:
        species, prop = path.split("/")
        return self.path / species / f"{prop}.npy"

    # ---------------------------------------------------------------- cursors
    def _read_cursors(self) -> Dict[str, int]:
        f = self.path / _CURSORS
        if not f.exists():
            return {}
        return json.loads(f.read_text())

    def _write_cursors(self, cursors: Dict[str, int]) -> None:
        tmp = self.path / (_CURSORS + ".tmp")
        tmp.write_text(json.dumps(cursors, sort_keys=True))
        os.replace(tmp, self.path / _CURSORS)

    def set_cursor(self, path: str, value: int) -> None:
        with self._lock:
            cursors = self._read_cursors()
            cursors[path] = int(value)
            self._write_cursors(cursors)

    def get_cursor(self, path: str) -> int:
        with self._lock:
            return int(self._read_cursors()[path])

    # ------------------------------------------------------------------ setup
    def initialize(self, metadata: TrajectoryMetadata) -> None:
        """Create (or grow) every dataset ``metadata`` announces."""
        for sp in metadata.species_list:
            for prop in sp.properties:
                self.ensure_dataset(
                    sp.name, prop.name, metadata.n_configurations,
                    sp.n_particles, prop.n_dims,
                )

    def ensure_dataset(
        self, group: str, name: str, n_configs: int, n_particles: int,
        n_dims: int, dtype=None,
    ) -> None:
        """Create ``group/name`` if absent, else grow it to ``n_configs``."""
        path = join_path(group, name)
        with self._lock:
            f = self._file(path)
            if f.exists():
                self._resize_to(path, n_configs)
                return
            f.parent.mkdir(parents=True, exist_ok=True)
            np.lib.format.open_memmap(
                f, mode="w+", dtype=self.dtype if dtype is None else dtype,
                shape=(int(n_configs), int(n_particles), int(n_dims)),
            ).flush()
            self.set_cursor(path, 0)

    def _resize_to(self, path: str, n_configs: int) -> None:
        f = self._file(path)
        old = np.lib.format.open_memmap(f, mode="r")
        if old.shape[0] >= n_configs:
            return
        tmp = f.with_suffix(".npy.tmp")
        new = np.lib.format.open_memmap(
            tmp, mode="w+", dtype=old.dtype, shape=(n_configs,) + old.shape[1:]
        )
        new[: old.shape[0]] = old
        new.flush()
        del new, old
        os.replace(tmp, f)

    def resize_datasets(self, extension: Dict[str, int]) -> None:
        """Grow datasets along time by ``extension[path]`` frames.

        Reference analog: ``Database.resize_datasets``
        (``simulation_database.py:380-418``).
        """
        with self._lock:
            for path, n_extra in extension.items():
                self._resize_to(path, self.get_data_size(path)[0] + int(n_extra))

    # ------------------------------------------------------------------ write
    def _open_for_write(self, path: str) -> np.memmap:
        return np.lib.format.open_memmap(self._file(path), mode="r+")

    def add_chunk(self, chunk: TrajectoryChunkData) -> None:
        """Append a chunk at each dataset's cursor (growing it if needed)."""
        for sp in chunk.species_list:
            for prop in sp.properties:
                self.append(
                    join_path(sp.name, prop.name), chunk.get_data(sp.name, prop.name)
                )

    def append(self, path: str, data: np.ndarray) -> None:
        """Write ``(n_frames, n_particles, n_dims)`` frames at the dataset's
        cursor (growing it if needed) and advance the cursor."""
        with self._lock:
            start = self.get_cursor(path)
            stop = start + len(data)
            self._resize_to(path, stop)
            ds = self._open_for_write(path)
            ds[start:stop] = data
            ds.flush()
            del ds
            self.set_cursor(path, stop)

    # ------------------------------------------------------------------- read
    def load(
        self,
        paths: Sequence[str],
        frames: Union[slice, np.ndarray, None] = None,
        atoms: Union[slice, np.ndarray, None] = None,
        dtype=None,
    ) -> Dict[str, np.ndarray]:
        """Load ``(frames, atoms, dims)`` arrays for each path.

        ``frames`` is a slice or an integer index array (sampled
        configurations); ``atoms`` likewise. ``dtype=None`` keeps the stored
        dtype.
        """
        out: Dict[str, np.ndarray] = {}
        with profiling.annotate("store.load"):
            for path in paths:
                ds = np.lib.format.open_memmap(self._file(path), mode="r")
                data = ds[slice(None) if frames is None else frames]
                if atoms is not None and not (
                    isinstance(atoms, slice) and atoms == slice(None)
                ):
                    data = data[:, atoms]
                out[path] = np.array(
                    data, dtype=ds.dtype if dtype is None else dtype
                )
                profiling.count_shared("store.bytes", out[path].nbytes)
                profiling.count_shared("store.frames", len(out[path]))
        return out

    # ------------------------------------------------------------- inspection
    def check_existence(self, path: str) -> bool:
        return self._file(path).exists()

    def drop(self, path: str) -> bool:
        """Delete a dataset and its cursor; True if it existed.

        The JAX store's ``drop``: lets a user force a derived tensor such as
        ``Unwrapped_Positions`` to be recomputed by the next calculator that
        needs it, or reclaim its space."""
        with self._lock:
            f = self._file(path)
            if not f.exists():
                return False
            f.unlink()
            cursors = self._read_cursors()
            cursors.pop(path, None)
            self._write_cursors(cursors)
            return True

    def get_data_size(self, path: str) -> tuple:
        """``(n_configurations, n_particles, n_dims)`` of a dataset."""
        return tuple(np.lib.format.open_memmap(self._file(path), mode="r").shape)

    def get_memory_information(self) -> Dict[str, int]:
        """Per-dataset nbytes. Reference: ``simulation_database.py:528-544``."""
        out = {}
        for sp in self.species_names():
            for prop in self.properties_of(sp):
                ds = np.lib.format.open_memmap(self._file(join_path(sp, prop)), mode="r")
                out[join_path(sp, prop)] = int(np.prod(ds.shape)) * ds.dtype.itemsize
        return out

    def species_names(self) -> List[str]:
        if not self.path.exists():
            return []
        return sorted(p.name for p in self.path.iterdir() if p.is_dir())

    def properties_of(self, species: str) -> List[str]:
        return sorted(p.stem for p in (self.path / species).glob("*.npy"))

    def summary(self) -> Dict[str, Dict[str, tuple]]:
        out: Dict[str, Dict[str, tuple]] = {}
        for sp in self.species_names():
            out[sp] = {p: self.get_data_size(join_path(sp, p)) for p in self.properties_of(sp)}
        return out
