"""Chemfiles-backed reader (optional dependency).

Copied from ``lammps_analysis_tpu/file_io/chemfiles_io.py``.

Analog of ``mdsuite/file_io/chemfiles_read.py``: reads any format chemfiles
supports (GROMACS trr/gro, DCD, ...) extracting positions and velocities.
Gated on the optional ``chemfiles`` package — importing this module works
without it; constructing the reader raises a clear error.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from ..database.contracts import (
    SpeciesInfo,
    TrajectoryChunkData,
    TrajectoryMetadata,
)
from ..database.properties import mdsuite_properties as mp
from .base import FileProcessor

try:  # pragma: no cover - optional dependency
    import chemfiles

    CHEMFILES_AVAILABLE = True
except ImportError:  # pragma: no cover
    chemfiles = None
    CHEMFILES_AVAILABLE = False


class ChemfilesRead(FileProcessor):
    """Reader delegating format handling to chemfiles."""

    def __init__(
        self,
        traj_file_path,
        topol_file_path: Optional[str] = None,
        frames_per_chunk: int = 100,
    ):
        if not CHEMFILES_AVAILABLE:
            raise ImportError(
                "chemfiles is not installed; install it to read formats other "
                "than LAMMPS dump / extxyz / flux, or convert your trajectory."
            )
        super().__init__()
        self.file_path = str(traj_file_path)
        self.topol_file_path = topol_file_path
        self.frames_per_chunk = frames_per_chunk

    def _open(self):
        traj = chemfiles.Trajectory(self.file_path)
        if self.topol_file_path:
            traj.set_topology(self.topol_file_path)
        return traj

    def _get_metadata(self) -> TrajectoryMetadata:
        with self._open() as traj:
            n_configs = traj.nsteps
            frame = traj.read()
            names = [a.name for a in frame.atoms]
            box_l = list(frame.cell.lengths)
            has_vel = frame.has_velocities()
        species: dict[str, list[int]] = {}
        for i, name in enumerate(names):
            species.setdefault(name, []).append(i)
        props = [mp.positions] + ([mp.velocities] if has_vel else [])
        self._species_rows = species
        self._props = props
        species_list = [
            SpeciesInfo(name, len(rows), props) for name, rows in species.items()
        ]
        return TrajectoryMetadata(
            n_configurations=n_configs, species_list=species_list, box_l=box_l
        )

    def get_configurations_generator(self) -> Iterator[TrajectoryChunkData]:
        meta = self.metadata
        with self._open() as traj:
            done = 0
            while done < meta.n_configurations:
                n = min(self.frames_per_chunk, meta.n_configurations - done)
                chunk = TrajectoryChunkData(meta.species_list, n)
                for k in range(n):
                    frame = traj.read()
                    pos = np.asarray(frame.positions)
                    vel = (
                        np.asarray(frame.velocities)
                        if frame.has_velocities()
                        else None
                    )
                    for sp in meta.species_list:
                        rows = self._species_rows[sp.name]
                        chunk.add_data(pos[None, rows], k, sp.name, mp.positions.name)
                        if vel is not None and mp.velocities in sp.properties:
                            chunk.add_data(
                                vel[None, rows], k, sp.name, mp.velocities.name
                            )
                done += n
                yield chunk
