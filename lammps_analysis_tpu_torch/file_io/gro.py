"""Native GROMACS ``.gro`` trajectory reader (no chemfiles needed).

Copied from ``lammps_analysis_tpu/file_io/gro.py``: the frame loop is the
same Python line loop (a faster parse is host work for later).

The reference reads GROMACS data through chemfiles
(``mdsuite/file_io/chemfiles_read.py:44-98``, exercised by the water
functional test ``CI/functional_tests/test_water_study.py:80-91``) — a
dependency this environment does not ship. ``.gro`` is a simple
fixed-width text format (one title line with optional ``t=``, an atom
count, ``natoms`` atom records, one box line per frame), so a native
reader covers the GROMACS workflow directly.

Conventions matched to chemfiles' behavior: lengths convert nm -> Angstrom
(factor 10; chemfiles standardises on Angstrom), velocities nm/ps ->
A/ps. Species are derived from the atom-name column: digits are stripped
("HW1" -> "HW"); if the result is not a known element symbol but its
first letter is ("OW" -> "O"), the element is used — override with
``species_map`` for exotic naming.

Format (fixed columns, GROMACS manual 5.7):
    residue number (5) | residue name (5) | atom name (5) |
    atom number (5) | x y z (%8.3f each) [| vx vy vz (%8.4f each)]
"""

from __future__ import annotations

import itertools
import logging
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..database.contracts import (
    SpeciesInfo,
    TrajectoryChunkData,
    TrajectoryMetadata,
)
from ..database.properties import mdsuite_properties as mp
from .base import FileProcessor

log = logging.getLogger(__name__)

NM_TO_ANGSTROM = 10.0


def _element_for(atom_name: str, species_map: Optional[Dict[str, str]]) -> str:
    if species_map and atom_name in species_map:
        return species_map[atom_name]
    base = "".join(c for c in atom_name if not c.isdigit()) or atom_name
    from ..data.elements import ATOMIC_MASSES

    cand = base.capitalize()
    if cand in ATOMIC_MASSES:
        return cand
    first = base[:1].upper()
    if first in ATOMIC_MASSES:
        return first
    return base


class GROFile(FileProcessor):
    """Reader for (multi-frame) GROMACS ``.gro`` coordinate files."""

    def __init__(
        self,
        file_path,
        species_map: Optional[Dict[str, str]] = None,
        frames_per_chunk: int = 200,
        sample_rate: Optional[int] = None,
    ):
        super().__init__()
        self.file_path = str(file_path)
        self.species_map = species_map
        self.frames_per_chunk = int(frames_per_chunk)
        self._sample_rate = sample_rate
        self._scan: Optional[dict] = None

    # ------------------------------------------------------------- scanning
    def _scan_first_frame(self) -> dict:
        if self._scan is not None:
            return self._scan
        with open(self.file_path) as f:
            title = f.readline()
            if not title:
                raise ValueError(f"{self.file_path}: empty .gro file")
            n_atoms = int(f.readline())
            names = []
            has_vel = False
            for _ in range(n_atoms):
                line = f.readline()
                names.append(line[10:15].strip())
                # 3 coordinate fields end at column 44; velocities beyond
                has_vel = has_vel or len(line.rstrip("\n")) >= 68
            box_line = f.readline().split()
            box_l = [float(v) * NM_TO_ANGSTROM for v in box_line[:3]]
            # frame size in lines: title + count + atoms + box
            frame_lines = n_atoms + 3
            f.seek(0)
            total_lines = sum(1 for _ in f)
        n_frames = total_lines // frame_lines
        if total_lines % frame_lines:
            log.warning(
                "%s: %d trailing lines do not form a full frame; ignored",
                self.file_path, total_lines % frame_lines,
            )
        elements = [_element_for(n, self.species_map) for n in names]
        species_rows: Dict[str, List[int]] = {}
        for i, el in enumerate(elements):
            species_rows.setdefault(el, []).append(i)
        t0 = _title_time(title)
        self._scan = dict(
            n_atoms=n_atoms, n_frames=n_frames, has_vel=has_vel,
            box_l=box_l, species_rows=species_rows, t0=t0,
            frame_lines=frame_lines,
        )
        return self._scan

    def _get_metadata(self) -> TrajectoryMetadata:
        scan = self._scan_first_frame()
        props = [mp.positions] + ([mp.velocities] if scan["has_vel"] else [])
        species = [
            SpeciesInfo(name, len(rows), props)
            for name, rows in sorted(scan["species_rows"].items())
        ]
        sample_rate = self._sample_rate
        if sample_rate is None and scan["n_frames"] > 1:
            # derive from consecutive frame times when titles carry t=;
            # islice to the second frame's title only (readlines() here
            # materialised the WHOLE multi-GB trajectory as str objects)
            with open(self.file_path) as f:
                title1 = next(
                    itertools.islice(f, scan["frame_lines"], None), ""
                )
            t1 = _title_time(title1)
            if scan["t0"] is not None and t1 is not None:
                sample_rate = int(round(t1 - scan["t0"])) or None
        return TrajectoryMetadata(
            n_configurations=scan["n_frames"],
            species_list=species,
            box_l=scan["box_l"],
            sample_rate=sample_rate,
        )

    # ------------------------------------------------------------ streaming
    def get_configurations_generator(self) -> Iterator[TrajectoryChunkData]:
        meta = self.metadata
        scan = self._scan_first_frame()
        n_atoms = scan["n_atoms"]
        has_vel = scan["has_vel"]
        rows_of = scan["species_rows"]
        with open(self.file_path) as f:
            done = 0
            while done < meta.n_configurations:
                n = min(self.frames_per_chunk, meta.n_configurations - done)
                pos = np.empty((n, n_atoms, 3))
                vel = np.empty((n, n_atoms, 3)) if has_vel else None
                for fr in range(n):
                    f.readline()  # title
                    f.readline()  # atom count
                    for a in range(n_atoms):
                        line = f.readline()
                        pos[fr, a] = (
                            float(line[20:28]),
                            float(line[28:36]),
                            float(line[36:44]),
                        )
                        if has_vel:
                            vel[fr, a] = (
                                float(line[44:52]),
                                float(line[52:60]),
                                float(line[60:68]),
                            )
                    f.readline()  # box
                pos *= NM_TO_ANGSTROM
                chunk = TrajectoryChunkData(meta.species_list, n)
                for sp in meta.species_list:
                    idx = np.asarray(rows_of[sp.name])
                    chunk.add_data(pos[:, idx], 0, sp.name, mp.positions.name)
                    if has_vel:
                        chunk.add_data(
                            vel[:, idx] * NM_TO_ANGSTROM, 0,
                            sp.name, mp.velocities.name,
                        )
                yield chunk
                done += n


def _title_time(title: str) -> Optional[float]:
    if "t=" not in title:
        return None
    try:
        return float(title.split("t=")[1].split()[0])
    except (IndexError, ValueError):
        return None
