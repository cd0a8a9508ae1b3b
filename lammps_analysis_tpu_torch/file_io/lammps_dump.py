"""LAMMPS dump-file reader.

Copied from ``lammps_analysis_tpu/file_io/lammps_dump.py`` (behavioral port of
``mdsuite/file_io/lammps_trajectory_files.py``; the parsing engine is the
native one in ``tabular.py``): 9 header lines per configuration, column map
covering the standard LAMMPS per-atom outputs, species discovered from the
``element`` (or ``type``) column of the first configuration, box from the
bounds lines, sample rate from consecutive ``TIMESTEP`` headers, id-sorting
unless the file is declared sorted.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..database.contracts import TrajectoryMetadata
from ..database.properties import mdsuite_properties as mp
from . import native_parser
from .tabular import (
    TabularReaderSpec,
    TabularTextReader,
    extract_properties_from_header,
    read_n_lines,
    skip_n_lines,
    species_list_from_spec,
)

#: LAMMPS dump column names per canonical property
#: (reference: ``lammps_trajectory_files.py:39-66``).
COLUMN_MAP = {
    mp.positions: ["x", "y", "z"],
    mp.scaled_positions: ["xs", "ys", "zs"],
    mp.unwrapped_positions: ["xu", "yu", "zu"],
    mp.scaled_unwrapped_positions: ["xsu", "ysu", "zsu"],
    mp.velocities: ["vx", "vy", "vz"],
    mp.forces: ["fx", "fy", "fz"],
    mp.box_images: ["ix", "iy", "iz"],
    mp.dipole_orientation_magnitude: ["mux", "muy", "muz"],
    mp.angular_velocity_spherical: ["omegax", "omegay", "omegaz"],
    mp.angular_velocity_non_spherical: ["angmomx", "angmomy", "angmomz"],
    mp.torque: ["tqx", "tqy", "tqz"],
    mp.charge: ["q"],
    mp.kinetic_energy: ["c_KE"],
    mp.potential_energy: ["c_PE"],
    mp.stress: [f"c_Stress[{i}]" for i in range(1, 7)],
}

N_HEADER_LINES = 9


class LAMMPSDumpFile(TabularTextReader):
    """Reader for LAMMPS ``dump ... custom`` trajectory files."""

    def __init__(
        self,
        file_path,
        trajectory_is_sorted_by_ids: bool = False,
        custom_data_map: Optional[Dict[str, List[str]]] = None,
    ):
        super().__init__(file_path, COLUMN_MAP, custom_data_map)
        self.trajectory_is_sorted_by_ids = trajectory_is_sorted_by_ids

    def _get_spec(self) -> TabularReaderSpec:
        with open(self.file_path, "r") as f:
            header = read_n_lines(f, N_HEADER_LINES)
            n_particles = int(header[3].split()[0])
            col_names = header[8].split()[2:]  # after "ITEM: ATOMS"
            # 'id' is only needed to re-sort rows; LAMMPS writes dumps
            # without it: accept those when the user declares the file
            # sorted, and fail with an actionable message otherwise
            id_col = col_names.index("id") if "id" in col_names else None
            if id_col is None and not self.trajectory_is_sorted_by_ids:
                raise ValueError(
                    f"{self.file_path}: dump has no 'id' column, so rows "
                    "cannot be re-sorted; pass "
                    "trajectory_is_sorted_by_ids=True if the dump preserves "
                    "atom order."
                )
            prop_dict = extract_properties_from_header(col_names, self._column_map)

            num_lines = _count_file_lines(self.file_path)
            n_configs_f = num_lines / (n_particles + N_HEADER_LINES)
            n_configs = int(round(n_configs_f))
            if abs(n_configs_f - n_configs) > 1e-10:
                raise ValueError(
                    f"{self.file_path}: line count {num_lines} is not a whole "
                    f"number of configurations of {n_particles} atoms"
                )

            f.seek(0)
            species = self._species_from_first_config(f, col_names, n_particles, id_col)

        return TabularReaderSpec(
            n_configs=n_configs,
            species_to_line_idx=species,
            property_to_column_idx=prop_dict,
            n_header_lines=N_HEADER_LINES,
            n_particles=n_particles,
            header_lines_for_each_config=True,
            sort_by_column_idx=None if self.trajectory_is_sorted_by_ids else id_col,
            n_cols=len(col_names),
        )

    def _species_from_first_config(
        self, f, col_names: List[str], n_particles: int, id_col: int
    ) -> Dict[str, List[int]]:
        """Scan configuration 0 for the species -> sorted-row mapping.

        Reference analog: ``lammps_trajectory_files.py:181-226``.
        """
        if "element" in col_names:
            sp_col = col_names.index("element")
        elif "type" in col_names:
            sp_col = col_names.index("type")
        else:
            raise ValueError(
                f"{self.file_path}: no 'element' or 'type' column; cannot "
                "identify species"
            )
        skip_n_lines(f, N_HEADER_LINES)
        rows = np.array([f.readline().split() for _ in range(n_particles)])
        if not self.trajectory_is_sorted_by_ids:
            # ids must sort NUMERICALLY (the parser places rows by numeric
            # id; a lexicographic string sort would disagree for >9 ids)
            order = np.argsort(rows[:, id_col].astype(float), kind="stable")
            rows = rows[order]
        species: Dict[str, List[int]] = {}
        for i, row in enumerate(rows):
            species.setdefault(str(row[sp_col]), []).append(i)
        return species

    def _get_metadata(self) -> TrajectoryMetadata:
        spec = self.spec
        with open(self.file_path, "r") as f:
            header = read_n_lines(f, N_HEADER_LINES)
            box_l = [
                float(line.split()[1]) - float(line.split()[0])
                for line in header[5:8]
            ]
            t0 = int(header[1])
            sample_rate = None
            try:
                skip_n_lines(f, spec.n_particles)
                header2 = read_n_lines(f, N_HEADER_LINES)
                sample_rate = int(header2[1]) - t0
            except EOFError:
                pass  # single-snapshot trajectory
        return TrajectoryMetadata(
            n_configurations=spec.n_configs,
            species_list=species_list_from_spec(spec),
            box_l=box_l,
            sample_rate=sample_rate,
        )


def _count_file_lines(path) -> int:
    """Count lines via 64 MB byte blocks through the native newline counter:
    the metadata scan's only full-file pass."""
    n = 0
    tail = b""
    with open(path, "rb") as fb:
        while True:
            block = fb.read(64 << 20)
            if not block:
                break
            tail = block
            n += native_parser.count_newlines(block)
    if tail and not tail.endswith(b"\n"):
        n += 1  # an unterminated final line still counts
    return n
