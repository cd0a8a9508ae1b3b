"""Extended-XYZ trajectory reader.

Copied from ``lammps_analysis_tpu/file_io/extxyz.py`` onto the port's
native tabular engine (the reader sets ``n_cols``; the species column
parses to NaN there and is read from the first configuration only).

Behavioral port of ``mdsuite/file_io/extxyz_files.py``: two header lines per
configuration (atom count + key=value comment line), columns described by
the ``Properties=name:type:ncols:...`` header field, box from ``Lattice=``,
sample rate from consecutive ``time=`` fields.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional

import numpy as np

from ..database.contracts import TrajectoryMetadata
from ..database.properties import mdsuite_properties as mp
from .tabular import (
    TabularReaderSpec,
    TabularTextReader,
    read_n_lines,
    skip_n_lines,
    species_list_from_spec,
)

log = logging.getLogger(__name__)

#: extxyz property field names (reference: ``extxyz_files.py:44-52``).
VAR_NAMES = {
    mp.positions: "pos",
    mp.velocities: "vel",
    mp.forces: "force",
    mp.stress: "stress",
    mp.energy: "energies",
    mp.time: "time",
    mp.momenta: "momenta",
}

N_HEADER_LINES = 2


def _parse_properties_field(header: str) -> List[tuple]:
    """Parse ``Properties=species:S:1:pos:R:3`` -> [(name, type, ncols), ...]."""
    m = re.search(r"Properties=(\S+)", header)
    if m is None:
        raise ValueError("extxyz header has no Properties= field")
    parts = m.group(1).split(":")
    return [
        (parts[i], parts[i + 1], int(parts[i + 2]))
        for i in range(0, len(parts) - 2, 3)
    ]


def _get_box_l(header: str) -> Optional[List[float]]:
    m = re.search(r'Lattice="([^"]+)"', header)
    if m is None:
        return None
    vals = [float(v) for v in m.group(1).split()]
    # orthorhombic diagonal of the 3x3 lattice matrix
    return [vals[0], vals[4], vals[8]]


def _get_time(header: str) -> Optional[float]:
    m = re.search(r"[Tt]ime=([0-9eE+.-]+)", header)
    return float(m.group(1)) if m else None


class EXTXYZFile(TabularTextReader):
    """Reader for (extended) XYZ trajectory files."""

    def __init__(self, file_path, custom_data_map: Optional[Dict[str, str]] = None):
        column_map = dict(VAR_NAMES)
        if custom_data_map:
            # values are single extxyz field names here, unlike LAMMPS columns
            from ..database.properties import PropertyInfo

            for name, field in custom_data_map.items():
                column_map[PropertyInfo(name, 3)] = field
        super().__init__(file_path, {}, None)
        self._field_map = column_map

    def _get_spec(self) -> TabularReaderSpec:
        with open(self.file_path, "r") as f:
            n_particles = int(f.readline())
            header = f.readline()

            fields = _parse_properties_field(header)
            col = 0
            field_cols: Dict[str, List[int]] = {}
            species_col = None
            for name, _ftype, ncols in fields:
                if name == "species":
                    species_col = col
                field_cols[name] = list(range(col, col + ncols))
                col += ncols
            if species_col is None:
                raise ValueError("extxyz file without species column")

            prop_dict = {}
            for prop, field in self._field_map.items():
                if field in field_cols:
                    prop_dict[prop.name] = field_cols[field]

            f.seek(0)
            num_lines = sum(1 for _ in f)
            n_configs = int(round(num_lines / (n_particles + N_HEADER_LINES)))

            f.seek(0)
            skip_n_lines(f, N_HEADER_LINES)
            rows = np.array([f.readline().split() for _ in range(n_particles)])
            species: Dict[str, List[int]] = {}
            for i, row in enumerate(rows):
                species.setdefault(str(row[species_col]), []).append(i)

        return TabularReaderSpec(
            n_configs=n_configs,
            species_to_line_idx=species,
            property_to_column_idx=prop_dict,
            n_header_lines=N_HEADER_LINES,
            n_particles=n_particles,
            header_lines_for_each_config=True,
            sort_by_column_idx=None,  # xyz files have a fixed atom order
            n_cols=col,
        )

    def _get_metadata(self) -> TrajectoryMetadata:
        spec = self.spec
        with open(self.file_path, "r") as f:
            f.readline()
            header0 = f.readline()
            box_l = _get_box_l(header0)
            sample_rate = None
            try:
                f.seek(0)
                skip_n_lines(f, N_HEADER_LINES + spec.n_particles + 1)
                header1 = f.readline()
                t0, t1 = _get_time(header0), _get_time(header1)
                if t0 is not None and t1 is not None:
                    dt = t1 - t0
                    rate = int(round(dt))
                    # the reference rounds unconditionally
                    # (extxyz_files.py:136) — a fractional interval like
                    # time = 0.25 ps truncates to sample_rate 0 and every
                    # downstream time axis collapses to zero; only accept
                    # a clean integer interval, else warn + leave unset
                    if rate >= 1 and abs(dt - rate) <= 1e-9 * max(1.0, abs(dt)):
                        sample_rate = rate
            except (EOFError, ValueError):
                pass
            if sample_rate is None:
                log.warning(
                    "Could not read sample rate from %s; set it on the "
                    "experiment manually if required.",
                    self.file_path,
                )
        return TrajectoryMetadata(
            n_configurations=spec.n_configs,
            species_list=species_list_from_spec(spec),
            box_l=box_l,
            sample_rate=sample_rate,
        )
