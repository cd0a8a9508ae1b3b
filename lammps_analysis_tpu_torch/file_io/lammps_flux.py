"""LAMMPS flux/log file reader (system-wide observables).

Copied from ``lammps_analysis_tpu/file_io/lammps_flux.py`` (behavioral port
of ``mdsuite/file_io/lammps_flux_files.py``) onto the port's native tabular
engine: a flux file holds global (non-per-atom) time series, one row per
sampled step; the user supplies ``sample_rate`` and ``box_l`` since log files
carry no such metadata. Rows are stored under the ``Observables``
pseudo-species with ``n_particles = 1``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..database.contracts import TrajectoryMetadata
from ..database.properties import mdsuite_properties as mp
from ..utils.constants import DatasetKeys
from .tabular import (
    TabularReaderSpec,
    TabularTextReader,
    extract_properties_from_header,
    read_n_lines,
    skip_n_lines,
    species_list_from_spec,
)

#: flux-file column names (reference: ``lammps_flux_files.py:41-50``).
COLUMN_MAP = {
    mp.temperature: ["temp"],
    mp.time: ["time"],
    mp.thermal_flux: [f"c_flux_thermal[{i}]" for i in range(1, 4)],
    mp.stress_viscosity: ["pxy", "pxz", "pyz"],
}


class LAMMPSFluxFile(TabularTextReader):
    """Reader for LAMMPS log/flux output blocks."""

    def __init__(
        self,
        file_path,
        sample_rate: int,
        box_l: List[float],
        n_header_lines: int = 2,
        custom_data_map: Optional[Dict[str, List[str]]] = None,
    ):
        super().__init__(file_path, COLUMN_MAP, custom_data_map)
        self.sample_rate = sample_rate
        self.box_l = list(box_l)
        self.n_header_lines = n_header_lines

    def _get_spec(self) -> TabularReaderSpec:
        with open(self.file_path, "r") as f:
            skip_n_lines(f, self.n_header_lines)
            # Only the first contiguous data block is read (log files may
            # interleave further log text; reference behaves the same,
            # ``lammps_flux_files.py:100-110``).
            first = read_n_lines(f, 1)[0]
            n_cols = len(first.split())
            n_steps = 1
            for line in f:
                if len(line.split()) != n_cols:
                    break
                n_steps += 1
            f.seek(0)
            headers = read_n_lines(f, self.n_header_lines)
            prop_dict = extract_properties_from_header(
                headers[-1].split(), self._column_map
            )
        return TabularReaderSpec(
            n_configs=n_steps,
            species_to_line_idx={DatasetKeys.OBSERVABLES: [0]},
            property_to_column_idx=prop_dict,
            n_header_lines=self.n_header_lines,
            n_particles=1,
            header_lines_for_each_config=False,
            n_cols=n_cols,
        )

    def _get_metadata(self) -> TrajectoryMetadata:
        spec = self.spec
        return TrajectoryMetadata(
            n_configurations=spec.n_configs,
            species_list=species_list_from_spec(spec),
            box_l=self.box_l,
            sample_rate=self.sample_rate,
        )
