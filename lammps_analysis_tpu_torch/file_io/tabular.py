"""Shared engine for tabular text trajectory formats (the LAMMPS dump).

Counterpart of ``lammps_analysis_tpu/file_io/tabular.py``, native route only:
a batch of configurations is read as one raw byte block, configuration
boundaries are found by the native newline counter, and the block is parsed
by ``native/table_parser.cpp`` (``native_parser.py``) straight into
per-(species, property) float32 buffers, rows placed by their atom id. A
block whose ids are not 1..N is parsed whole into float64 and sorted on the
host. The JAX package's pandas engine, its fallback when the native parser
cannot be built, has no counterpart: a reader needs ``n_cols``, and a
parser that does not build raises.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..database.contracts import SpeciesInfo, TrajectoryChunkData
from ..database.properties import PropertyInfo
from ..utils.meta import optimize_batch_size
from . import native_parser
from .base import FileProcessor


@dataclasses.dataclass
class TabularReaderSpec:
    """Everything the shared engine needs to slice a tabular file.

    Reference analog: ``TabularTextFileReaderMData``
    (``tabular_text_files.py:16-54``).
    """

    n_configs: int
    species_to_line_idx: Dict[str, List[int]]  # rows (after id-sort) per species
    property_to_column_idx: Dict[str, List[int]]
    n_header_lines: int
    n_particles: int
    header_lines_for_each_config: bool = True
    sort_by_column_idx: Optional[int] = None
    n_cols: Optional[int] = None  # columns of an atom row (the native parser needs it)


def extract_properties_from_header(
    header_names: List[str], column_map: Dict[PropertyInfo, List[str]]
) -> Dict[str, List[int]]:
    """Map canonical property names -> column indices present in the file.

    Reference analog: ``lammps_trajectory_files.py:245-298``. A property is
    included only if *all* its component columns are present.
    """
    col_idx = {name: i for i, name in enumerate(header_names)}
    out = {}
    for prop, names in column_map.items():
        if all(n in col_idx for n in names):
            out[prop.name] = [col_idx[n] for n in names]
    return out


def species_list_from_spec(spec: TabularReaderSpec) -> List[SpeciesInfo]:
    """Build the species list announced to the store from a reader spec."""
    props = [
        PropertyInfo(name, len(cols))
        for name, cols in spec.property_to_column_idx.items()
    ]
    return [
        SpeciesInfo(name=name, n_particles=len(rows), properties=props)
        for name, rows in spec.species_to_line_idx.items()
    ]


class TabularTextReader(FileProcessor):
    """Base reader for text files laid out as per-configuration row blocks."""

    #: bytes read from the file per block
    READ_SIZE = 32 * 2**20

    def __init__(
        self,
        file_path,
        column_map: Dict[PropertyInfo, List[str]],
        custom_column_map: Optional[Dict[str, List[str]]] = None,
    ):
        super().__init__()
        self.file_path = str(file_path)
        self._column_map = dict(column_map)
        if custom_column_map:
            for name, cols in custom_column_map.items():
                self._column_map[PropertyInfo(name, len(cols))] = cols
        self._spec: TabularReaderSpec | None = None
        self._scatter_layout: native_parser.ScatterLayout | None = None
        self._flat_idx_cache = None

    # -- format-specific ------------------------------------------------------
    def _get_spec(self) -> TabularReaderSpec:
        raise NotImplementedError

    @property
    def spec(self) -> TabularReaderSpec:
        if self._spec is None:
            self._spec = self._get_spec()
        return self._spec

    # -- shared engine --------------------------------------------------------
    def get_configurations_generator(self) -> Iterator[TrajectoryChunkData]:
        """Byte-block streaming through the C++ parser.

        Raw blocks are read with ``f.read`` (no Python per-line iteration);
        config boundaries are located by the native newline counter, then
        the block parses in native code.
        """
        spec = self.spec
        if spec.n_cols is None:
            raise ValueError(
                f"{self.file_path}: the reader spec has no column count; the "
                "native parser needs one"
            )
        species_list = species_list_from_spec(spec)
        batch_size = optimize_batch_size(self.file_path, spec.n_configs)
        n_header = spec.n_header_lines if spec.header_lines_for_each_config else 0
        lines_per_config = spec.n_particles + n_header

        with open(self.file_path, "rb") as f:
            if not spec.header_lines_for_each_config:
                for _ in range(spec.n_header_lines):
                    f.readline()
            leftover = b""
            n_read = 0
            at_eof = False
            while n_read < spec.n_configs:
                block = leftover + f.read(self.READ_SIZE)
                if not block:
                    raise EOFError(
                        f"{self.file_path}: ended after {n_read} of "
                        f"{spec.n_configs} configurations"
                    )
                if len(block) < len(leftover) + self.READ_SIZE:
                    at_eof = True
                    if not block.endswith(b"\n"):
                        block += b"\n"
                n_lines = native_parser.count_newlines(block)
                complete = min(
                    n_lines // lines_per_config,
                    batch_size,
                    spec.n_configs - n_read,
                )
                if complete == 0:
                    if at_eof:
                        raise EOFError(
                            f"{self.file_path}: truncated configuration at "
                            f"index {n_read}"
                        )
                    leftover = block
                    continue
                consumed = native_parser.offset_after_nth_newline(
                    block, complete * lines_per_config
                )
                chunk = self._native_scatter_chunk(
                    block[:consumed], complete, n_header, species_list
                )
                if chunk is None:
                    data = native_parser.parse_table_block(
                        block[:consumed], complete, n_header,
                        spec.n_particles, spec.n_cols,
                        id_col=spec.sort_by_column_idx,
                    )
                    chunk = self._chunk_from_array(data, species_list)
                leftover = block[consumed:]
                n_read += complete
                yield chunk

    def _native_scatter_chunk(self, block, n_configs, n_header, species_list):
        """Fused native parse straight into per-(species, property) f32
        chunk buffers (one pass, one copy, store dtype: see
        ``native/table_parser.cpp::parse_scatter_f32``). Returns ``None``
        when the block's atom ids are not 1..N."""
        spec = self.spec
        if self._scatter_layout is None:
            # properties are spec-global: every species carries the same
            # property -> column map, so one prop order serves all
            prop_order = list(
                dict.fromkeys(p.name for sp in species_list for p in sp.properties)
            )
            self._scatter_layout = native_parser.ScatterLayout(
                spec.species_to_line_idx,
                spec.property_to_column_idx,
                [sp.name for sp in species_list],
                prop_order,
            )
        bufs = native_parser.parse_scatter_f32(
            block, n_configs, n_header, spec.n_particles, spec.n_cols,
            self._scatter_layout, id_col=spec.sort_by_column_idx,
        )
        if bufs is None:
            return None
        chunk = TrajectoryChunkData(species_list, n_configs)
        for sp in species_list:
            for prop in sp.properties:
                chunk.attach_data(bufs[(sp.name, prop.name)], sp.name, prop.name)
        return chunk

    def _flat_gather_indices(self, species_list):
        """Per-(species, property) flat indices into a ``(N * C,)`` plane:
        one fancy gather per output array. Cached: the layout is fixed per
        spec."""
        if self._flat_idx_cache is None:
            spec = self.spec
            cache = {}
            for sp in species_list:
                rows = np.asarray(spec.species_to_line_idx[sp.name], dtype=np.intp)
                for prop in sp.properties:
                    cols = np.asarray(
                        spec.property_to_column_idx[prop.name], dtype=np.intp
                    )
                    cache[(sp.name, prop.name)] = (
                        rows[:, None] * spec.n_cols + cols[None, :]
                    ).ravel()
            self._flat_idx_cache = cache
        return self._flat_idx_cache

    def _chunk_from_array(self, data: np.ndarray, species_list):
        """Slice an id-sorted ``(T, N, n_cols)`` block into a chunk."""
        idx_cache = self._flat_gather_indices(species_list)
        t, n, c = data.shape
        flat = data.reshape(t, n * c)
        chunk = TrajectoryChunkData(species_list, t)
        for sp in species_list:
            for prop in sp.properties:
                arr = flat[:, idx_cache[(sp.name, prop.name)]].reshape(t, -1, prop.n_dims)
                chunk.attach_data(arr, sp.name, prop.name)
        return chunk


def read_n_lines(f, n: int) -> List[str]:
    lines = list(itertools.islice(f, n))
    if len(lines) < n:
        raise EOFError(f"Expected {n} lines, file ended after {len(lines)}")
    return lines


def skip_n_lines(f, n: int) -> None:
    for _ in itertools.islice(f, n):
        pass
