"""Reader abstraction: any trajectory source yields metadata + chunk stream.

Re-expresses ``mdsuite/file_io/file_read.py:35-95``: a ``FileProcessor``
announces :class:`TrajectoryMetadata` up front, then streams
:class:`TrajectoryChunkData` blocks; ``Experiment.add_data`` consumes both.
"""

from __future__ import annotations

import abc
from typing import Iterator

from ..database.contracts import TrajectoryChunkData, TrajectoryMetadata


class FileProcessor(abc.ABC):
    """Base class for all trajectory sources (files or in-memory)."""

    def __init__(self):
        self._metadata: TrajectoryMetadata | None = None

    @property
    def metadata(self) -> TrajectoryMetadata:
        """Cached metadata (readers scan headers only once)."""
        if self._metadata is None:
            self._metadata = self._get_metadata()
        return self._metadata

    @abc.abstractmethod
    def _get_metadata(self) -> TrajectoryMetadata:
        ...

    @abc.abstractmethod
    def get_configurations_generator(self) -> Iterator[TrajectoryChunkData]:
        """Yield time-contiguous chunks covering the whole trajectory."""

    def __str__(self) -> str:
        """Unique identification of this data source (ingestion ledger key)."""
        return f"{type(self).__name__}:{getattr(self, 'file_path', '')}"


def assert_species_list_consistent(meta_a, meta_b):
    """Check two metadata objects announce the same species layout.

    Reference analog: ``file_read.py:81-95``.
    """
    names_a = [(s.name, s.n_particles) for s in meta_a.species_list]
    names_b = [(s.name, s.n_particles) for s in meta_b.species_list]
    if names_a != names_b:
        raise ValueError(
            f"Inconsistent species lists between data sources: {names_a} vs {names_b}"
        )
