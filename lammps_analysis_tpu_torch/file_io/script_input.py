"""In-memory trajectory source (the universal test fixture).

Port of ``mdsuite/file_io/script_input.py:8-45``: wraps one
:class:`TrajectoryChunkData` + its metadata under a user-chosen unique name
so synthetic data can be pushed through the exact ingestion path files use.
"""

from __future__ import annotations

from typing import Iterator

from ..database.contracts import TrajectoryChunkData, TrajectoryMetadata
from .base import FileProcessor


class ScriptInput(FileProcessor):
    """Feed in-memory arrays through the ingestion pipeline."""

    def __init__(
        self, data: TrajectoryChunkData, metadata: TrajectoryMetadata, name: str
    ):
        super().__init__()
        self.data = data
        self._meta = metadata
        self.name = name

    def _get_metadata(self) -> TrajectoryMetadata:
        return self._meta

    def get_configurations_generator(self) -> Iterator[TrajectoryChunkData]:
        yield self.data

    def __str__(self) -> str:
        return f"ScriptInput:{self.name}"
