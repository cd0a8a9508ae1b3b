"""Data contracts between readers, the trajectory store, and the pipeline.

Same capability as the reference contracts
(``mdsuite/database/simulation_database.py:43-227``), with one deliberate
layout change: chunks are stored ``(time, atoms, dims)`` — time leading —
which is the natural layout for device streaming (a batch of frames is one
contiguous host-to-device copy; the reference kept time on axis 1 and carried an explicit workaround,
``simulation_database.py:344-367``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .properties import PropertyInfo


@dataclasses.dataclass(frozen=True, eq=True)
class SpeciesInfo:
    """Static description of one species in an experiment.

    Reference: ``mdsuite/database/simulation_database.py:65-99``.
    """

    name: str
    n_particles: int
    properties: tuple = ()  # tuple[PropertyInfo]
    mass: float = 0.0
    charge: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "properties", tuple(self.properties))

    @property
    def property_names(self):
        return [p.name for p in self.properties]


@dataclasses.dataclass(frozen=True, eq=True)
class MoleculeInfo(SpeciesInfo):
    """A mapped molecule 'species'; ``groups`` maps molecule index -> the
    constituent atom indices per atomic species.

    Reference: ``mdsuite/database/simulation_database.py:102-127``.
    """

    groups: tuple = ()  # tuple[(mol_idx, {species: [atom indices]})]


@dataclasses.dataclass
class TrajectoryMetadata:
    """Everything the store must know before ingesting a trajectory.

    Reference: ``mdsuite/database/simulation_database.py:130-169``.
    """

    n_configurations: int
    species_list: List[SpeciesInfo]
    box_l: Optional[List[float]] = None
    sample_rate: Optional[int] = None
    sample_step: Optional[float] = None
    temperature: Optional[float] = None
    simulation_time: Optional[float] = None

    @property
    def species_names(self):
        return [sp.name for sp in self.species_list]


class TrajectoryChunkData:
    """An in-memory chunk of trajectory data for a contiguous block of frames.

    Layout: per (species, property) an array of shape
    ``(chunk_size, n_particles, n_dims)`` — time leading (see module note).

    Reference analog: ``mdsuite/database/simulation_database.py:172-227``
    (which stores ``(n_particles, chunk_size, n_dims)``).
    """

    def __init__(self, species_list: List[SpeciesInfo], chunk_size: int):
        self.chunk_size = int(chunk_size)
        self.species_list = list(species_list)
        self._data = {}
        for sp in self.species_list:
            self._data[sp.name] = {
                prop.name: np.zeros((chunk_size, sp.n_particles, prop.n_dims))
                for prop in sp.properties
            }

    def add_data(
        self,
        data: np.ndarray,
        config_idx: int,
        species_name: str,
        property_name: str,
    ) -> None:
        """Write ``data`` of shape ``(n_frames, n_particles, n_dims)`` starting
        at frame ``config_idx`` within the chunk.
        """
        data = np.asarray(data)
        n = data.shape[0]
        self._data[species_name][property_name][config_idx : config_idx + n] = data

    def attach_data(
        self, data: np.ndarray, species_name: str, property_name: str
    ) -> None:
        """Adopt ``data`` as the full chunk buffer for (species, property).

        Zero-copy fast path for readers that already assembled the final
        ``(chunk_size, n_particles, n_dims)`` array (the flat-gather path
        in ``file_io/tabular.py`` — ``add_data`` would copy it a second
        time). The array is adopted by reference; callers must not mutate
        it afterwards.
        """
        data = np.asarray(data)
        expected = self._data[species_name][property_name].shape
        if data.shape != expected:
            raise ValueError(
                f"attach_data expects the full chunk shape {expected}, "
                f"got {data.shape}"
            )
        self._data[species_name][property_name] = data

    def get_data(self, species_name: str, property_name: str) -> np.ndarray:
        return self._data[species_name][property_name]

    @property
    def species_names(self):
        return [sp.name for sp in self.species_list]

    def __eq__(self, other):
        if not isinstance(other, TrajectoryChunkData):
            return NotImplemented
        if self.chunk_size != other.chunk_size:
            return False
        if self.species_list != other.species_list:
            return False
        for sp in self.species_list:
            for prop in sp.properties:
                if not np.array_equal(
                    self.get_data(sp.name, prop.name),
                    other.get_data(sp.name, prop.name),
                ):
                    return False
        return True
