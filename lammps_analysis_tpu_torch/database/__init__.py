"""Storage layer: trajectory store (npy) + results/provenance DB (SQLite)."""
from .contracts import (  # noqa: F401
    MoleculeInfo,
    SpeciesInfo,
    TrajectoryChunkData,
    TrajectoryMetadata,
)
from .properties import PropertyInfo, mdsuite_properties, properties  # noqa: F401
from .results_db import Computation, ResultsDatabase  # noqa: F401
from .trajectory_store import TrajectoryStore, join_path  # noqa: F401
