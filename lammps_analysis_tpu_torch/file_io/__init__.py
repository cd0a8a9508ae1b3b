"""Trajectory ingestion: readers for LAMMPS dump / extxyz / flux / gro /
DCD / TRR / chemfiles / memory."""
from .base import FileProcessor, assert_species_list_consistent  # noqa: F401
from .chemfiles_io import ChemfilesRead  # noqa: F401
from .dcd import DCDFile  # noqa: F401
from .extxyz import EXTXYZFile  # noqa: F401
from .gro import GROFile  # noqa: F401
from .lammps_dump import LAMMPSDumpFile  # noqa: F401
from .lammps_flux import LAMMPSFluxFile  # noqa: F401
from .script_input import ScriptInput  # noqa: F401
from .trr import TRRFile  # noqa: F401
