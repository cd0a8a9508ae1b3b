"""Trajectory sources: the LAMMPS dump and flux readers and in-memory
``ScriptInput``.

The JAX package's other readers (extxyz, gro, dcd, trr, chemfiles) are later
slices of the port."""
from .base import FileProcessor, assert_species_list_consistent  # noqa: F401
from .lammps_dump import LAMMPSDumpFile  # noqa: F401
from .lammps_flux import LAMMPSFluxFile  # noqa: F401
from .script_input import ScriptInput  # noqa: F401
