"""Module-path alias: the reference exposes the chemfiles reader as
``mdsuite.file_io.chemfiles_read`` and its notebooks import it by that
path (``examples/notebooks/Mapping_Molecules.ipynb``). The implementation
lives in :mod:`lammps_analysis_tpu_torch.file_io.chemfiles_io`."""

from .chemfiles_io import ChemfilesRead  # noqa: F401
