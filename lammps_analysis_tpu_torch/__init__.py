"""lammps_analysis_tpu_torch — the PyTorch/CUDA port of lammps_analysis_tpu.

The JAX package (``lammps_analysis_tpu``) stays the reference; this package
grows beside it slice by slice and imports neither it nor jax. It carries
ingestion of LAMMPS dumps (through the native table parser) and in-memory
sources into an npy trajectory store,
``exp.run.RadialDistributionFunction(...)`` on the pair-distance histogram
(``csrc/rdf_histogram.cu``) and ``exp.run.AngularDistributionFunction(...)``
on the neighbor extract and the angle histogram
(``csrc/adf_neighbor_cells.cu``, ``csrc/adf_neighbor_extract.cu``,
``csrc/adf_pairs_histogram.cu``): CUDA kernels written by hand for Hopper,
each with a plain torch version beside it. The coordinate transformations
and ``exp.run.EinsteinDiffusionCoefficients(...)`` /
``exp.run.GreenKuboDiffusionCoefficients(...)`` run as torch ops (the JAX
package runs them on XLA ops, no Pallas kernel). So do the other calculators,
``exp.time_series.*``, the plots of ``plot=True`` and ``exp.run_visualization``
(self-contained HTML, and PNG where matplotlib imports), ``Report`` and the
profiling hooks (``utils/profiling.py``).

Device-side work runs on ``torch.device(config.device)``, ``"cuda"`` by
default; set ``config.device = "cpu"`` for the plain torch path.
"""

from __future__ import annotations

import logging

from .utils import units
from .utils.config import config
from .utils.molecule import Molecule

_LAZY = {
    "Project": ("lammps_analysis_tpu_torch.project.project", "Project"),
    "Experiment": ("lammps_analysis_tpu_torch.experiment.experiment", "Experiment"),
    "Report": ("lammps_analysis_tpu_torch.utils.report", "Report"),
}


def __getattr__(name):
    """Lazy top-level imports (keeps ``import lammps_analysis_tpu_torch`` light)."""
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Project", "Experiment", "Molecule", "Report", "units", "config"]

__version__ = "0.1.0"

_log = logging.getLogger(__name__)
if not _log.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(message)s"))
    _log.addHandler(_handler)
    _log.setLevel(logging.INFO)
