"""RunComputation: the ``exp.run.X(...)`` / ``project.run.X(...)`` hub.

Counterpart of ``lammps_analysis_tpu/experiment/run.py`` over the port's
calculator registry. Transformations are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional


def _calculator_registry():
    """name -> class for every ported calculator (built lazily to avoid cycles)."""
    from ..calculators import ALL_CALCULATORS

    return ALL_CALCULATORS


class RunComputation:
    """Dispatch hub bound to one experiment or a list of experiments."""

    def __init__(self, experiment=None, experiments: Optional[List] = None):
        self.experiment = experiment
        self.experiments = experiments or ([experiment] if experiment else [])

    def __getattr__(self, name: str):
        calcs = _calculator_registry()
        if name in calcs:
            # a project-bound hub has experiment=None: the calculator then
            # returns {experiment_name: Computation}
            return calcs[name](
                experiment=self.experiment,
                experiments=self.experiments,
            )
        raise AttributeError(
            f"No calculator named {name!r} in the PyTorch port. Ported: "
            f"{sorted(calcs)}; the rest of the JAX package's calculators and "
            "its transformations are later slices."
        )

    def __dir__(self):
        return sorted(set(super().__dir__()) | set(_calculator_registry()))
