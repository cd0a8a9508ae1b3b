"""RunComputation: the ``exp.run.X(...)`` / ``project.run.X(...)`` hub.

Counterpart of ``lammps_analysis_tpu/experiment/run.py`` over the port's
calculator and transformation registries: every ported calculator and
transformation is an attribute; a transformation invoked through the hub
runs on every bound experiment.
"""

from __future__ import annotations

from typing import List, Optional


def _calculator_registry():
    """name -> class for every ported calculator (built lazily to avoid cycles)."""
    from ..calculators import ALL_CALCULATORS

    return ALL_CALCULATORS


def _transformation_registry():
    from ..transformations.registry import ALL_TRANSFORMATIONS

    return ALL_TRANSFORMATIONS


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
        trafos = _transformation_registry()
        if name in trafos:
            cls = trafos[name]

            def run_trafo(species=None, **kwargs):
                trafo = cls(**kwargs)
                for exp in self.experiments:
                    exp.cls_transformation_run(trafo, species=species)

            return run_trafo
        raise AttributeError(
            f"No calculator or transformation named {name!r} in the PyTorch "
            f"port. Ported calculators: {sorted(calcs)}; transformations: "
            f"{sorted(trafos)}."
        )

    def __dir__(self):
        return sorted(
            set(super().__dir__())
            | set(_calculator_registry())
            | set(_transformation_registry())
        )
