"""Calculators: observables computed from stored trajectories.

This slice of the port carries the radial distribution function; the JAX
package's other calculators are later slices (see ROADMAP.md).
"""
from .base import Calculator, TrajectoryCalculator  # noqa: F401
from .radial_distribution_function import RadialDistributionFunction  # noqa: F401

ALL_CALCULATORS = {cls.__name__: cls for cls in (RadialDistributionFunction,)}
