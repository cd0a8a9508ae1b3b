"""Calculators: observables computed from stored trajectories.

The port carries the radial and angular distribution functions and the
Einstein and Green-Kubo self-diffusion coefficients so far; the JAX
package's other calculators are later slices (see ROADMAP.md).
"""
from .angular_distribution_function import AngularDistributionFunction  # noqa: F401
from .base import Calculator, TrajectoryCalculator  # noqa: F401
from .einstein_diffusion_coefficients import EinsteinDiffusionCoefficients  # noqa: F401
from .green_kubo_diffusion_coefficients import GreenKuboDiffusionCoefficients  # noqa: F401
from .radial_distribution_function import RadialDistributionFunction  # noqa: F401

ALL_CALCULATORS = {
    cls.__name__: cls
    for cls in (
        RadialDistributionFunction,
        AngularDistributionFunction,
        EinsteinDiffusionCoefficients,
        GreenKuboDiffusionCoefficients,
    )
}
