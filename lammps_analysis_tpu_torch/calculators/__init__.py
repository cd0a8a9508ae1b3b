"""Calculators: observables computed from stored trajectories.

Every calculator of the JAX package: the radial and angular distribution
functions, the RDF post-processing (coordination numbers, potential of mean
force, Kirkwood-Buff integrals, structure factor), the Einstein and
Green-Kubo self- and distinct diffusion coefficients, Nernst-Einstein, the
seven system (conductivity, thermal conductivity, viscosity) calculators and
the spatial distribution function.
"""
from .angular_distribution_function import AngularDistributionFunction  # noqa: F401
from .base import Calculator, TrajectoryCalculator  # noqa: F401
from .distinct_diffusion_coefficients import (  # noqa: F401
    EinsteinDistinctDiffusionCoefficients,
    GreenKuboDistinctDiffusionCoefficients,
)
from .einstein_diffusion_coefficients import EinsteinDiffusionCoefficients  # noqa: F401
from .green_kubo_diffusion_coefficients import GreenKuboDiffusionCoefficients  # noqa: F401
from .post_processing import (  # noqa: F401
    CoordinationNumbers,
    KirkwoodBuffIntegral,
    NernstEinsteinIonicConductivity,
    PotentialOfMeanForce,
    StructureFactor,
)
from .radial_distribution_function import RadialDistributionFunction  # noqa: F401
from .spatial_distribution_function import SpatialDistributionFunction  # noqa: F401
from .system_calculators import (  # noqa: F401
    EinsteinHelfandIonicConductivity,
    EinsteinHelfandThermalConductivity,
    EinsteinHelfandThermalKinaci,
    GreenKuboIonicConductivity,
    GreenKuboThermalConductivity,
    GreenKuboViscosity,
    GreenKuboViscosityFlux,
)

ALL_CALCULATORS = {
    cls.__name__: cls
    for cls in (
        RadialDistributionFunction,
        AngularDistributionFunction,
        EinsteinDiffusionCoefficients,
        GreenKuboDiffusionCoefficients,
        EinsteinDistinctDiffusionCoefficients,
        GreenKuboDistinctDiffusionCoefficients,
        CoordinationNumbers,
        PotentialOfMeanForce,
        KirkwoodBuffIntegral,
        StructureFactor,
        NernstEinsteinIonicConductivity,
        GreenKuboIonicConductivity,
        EinsteinHelfandIonicConductivity,
        GreenKuboThermalConductivity,
        EinsteinHelfandThermalConductivity,
        EinsteinHelfandThermalKinaci,
        GreenKuboViscosity,
        GreenKuboViscosityFlux,
        SpatialDistributionFunction,
    )
}
