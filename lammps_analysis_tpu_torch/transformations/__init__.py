"""Transformations: derived per-frame tensors written back to the store.

The port carries the coordinate and flux transformations and
``MolecularMap``.
"""
from .base import Transformation  # noqa: F401
from .coordinate_transforms import (  # noqa: F401
    CoordinateUnwrapper,
    CoordinateWrapper,
    ScaleCoordinates,
    UnwrapViaIndices,
    VelocityFromPositions,
)
from .flux_transforms import (  # noqa: F401
    IntegratedHeatCurrent,
    IonicCurrent,
    KinaciIntegratedHeatCurrent,
    MomentumFlux,
    ThermalFlux,
    TranslationalDipoleMoment,
)
from .map_molecules import MolecularMap  # noqa: F401
from .registry import (  # noqa: F401
    ALL_TRANSFORMATIONS,
    PROPERTY_TO_TRANSFORMATION,
    transformation_for_property,
)
