"""Transformations: derived per-frame tensors written back to the store.

The port carries the coordinate transformations; the JAX package's flux
transformations and ``MolecularMap`` are a later slice (see ROADMAP.md).
"""
from .base import Transformation  # noqa: F401
from .coordinate_transforms import (  # noqa: F401
    CoordinateUnwrapper,
    CoordinateWrapper,
    ScaleCoordinates,
    UnwrapViaIndices,
    VelocityFromPositions,
)
from .registry import (  # noqa: F401
    ALL_TRANSFORMATIONS,
    PROPERTY_TO_TRANSFORMATION,
    transformation_for_property,
)
