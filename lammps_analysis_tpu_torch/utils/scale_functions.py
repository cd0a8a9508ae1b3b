"""Calculator memory-cost models.

Used by the batch planner to estimate how many configurations fit in the
memory budget. Same capability as ``mdsuite/utils/scale_functions.py:30-116``.
Each function maps ``memory_usage`` (bytes per configuration) to the scaled
per-configuration footprint of a given calculator.
"""

from __future__ import annotations

import numpy as np


def linear_scale_function(memory_usage, scale_factor: int = 1):
    """Linear cost: ``memory * scale_factor``."""
    return memory_usage * scale_factor


def linearithmic_scale_function(memory_usage, scale_factor: int = 1):
    """n log n cost."""
    return scale_factor * memory_usage * np.log(np.maximum(memory_usage, 2.0))


def quadratic_scale_function(
    memory_usage, inner_scale_factor: int = 1, outer_scale_factor: int = 1
):
    """Quadratic cost: ``outer * (memory * inner)**2`` (pairwise kernels)."""
    return outer_scale_factor * (memory_usage * inner_scale_factor) ** 2


def polynomial_scale_function(
    memory_usage,
    inner_scale_factor: int = 1,
    outer_scale_factor: int = 1,
    order: int = 2,
):
    """General polynomial cost (triplet kernels use order=3)."""
    return outer_scale_factor * (memory_usage * inner_scale_factor) ** order


SCALE_FUNCTIONS = {
    "linear": linear_scale_function,
    "log-linear": linearithmic_scale_function,
    "quadratic": quadratic_scale_function,
    "polynomial": polynomial_scale_function,
}


def resolve_scale_function(spec: dict):
    """Resolve a ``{"linear": {"scale_factor": 2}}``-style spec.

    Returns ``(callable, kwargs)``. The spec format matches the reference's
    calculator ``scale_function`` attributes so cost models can be compared
    line by line.
    """
    if spec is None:
        return linear_scale_function, {}
    (name, kwargs), = spec.items()
    return SCALE_FUNCTIONS[name], dict(kwargs)
