"""Canonical registry of trajectory properties.

Every tensor stored in the trajectory store is one of these named properties
with a fixed trailing dimension. Mirrors the capability of the reference
registry (``mdsuite/database/mdsuite_properties.py:33-87``) — names are kept
identical so stores and results remain conceptually interchangeable.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, eq=True)
class PropertyInfo:
    """Name and trailing dimensionality of a stored property.

    Reference data contract: ``mdsuite/database/simulation_database.py:43-62``.
    """

    name: str
    n_dims: int

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.name


@dataclasses.dataclass(frozen=True)
class _Properties:
    """The canonical property set (one attribute per storable property)."""

    # per-atom kinematics
    positions = PropertyInfo("Positions", 3)
    scaled_positions = PropertyInfo("Scaled_Positions", 3)
    unwrapped_positions = PropertyInfo("Unwrapped_Positions", 3)
    scaled_unwrapped_positions = PropertyInfo("Scaled_Unwrapped_Positions", 3)
    velocities = PropertyInfo("Velocities", 3)
    velocities_from_positions = PropertyInfo("Velocities_From_Positions", 3)
    forces = PropertyInfo("Forces", 3)
    box_images = PropertyInfo("Box_Images", 3)
    momenta = PropertyInfo("Momenta", 3)
    torque = PropertyInfo("Torque", 3)
    angular_velocity_spherical = PropertyInfo("Angular_Velocity_Spherical", 3)
    angular_velocity_non_spherical = PropertyInfo(
        "Angular_Velocity_Non_Spherical", 3
    )
    dipole_orientation_magnitude = PropertyInfo("Dipole_Orientation_Magnitude", 3)

    # per-atom scalars
    charge = PropertyInfo("Charge", 1)
    masses = PropertyInfo("Masses", 1)
    kinetic_energy = PropertyInfo("Kinetic_Energy", 1)
    potential_energy = PropertyInfo("Potential_Energy", 1)
    energy = PropertyInfo("Energy", 1)
    temperature = PropertyInfo("Temperature", 1)

    # per-atom tensors
    stress = PropertyInfo("Stress", 6)

    # system-wide time series (stored under the Observables group)
    thermal_flux = PropertyInfo("Thermal_Flux", 3)
    stress_viscosity = PropertyInfo("Stress_Visc", 3)
    momentum_flux = PropertyInfo("Momentum_Flux", 3)
    ionic_current = PropertyInfo("Ionic_Current", 3)
    translational_dipole_moment = PropertyInfo("Translational_Dipole_Moment", 3)
    integrated_heat_current = PropertyInfo("Integrated_Heat_Current", 3)
    kinaci_heat_current = PropertyInfo("Kinaci_Heat_Current", 3)
    time = PropertyInfo("Time", 1)

    # metadata pseudo-properties (resolved from experiment attributes, not the
    # store; see transformations.base input-resolution cascade)
    box_length = PropertyInfo("Box_Array", 3)
    time_step = PropertyInfo("Time_Step", 1)
    sample_rate = PropertyInfo("Sample_Rate", 1)


mdsuite_properties = _Properties()
properties = mdsuite_properties  # preferred alias for new code


def property_by_name(name: str) -> PropertyInfo:
    """Look up a canonical property by stored name."""
    for field in vars(type(properties)).values():
        if isinstance(field, PropertyInfo) and field.name == name:
            return field
    raise KeyError(f"Unknown property name {name!r}")
