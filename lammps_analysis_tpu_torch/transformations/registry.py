"""Property -> producing-transformation registry.

Counterpart of ``lammps_analysis_tpu/transformations/registry.py`` for the
coordinate and flux transformations and ``MolecularMap`` (reference:
``mdsuite/transformations/transformation_dict.py:46-62``). It drives the
automatic dependency resolution of calculators and transformations.
"""

from __future__ import annotations

from .coordinate_transforms import (
    CoordinateUnwrapper,
    CoordinateWrapper,
    ScaleCoordinates,
    UnwrapViaIndices,
    VelocityFromPositions,
)
from .flux_transforms import (
    IntegratedHeatCurrent,
    IonicCurrent,
    KinaciIntegratedHeatCurrent,
    MomentumFlux,
    ThermalFlux,
    TranslationalDipoleMoment,
)
from .map_molecules import MolecularMap

#: property name -> transformation classes able to produce it, in
#: preference order (the store-aware chooser below picks directly, so the
#: static order only matters for context-free callers)
PROPERTY_TO_TRANSFORMATION = {
    "Unwrapped_Positions": [CoordinateUnwrapper, UnwrapViaIndices],
    "Positions": [ScaleCoordinates, CoordinateWrapper],
    "Velocities_From_Positions": [VelocityFromPositions],
    "Ionic_Current": [IonicCurrent],
    "Translational_Dipole_Moment": [TranslationalDipoleMoment],
    "Thermal_Flux": [ThermalFlux],
    "Integrated_Heat_Current": [IntegratedHeatCurrent],
    "Kinaci_Heat_Current": [KinaciIntegratedHeatCurrent],
    "Momentum_Flux": [MomentumFlux],
}

ALL_TRANSFORMATIONS = {
    cls.__name__: cls
    for cls in (
        CoordinateUnwrapper,
        UnwrapViaIndices,
        CoordinateWrapper,
        ScaleCoordinates,
        VelocityFromPositions,
        IonicCurrent,
        TranslationalDipoleMoment,
        ThermalFlux,
        IntegratedHeatCurrent,
        KinaciIntegratedHeatCurrent,
        MomentumFlux,
        MolecularMap,
    )
}


def transformation_for_property(
    prop_name: str, experiment=None, species: str = None
):
    """Instantiate the preferred producer of ``prop_name`` (or None).

    With experiment context the choice is store-aware, the acyclic
    equivalent of the reference's try-each-candidate fallback
    (``transformations.py:366-381``): a producer is only chosen when its own
    per-config source is stored (or derivable without cycling back through
    ``prop_name``). Unwrapping prefers the dump's own image counters when
    they are stored (reference ``_unwrap_choice``,
    ``calculators/trajectory_calculator.py:181-194``). Without it, a
    scaled-coordinates-only store would recurse forever: Positions ->
    CoordinateWrapper needs Unwrapped_Positions -> CoordinateUnwrapper needs
    Positions -> ...
    """
    classes = PROPERTY_TO_TRANSFORMATION.get(prop_name)
    if not classes:
        return None
    if experiment is not None and species is not None:
        def stored(name: str) -> bool:
            return experiment.store.check_existence(f"{species}/{name}")

        if prop_name == "Unwrapped_Positions":
            if stored("Box_Images"):
                return UnwrapViaIndices()
            # CoordinateUnwrapper consumes Positions: stored, or acyclically
            # derivable from Scaled_Positions via ScaleCoordinates
            if stored("Positions") or stored("Scaled_Positions"):
                return CoordinateUnwrapper()
            return None
        if prop_name == "Positions":
            if stored("Scaled_Positions"):
                return ScaleCoordinates()
            if stored("Unwrapped_Positions"):
                return CoordinateWrapper()
            return None
    return classes[0]()
