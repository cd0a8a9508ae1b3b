"""Physical constants and unit systems.

Copied unchanged from ``lammps_analysis_tpu/utils/units.py`` (numpy-free,
jax-free), which re-implements the MDSuite unit layer
(``mdsuite/utils/units.py:27-98``). Values are CODATA-2018
physical constants (public data); the LAMMPS unit-system conversion factors
follow the LAMMPS documentation for the ``real``/``metal``/``si`` styles.

A :class:`UnitSystem` carries multiplicative factors that convert a quantity
expressed in simulation units into SI. E.g. for LAMMPS ``metal`` units,
``length = 1e-10`` (Angstrom -> m) and ``time = 1e-12`` (ps -> s).
"""

from __future__ import annotations

import dataclasses

# --- SI defining / CODATA constants ------------------------------------------------
standard_state_pressure = 1.0e5  # Pa
avogadro_constant = 6.02214076e23  # 1/mol
elementary_charge = 1.602176634e-19  # C
boltzmann_constant = 1.380649e-23  # J/K
planck_constant = 6.62607015e-34  # J/Hz
reduced_planck_constant = 1.054571817e-34  # J s
speed_of_light = 299792458.0  # m/s
standard_gravity = 9.80665  # m/s^2
atmosphere = 101325.0  # Pa
golden_ratio = 1.618033988749895


@dataclasses.dataclass(frozen=True)
class UnitSystem:
    """Multiplicative simulation-unit -> SI conversion factors.

    Mirrors the capability of the reference ``Units`` dataclass
    (``mdsuite/utils/units.py:45-62``): ``boltzmann`` is Boltzmann's constant
    expressed *in* the simulation unit system (used by thermal/viscosity
    prefactors), ``NkTV2p`` is the LAMMPS pressure conversion constant.
    """

    name: str
    time: float  # sim time unit in s
    length: float  # sim length unit in m
    energy: float  # sim energy unit in J
    NkTV2p: float
    boltzmann: float  # k_B in sim units
    temperature: float = 1.0  # sim temperature unit in K
    pressure: float = 1.0  # sim pressure unit in Pa
    avogadro: float = avogadro_constant
    elementary_charge: float = elementary_charge

    @property
    def volume(self) -> float:
        """Sim volume unit in m^3."""
        return self.length**3


#: LAMMPS ``units real`` — fs, Angstrom, kcal/mol.
REAL = UnitSystem(
    name="real",
    time=1e-15,
    length=1e-10,
    energy=4184.0 / avogadro_constant,
    NkTV2p=68568.415,
    boltzmann=0.0019872067,
    temperature=1.0,
    pressure=atmosphere,
)

#: LAMMPS ``units metal`` — ps, Angstrom, eV.
METAL = UnitSystem(
    name="metal",
    time=1e-12,
    length=1e-10,
    energy=1.6022e-19,
    NkTV2p=1.6021765e6,
    boltzmann=8.617343e-5,
    temperature=1.0,
    pressure=1.0e5,
)

#: Plain SI units.
SI = UnitSystem(
    name="si",
    time=1.0,
    length=1.0,
    energy=1.0,
    NkTV2p=boltzmann_constant,
    boltzmann=boltzmann_constant,
    temperature=1.0,
    pressure=1.0,
)

units_dict = {"real": REAL, "metal": METAL, "si": SI}


def resolve_units(units) -> UnitSystem:
    """Accept a name (``"metal"``) or a :class:`UnitSystem` and return the latter."""
    if isinstance(units, UnitSystem):
        return units
    try:
        return units_dict[str(units).lower()]
    except KeyError as err:
        raise ValueError(
            f"Unknown unit system {units!r}; choose from {sorted(units_dict)} "
            "or pass a UnitSystem instance."
        ) from err
