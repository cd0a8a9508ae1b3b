"""Element reference data: standard atomic weights (u) and covalent radii (Å).

Replaces the reference's bundled PubChem table
(``mdsuite/data/PubChemElements_all.json`` used via
``experiment/experiment.py:642``) with an in-code table of IUPAC standard
atomic weights (2021 abridged values, public data). Radii are Cordero-style
covalent radii used for bond-cutoff heuristics in molecule mapping.
"""

from __future__ import annotations

ATOMIC_MASSES = {
    "H": 1.008, "He": 4.0026, "Li": 6.94, "Be": 9.0122, "B": 10.81,
    "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998, "Ne": 20.180,
    "Na": 22.990, "Mg": 24.305, "Al": 26.982, "Si": 28.085, "P": 30.974,
    "S": 32.06, "Cl": 35.45, "Ar": 39.95, "K": 39.098, "Ca": 40.078,
    "Sc": 44.956, "Ti": 47.867, "V": 50.942, "Cr": 51.996, "Mn": 54.938,
    "Fe": 55.845, "Co": 58.933, "Ni": 58.693, "Cu": 63.546, "Zn": 65.38,
    "Ga": 69.723, "Ge": 72.630, "As": 74.922, "Se": 78.971, "Br": 79.904,
    "Kr": 83.798, "Rb": 85.468, "Sr": 87.62, "Y": 88.906, "Zr": 91.224,
    "Nb": 92.906, "Mo": 95.95, "Tc": 97.0, "Ru": 101.07, "Rh": 102.91,
    "Pd": 106.42, "Ag": 107.87, "Cd": 112.41, "In": 114.82, "Sn": 118.71,
    "Sb": 121.76, "Te": 127.60, "I": 126.90, "Xe": 131.29, "Cs": 132.91,
    "Ba": 137.33, "La": 138.91, "Ce": 140.12, "Pr": 140.91, "Nd": 144.24,
    "Pm": 145.0, "Sm": 150.36, "Eu": 151.96, "Gd": 157.25, "Tb": 158.93,
    "Dy": 162.50, "Ho": 164.93, "Er": 167.26, "Tm": 168.93, "Yb": 173.05,
    "Lu": 174.97, "Hf": 178.49, "Ta": 180.95, "W": 183.84, "Re": 186.21,
    "Os": 190.23, "Ir": 192.22, "Pt": 195.08, "Au": 196.97, "Hg": 200.59,
    "Tl": 204.38, "Pb": 207.2, "Bi": 208.98, "Po": 209.0, "At": 210.0,
    "Rn": 222.0, "Fr": 223.0, "Ra": 226.0, "Ac": 227.0, "Th": 232.04,
    "Pa": 231.04, "U": 238.03, "Np": 237.0, "Pu": 244.0, "Am": 243.0,
    "Cm": 247.0, "Bk": 247.0, "Cf": 251.0, "Es": 252.0, "Fm": 257.0,
    "Md": 258.0, "No": 259.0, "Lr": 266.0, "Rf": 267.0, "Db": 268.0,
    "Sg": 269.0, "Bh": 270.0, "Hs": 277.0, "Mt": 278.0, "Ds": 281.0,
    "Rg": 282.0, "Cn": 285.0, "Nh": 286.0, "Fl": 289.0, "Mc": 290.0,
    "Lv": 293.0, "Ts": 294.0, "Og": 294.0,
}

COVALENT_RADII = {
    "H": 0.31, "He": 0.28, "Li": 1.28, "Be": 0.96, "B": 0.84, "C": 0.76,
    "N": 0.71, "O": 0.66, "F": 0.57, "Ne": 0.58, "Na": 1.66, "Mg": 1.41,
    "Al": 1.21, "Si": 1.11, "P": 1.07, "S": 1.05, "Cl": 1.02, "Ar": 1.06,
    "K": 2.03, "Ca": 1.76, "Fe": 1.32, "Cu": 1.32, "Zn": 1.22, "Br": 1.20,
    "I": 1.39, "Ag": 1.45, "Au": 1.36, "Pt": 1.36, "Pb": 1.46,
}


def mass_of(element: str, default: float = 0.0) -> float:
    """Standard atomic weight of an element symbol.

    Strips trailing digits/underscores so species names like ``"Na1"`` or
    ``"O_mol"`` resolve to their base element where possible. The table
    covers all 118 IUPAC elements (the reference queried pubchempy at
    ingestion, ``experiment/experiment.py:642`` — no network here);
    unknown symbols WARN and return ``default`` instead of silently
    propagating a zero mass into COM weights.
    """
    if element in ATOMIC_MASSES:
        return ATOMIC_MASSES[element]
    base = element.rstrip("0123456789_")
    base = base.capitalize() if len(base) <= 2 else base
    if base in ATOMIC_MASSES:
        return ATOMIC_MASSES[base]
    import logging

    logging.getLogger(__name__).warning(
        "Unknown element symbol %r: no standard atomic weight; using %s. "
        "Set the mass explicitly with experiment.set_mass(%r, value).",
        element, default, element,
    )
    return default
