"""Molecule definition dataclass.

Copied from ``lammps_analysis_tpu/utils/molecule.py``.

Input contract for molecule mapping, mirroring
``mdsuite/utils/molecule.py:30-66``: a molecule is defined either by a SMILES
string (parsed by the in-package minimal SMILES reader) or an explicit
``species_dict`` giving the atom counts per species.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class Molecule:
    """Definition of one molecule type to detect in the trajectory.

    Attributes
    ----------
    name : str
        Name under which the mapped molecule trajectory is stored.
    amount : int
        Expected number of molecules (consistency-checked after detection).
    cutoff : float
        Bond-distance cutoff used to build the adjacency matrix.
    smiles : str, optional
        SMILES string describing the molecule composition.
    species_dict : dict, optional
        Explicit ``{species: count}`` composition (alternative to SMILES).
    reference_configuration_idx : int
        Frame used to detect the bonding graph.
    mol_pbc : bool
        If True, molecule coordinates are wrapped back into the box after
        mapping; otherwise the unwrapped COM trajectory is stored.
    """

    name: str
    amount: int = 0
    cutoff: float = 0.0
    smiles: Optional[str] = None
    species_dict: Optional[Dict[str, int]] = None
    reference_configuration_idx: int = 0
    mol_pbc: bool = False
