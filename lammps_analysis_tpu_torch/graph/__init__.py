"""Molecular graph detection + minimal SMILES parsing."""
from .molecular_graph import (  # noqa: F401
    MolGraph,
    build_adjacency,
    composition_of,
    find_molecules,
    group_molecules_by_composition,
)
from .smiles import smiles_composition  # noqa: F401
