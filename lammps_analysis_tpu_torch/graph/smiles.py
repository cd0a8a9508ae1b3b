"""Minimal SMILES parser: composition and bond graph.

Counterpart of ``lammps_analysis_tpu/graph/smiles.py`` (which replaces the
reference's pysmiles, ``molecular_graph.py:345-371``): the parser and
:func:`smiles_composition` are copies. The parser handles bracket atoms
(``[H]``, ``[Na+]``), the organic subset (B, C, N, O, P, S, F, Cl, Br, I),
branches, ring-bond digits, and implicit hydrogens on organic-subset atoms
via standard valences.

Two consumers:

* :func:`smiles_composition` — element -> count (molecule mapping
  pre-filter);
* :func:`smiles_graph` — the reference graph for the bond-graph check, with
  explicit hydrogens. The JAX package returns a ``networkx.Graph``; the port
  needs no networkx and returns a :class:`~.molecular_graph.MolGraph` (an
  element per node, a set of bonds) with the same nodes and edges.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

from .molecular_graph import MolGraph

_ORGANIC = {"B": 3, "C": 4, "N": 3, "O": 2, "P": 3, "S": 2,
            "F": 1, "Cl": 1, "Br": 1, "I": 1}
_BOND_ORDER = {"-": 1, "=": 2, "#": 3, "$": 4, ":": 1, "/": 1, "\\": 1}

_TOKEN = re.compile(
    r"\[(?P<bracket>[^\]]+)\]"
    r"|(?P<organic>Cl|Br|B|C|N|O|P|S|F|I)"
    r"|(?P<aromatic>b|c|n|o|p|s)"
    r"|(?P<bond>[-=#$:/\\])"
    r"|(?P<branch>[()])"
    r"|(?P<ring>%\d{2}|\d)"
    r"|(?P<dot>\.)"
)

_BRACKET = re.compile(
    r"^(?P<isotope>\d+)?(?P<element>[A-Z][a-z]?|[a-z])"
    r"(?P<chiral>@{1,2})?(?P<hcount>H\d*)?(?P<charge>[+-]+\d*)?"
    r"(?P<class>:\d+)?$"
)


def _parse(smiles: str) -> Tuple[List[str], List[Tuple[int, int]], List[int]]:
    """Parse to (elements, bonds, per-atom hydrogen counts).

    ``elements[i]`` is the element of heavy/bracket atom ``i``; ``bonds``
    are (i, j) pairs between those atoms; ``h_counts[i]`` is the number of
    hydrogens (explicit bracket H-counts or implicit via organic valence)
    attached to atom ``i``.
    """
    elements: List[str] = []
    bonds: List[Tuple[int, int]] = []
    h_counts: List[int] = []
    bond_used: List[int] = []  # valence already consumed by real bonds
    organic_flag: List[bool] = []

    prev_atom = None
    pending_bond = 1
    stack: List[int] = []
    ring_openings: Dict[str, tuple] = {}

    def add_bond(a: int, b: int, order: int) -> None:
        bonds.append((a, b))
        bond_used[a] += order
        bond_used[b] += order

    for m in _TOKEN.finditer(smiles):
        kind = m.lastgroup
        text = m.group()
        if kind == "bracket":
            bm = _BRACKET.match(m.group("bracket"))
            if not bm:
                raise ValueError(f"Cannot parse SMILES bracket atom {text!r}")
            element = bm.group("element").capitalize()
            h = bm.group("hcount")
            n_h = (int(h[1:]) if len(h) > 1 else 1) if h else 0
            elements.append(element)
            h_counts.append(n_h)
            bond_used.append(0)
            organic_flag.append(False)
            if prev_atom is not None:
                add_bond(prev_atom, len(elements) - 1, pending_bond)
            prev_atom = len(elements) - 1
            pending_bond = 1
        elif kind in ("organic", "aromatic"):
            element = text.capitalize() if kind == "aromatic" else text
            elements.append(element)
            h_counts.append(0)
            # aromatic atoms carry one delocalised bond beyond their two
            # explicit ring bonds; charge it to the valence up front
            bond_used.append(1 if kind == "aromatic" else 0)
            organic_flag.append(True)
            if prev_atom is not None:
                add_bond(prev_atom, len(elements) - 1, pending_bond)
            prev_atom = len(elements) - 1
            pending_bond = 1
        elif kind == "bond":
            pending_bond = _BOND_ORDER[text]
        elif kind == "branch":
            if text == "(":
                stack.append(prev_atom)
            else:
                prev_atom = stack.pop()
        elif kind == "ring":
            key = text
            if key in ring_openings:
                other, order = ring_openings.pop(key)
                add_bond(prev_atom, other, max(order, pending_bond))
            else:
                ring_openings[key] = (prev_atom, pending_bond)
            pending_bond = 1
        elif kind == "dot":
            prev_atom = None
            pending_bond = 1

    # implicit hydrogens on organic-subset atoms
    for i, element in enumerate(elements):
        if organic_flag[i] and element in _ORGANIC:
            missing = _ORGANIC[element] - bond_used[i]
            if missing > 0:
                h_counts[i] += missing
    return elements, bonds, h_counts


def smiles_composition(smiles: str) -> Dict[str, int]:
    """Element -> count for a SMILES string, including implicit hydrogens."""
    elements, _, h_counts = _parse(smiles)
    counts: Dict[str, int] = {}
    for element in elements:
        counts[element] = counts.get(element, 0) + 1
    n_h = sum(h_counts)
    if n_h:
        counts["H"] = counts.get("H", 0) + n_h
    return counts


def smiles_graph(smiles: str) -> MolGraph:
    """Bond graph with explicit hydrogens.

    Node ``i`` is parsed atom ``i``; hydrogens (explicit bracket counts and
    implicit organic-valence ones) become their own nodes after the parsed
    atoms, bonded to the parent atom — the numbering of the JAX package's
    graph and of the reference's ``read_smiles(smiles,
    explicit_hydrogen=True)`` (``molecular_graph.py:345-371``).
    """
    elements, edges, h_counts = _parse(smiles)
    for i, n_h in enumerate(h_counts):
        for _ in range(n_h):
            edges.append((i, len(elements)))
            elements.append("H")
    return MolGraph.from_edges(elements, edges)
