"""Molecular graph detection: cutoff adjacency -> connected components.

Counterpart of ``lammps_analysis_tpu/graph/molecular_graph.py`` (a re-design
of ``mdsuite/graph_modules/molecular_graph.py:49-433``):

* the adjacency comes from the minimum-image distance criterion of the JAX
  package, as torch ops on ``config.device`` in row chunks, with the same
  strict ``0 < d^2 < cutoff^2`` test (not the kernels' ``s <= t`` of
  ``ops/geometry.py::squared_cutoff``);
* decomposition is ``scipy.sparse.csgraph.connected_components`` on the
  host, as in the JAX package; ``find_molecules``, ``composition_of`` and
  ``group_molecules_by_composition`` are copies;
* the bond-graph check against the SMILES reference graph is the port's
  own: the JAX package runs networkx's VF2 monomorphism with element
  matching, the port an exact backtracking search for the same
  element-preserving bijection (molecules have tens of atoms), on
  :class:`MolGraph` rather than ``networkx.Graph``. Every reference bond
  must exist in the cluster's cutoff graph; extra proximity edges are
  allowed (water's H-H lies inside a 1.7 A cutoff).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, FrozenSet, Iterable, List, Sequence, Tuple

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from ..ops.geometry import box_scalars, minimum_image
from ..utils.config import get_device

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MolGraph:
    """An undirected graph with an element per node.

    Node ``i`` has element ``elements[i]``; ``bonds`` holds each edge once,
    as ``(i, j)`` with ``i <= j``.
    """

    elements: Tuple[str, ...]
    bonds: FrozenSet[Tuple[int, int]]

    @classmethod
    def from_edges(cls, elements: Iterable[str], edges: Iterable[Tuple[int, int]]):
        return cls(
            tuple(elements),
            frozenset((min(a, b), max(a, b)) for a, b in edges),
        )

    def neighbors(self) -> List[set]:
        """Per node, the set of nodes it shares a bond with."""
        out = [set() for _ in self.elements]
        for a, b in self.bonds:
            out[a].add(b)
            out[b].add(a)
        return out


def build_adjacency(
    positions: np.ndarray,
    box: np.ndarray | None,
    cutoff: float,
    chunk: int = 512,
) -> csr_matrix:
    """Sparse adjacency: pairs closer than ``cutoff`` under minimum image.

    ``positions`` is one configuration ``(N, 3)``; it moves to
    ``config.device`` in its own dtype, and the pair scan runs in row chunks
    so the dense block never exceeds ``chunk x N``. Only the kept pairs'
    indices come back to the host.
    """
    pos = torch.as_tensor(np.asarray(positions)).to(get_device())
    n = pos.shape[0]
    scalars = box_scalars(box, "build_adjacency") if box is not None else None
    rows, cols = [], []
    for start in range(0, n, chunk):
        r = pos[start:start + chunk, None, :] - pos[None, :, :]
        if scalars is not None:
            edge, inv_edge = scalars
            r = torch.stack(
                [minimum_image(r[..., d], edge[d], inv_edge[d]) for d in range(3)],
                dim=-1,
            )
        d2 = torch.sum(r * r, dim=-1)
        hit = torch.nonzero((d2 < cutoff * cutoff) & (d2 > 0)).cpu().numpy()
        rows.append(hit[:, 0] + start)
        cols.append(hit[:, 1])
    rows = np.concatenate(rows) if rows else np.array([], dtype=int)
    cols = np.concatenate(cols) if cols else np.array([], dtype=int)
    data = np.ones(len(rows), dtype=np.int8)
    return csr_matrix((data, (rows, cols)), shape=(n, n))


def find_molecules(
    adjacency: csr_matrix,
    species_of_atom: Sequence[str],
    return_atom_ids: bool = False,
):
    """Decompose the graph into per-molecule ``{species: [atom indices]}``.

    Atom indices are per-species (the index within that species' dataset),
    matching the reference's group bookkeeping
    (``molecular_graph.py:170-225`` + ``map_molecules.py``). With
    ``return_atom_ids`` also returns, per molecule, the GLOBAL atom indices
    into the concatenated layout (needed for bond-graph isomorphism).
    """
    n_components, labels = connected_components(adjacency, directed=False)
    species_of_atom = list(species_of_atom)
    # per-species running index of each atom in the global concatenation
    per_species_index = {}
    counters: Dict[str, int] = {}
    for i, sp in enumerate(species_of_atom):
        per_species_index[i] = counters.get(sp, 0)
        counters[sp] = per_species_index[i] + 1

    molecules: List[Dict[str, List[int]]] = [
        {} for _ in range(n_components)
    ]
    atom_ids: List[List[int]] = [[] for _ in range(n_components)]
    for atom, label in enumerate(labels):
        sp = species_of_atom[atom]
        molecules[label].setdefault(sp, []).append(per_species_index[atom])
        atom_ids[label].append(atom)
    if return_atom_ids:
        return molecules, atom_ids
    return molecules


def cluster_graph(
    adjacency: csr_matrix,
    atom_ids: Sequence[int],
    species_of_atom: Sequence[str],
) -> MolGraph:
    """Bond graph of one candidate cluster.

    Nodes are local indices (positions in ``atom_ids``) carrying the species
    name as element; edges are the within-cutoff adjacency restricted to the
    cluster, read from the CSR rows of the cluster's atoms.
    """
    adjacency = adjacency.tocsr()
    local = {int(a): i for i, a in enumerate(atom_ids)}
    indptr, indices = adjacency.indptr, adjacency.indices
    edges = [
        (i, local[b])
        for a, i in local.items()
        for b in indices[indptr[a]:indptr[a + 1]].tolist()
        if b in local
    ]
    return MolGraph.from_edges((species_of_atom[a] for a in local), edges)


def is_isomorphic_to_reference(graph: MolGraph, reference_graph: MolGraph) -> bool:
    """Element-labelled bond-graph validation (monomorphism).

    True when an element-preserving bijection of the atoms maps every bond
    of the SMILES-derived reference graph onto an edge of the cluster's
    distance-cutoff graph — the question the JAX package asks networkx's
    VF2 (``subgraph_is_monomorphic`` with element matching, equal node
    counts). Extra edges are allowed; missing bonds (isomers, accidental
    same-composition clusters) reject.

    The search assigns reference nodes in breadth-first order from the
    highest-degree node, so each node after the first of its component
    takes a candidate among the images' common neighbours with its element
    and at least its degree, and backtracks on a dead end.
    """
    n = len(reference_graph.elements)
    if len(graph.elements) != n:
        return False
    if sorted(graph.elements) != sorted(reference_graph.elements):
        return False
    g_adj, r_adj = graph.neighbors(), reference_graph.neighbors()
    order, seen = [], set()
    for root in sorted(range(n), key=lambda u: (-len(r_adj[u]), u)):
        if root in seen:
            continue
        seen.add(root)
        queue = [root]
        while queue:
            u = queue.pop(0)
            order.append(u)
            for v in sorted(r_adj[u]):
                if v not in seen:
                    seen.add(v)
                    queue.append(v)
    mapping: Dict[int, int] = {}
    used = set()

    def extend(k: int) -> bool:
        if k == n:
            return True
        u = order[k]
        placed = [mapping[v] for v in r_adj[u] if v in mapping]
        candidates = set.intersection(*(g_adj[w] for w in placed)) if placed else range(n)
        for c in sorted(candidates):
            if (
                c in used
                or graph.elements[c] != reference_graph.elements[u]
                or len(g_adj[c]) < len(r_adj[u])
            ):
                continue
            mapping[u] = c
            used.add(c)
            if extend(k + 1):
                return True
            del mapping[u]
            used.discard(c)
        return False

    return extend(0)


def composition_of(group: Dict[str, List[int]]) -> Tuple[Tuple[str, int], ...]:
    """Canonical composition key of a molecule group."""
    return tuple(sorted((sp, len(idx)) for sp, idx in group.items()))


def group_molecules_by_composition(
    molecules: List[Dict[str, List[int]]]
) -> Dict[Tuple[Tuple[str, int], ...], List[Dict[str, List[int]]]]:
    out: Dict[Tuple[Tuple[str, int], ...], List[Dict[str, List[int]]]] = {}
    for mol in molecules:
        out.setdefault(composition_of(mol), []).append(mol)
    return out
