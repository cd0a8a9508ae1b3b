"""Molecule mapping: atoms -> molecule center-of-mass trajectories.

Counterpart of ``lammps_analysis_tpu/transformations/map_molecules.py`` (a
re-design of ``mdsuite/transformations/map_molecules.py:43-292`` +
``graph_modules/molecular_graph.py``), with the same API, errors, warnings
and stored layout: detect molecules in a reference configuration by
bond-cutoff connectivity, check each candidate's bond graph against the
SMILES reference, then reduce each molecule's constituent atoms to a
mass-weighted COM trajectory stored as a new "species"
(``<name>/Unwrapped_Positions`` and its wrapped image ``<name>/Positions``)
usable by every calculator (``molecules=True``).

What differs from the JAX package:

* **COM by gather.** The JAX package multiplies an (n_molecules, n_atoms)
  float64 weight matrix into every frame. Here each molecule type is an
  ``(n_molecules, k)`` atom-index tensor and a ``(k,)`` mass-fraction
  vector: each slab is gathered and summed in float64 on ``config.device``
  and stored as float32 like the rest of the store.
* **Image fix.** The JAX package averages the per-atom unwrapped positions
  as they are, which assumes a molecule's atoms lie in one image at the
  first frame; a molecule straddling a box face there (per-atom wrapped
  output, as GROMACS ``mdrun`` writes it) gets a COM off by a fraction of a
  box length in every frame. Here, at the first frame of the unwrapped
  series, each constituent is shifted by the whole box lengths that bring
  it to the minimum image of its molecule's first atom. The unwrapped
  series is continuous, so the shift holds in every frame. Molecules that
  do not straddle get no shift and the JAX package's COM.
* **Appends.** The constituents' unwrapped positions are extended to the
  last frame before they are read, so a map after an append resumes at its
  cursor over the new frames; the JAX package runs their producer only when
  the dataset is missing, and maps the new frames from its unwritten rows.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np
import torch

from ..data.elements import mass_of
from ..database.contracts import SpeciesInfo, TrajectoryChunkData
from ..database.properties import PropertyInfo, mdsuite_properties as mp
from ..database.trajectory_store import join_path
from ..graph.molecular_graph import (
    build_adjacency,
    cluster_graph,
    composition_of,
    find_molecules,
    is_isomorphic_to_reference,
)
from ..graph.smiles import smiles_composition, smiles_graph
from ..ops.geometry import wrap_coordinates
from ..utils.config import get_device
from ..utils.molecule import Molecule

log = logging.getLogger(__name__)


def com_batch(
    pos: torch.Tensor,
    index: torch.Tensor,
    weights: torch.Tensor,
    shift: torch.Tensor,
) -> torch.Tensor:
    """Molecule COMs of a slab, in float64.

    ``pos`` is ``(T, n_atoms, 3)`` unwrapped positions, ``index`` the
    ``(n_mol, k)`` atom indices of each molecule, ``weights`` the ``(k,)``
    float64 mass fractions and ``shift`` the ``(n_mol, k, 3)`` float64 image
    fix; the result is ``(T, n_mol, 3)``.
    """
    atoms = pos[:, index].to(torch.float64) + shift
    return torch.sum(atoms * weights[:, None], dim=2)


class MolecularMap:
    """Detect molecules and write their COM trajectories into the store."""

    def __init__(self, molecules: List[Molecule] = None):
        self.molecules = molecules or []

    # -- entry point (run dispatcher calls this like any transformation) -----
    def run_transformation(self, experiment, species=None):
        if not self.molecules:
            raise ValueError("MolecularMap needs a list of Molecule definitions")
        for molecule in self.molecules:
            self._map_one(experiment, molecule)

    # ------------------------------------------------------------------ core
    def _composition(self, molecule: Molecule) -> Dict[str, int]:
        if molecule.species_dict:
            return dict(molecule.species_dict)
        if molecule.smiles:
            return smiles_composition(molecule.smiles)
        raise ValueError(
            f"Molecule {molecule.name!r} needs either smiles or species_dict"
        )

    def _map_one(self, experiment, molecule: Molecule):
        out_path = join_path(molecule.name, mp.unwrapped_positions.name)
        if experiment.store.check_existence(out_path):
            done = experiment.store.get_cursor(out_path)
            if done >= experiment.number_of_configurations:
                log.info("molecule %s already mapped; skipping", molecule.name)
                return

        composition = self._composition(molecule)
        species_names = [
            sp for sp in experiment.species
            if sp != "Observables" and sp in composition
        ]
        if sorted(species_names) != sorted(composition):
            missing = set(composition) - set(species_names)
            raise ValueError(
                f"Molecule {molecule.name!r} needs species {sorted(missing)} "
                "that are not in the experiment."
            )

        # unwrapped positions of every constituent species to the last frame:
        # the producer skips a complete dataset and extends one an append
        # left short
        from .registry import transformation_for_property

        for sp in species_names:
            producer = transformation_for_property(
                mp.unwrapped_positions.name, experiment=experiment, species=sp,
            )
            if producer is not None:
                producer.run_transformation(experiment, [sp])
            elif not experiment.store.check_existence(
                join_path(sp, mp.unwrapped_positions.name)
            ):
                raise ValueError(
                    f"Molecule mapping needs Unwrapped_Positions for "
                    f"{sp!r}, and the store holds no coordinate set "
                    "to derive them from."
                )

        groups = self._detect_groups(
            experiment, molecule, composition, species_names
        )
        n_mol = len(groups)
        if molecule.amount and n_mol != molecule.amount:
            log.warning(
                "Molecule %s: detected %d molecules, expected %d",
                molecule.name, n_mol, molecule.amount,
            )
        if n_mol == 0:
            raise ValueError(
                f"No molecules matching {molecule.name!r} "
                f"(composition {composition}) found at the reference "
                f"configuration with cutoff {molecule.cutoff}."
            )
        log.info("Molecule %s: %d molecules detected", molecule.name, n_mol)

        self._reduce_com(experiment, molecule, groups, species_names)
        self._register(experiment, molecule, groups, composition, n_mol)

    def _detect_groups(self, experiment, molecule, composition, species_names):
        """Connected components at the reference configuration."""
        ref_idx = molecule.reference_configuration_idx
        parts, species_of_atom = [], []
        for sp in species_names:
            # wrapped positions when stored; otherwise the unwrapped ones
            # (guaranteed present by _map_one) — the adjacency scan applies
            # minimum image either way, and bonded separations are far
            # below half a box, so both give the same bond graph
            path = join_path(sp, mp.positions.name)
            if not experiment.store.check_existence(path):
                path = join_path(sp, mp.unwrapped_positions.name)
            data = experiment.store.load(
                [path], frames=slice(ref_idx, ref_idx + 1)
            )[path]
            parts.append(data[0])
            species_of_atom.extend([sp] * data.shape[1])
        positions = np.concatenate(parts, axis=0)
        box = np.asarray(experiment.box_array)

        adjacency = build_adjacency(positions, box, molecule.cutoff)
        all_molecules, atom_ids = find_molecules(
            adjacency, species_of_atom, return_atom_ids=True
        )
        key = tuple(sorted(composition.items()))
        # composition as a fast pre-filter
        candidates = [
            (mol, ids)
            for mol, ids in zip(all_molecules, atom_ids)
            if composition_of(mol) == key
        ]
        if not molecule.smiles:
            # no reference bonding available (species_dict molecules)
            return [mol for mol, _ in candidates]
        # bond-graph monomorphism against the SMILES-derived reference graph
        # — rejects isomers / accidental clusters with matching counts
        reference_graph = smiles_graph(molecule.smiles)
        accepted, rejected = [], 0
        for mol, ids in candidates:
            g = cluster_graph(adjacency, ids, species_of_atom)
            if is_isomorphic_to_reference(g, reference_graph):
                accepted.append(mol)
            else:
                rejected += 1
        if rejected:
            log.warning(
                "molecule %s: rejected %d same-composition cluster(s) whose "
                "bond graph is not isomorphic to the SMILES reference",
                molecule.name, rejected,
            )
        return accepted

    def _reduce_com(self, experiment, molecule, groups, species_names):
        """Stream slabs of unwrapped positions; gather, image-fix and
        mass-weight each molecule's atoms on the device."""
        device = get_device()
        n_mol = len(groups)
        n_configs = experiment.number_of_configurations
        box = torch.as_tensor(experiment.box_array, dtype=torch.float64, device=device)

        # concatenated atom layout across constituent species; every group
        # has the molecule's composition, so column j of the index is the
        # same species (and mass) in every molecule
        offsets = {}
        off = 0
        for sp in species_names:
            offsets[sp] = off
            off += experiment.species[sp].n_particles
        n_atoms = off
        index = np.array(
            [
                [offsets[sp] + i for sp in species_names for i in group[sp]]
                for group in groups
            ],
            dtype=np.int64,
        )
        masses = np.array(
            [
                experiment.species[sp].mass or mass_of(sp) or 1.0
                for sp in species_names for _ in groups[0][sp]
            ]
        )
        index = torch.from_numpy(index).to(device)
        weights = torch.from_numpy(masses / masses.sum()).to(device)

        paths = [
            join_path(sp, mp.unwrapped_positions.name) for sp in species_names
        ]

        def load(frames: slice) -> torch.Tensor:
            data = experiment.store.load(paths, frames=frames)
            return torch.from_numpy(
                np.concatenate([data[p] for p in paths], axis=1)
            ).to(device)

        # the image fix, from the first frame of the unwrapped series
        first = load(slice(0, 1))[0][index].to(torch.float64)
        d = first - first[:, :1]
        shift = -box * torch.round(d / box)

        # both the unwrapped COM trajectory (dynamics) and its wrapped image
        # (structural calculators) are stored — reference wraps/unwraps the
        # molecule trajectory after mapping (``map_molecules.py:284-292``)
        for prop in (mp.unwrapped_positions, mp.positions):
            experiment.store.ensure_dataset(molecule.name, prop.name, n_configs, n_mol, 3)
        batch_frames = max(
            1,
            min(
                n_configs,
                int(experiment.planner.budget_bytes // max(n_atoms * 3 * 8 * 6, 1)),
            ),
        )
        start = experiment.store.get_cursor(
            join_path(molecule.name, mp.unwrapped_positions.name)
        )
        prop_unwrapped = PropertyInfo(mp.unwrapped_positions.name, 3)
        prop_wrapped = PropertyInfo(mp.positions.name, 3)
        box32 = box.to(torch.float32)
        while start < n_configs:
            stop = min(start + batch_frames, n_configs)
            com = com_batch(load(slice(start, stop)), index, weights, shift)
            wrapped = wrap_coordinates(com, box).to(torch.float32)
            # a float64 value within half a float32 ulp below the box edge
            # rounds to the edge itself; fold it to 0 to stay in [0, box)
            wrapped = torch.where(wrapped >= box32, wrapped - box32, wrapped)
            sp_info = SpeciesInfo(
                molecule.name, n_mol, [prop_unwrapped, prop_wrapped]
            )
            chunk = TrajectoryChunkData([sp_info], stop - start)
            chunk.attach_data(
                com.to(torch.float32).cpu().numpy(), molecule.name, prop_unwrapped.name
            )
            chunk.attach_data(wrapped.cpu().numpy(), molecule.name, prop_wrapped.name)
            experiment.store.add_chunk(chunk)
            start = stop

    def _register(self, experiment, molecule, groups, composition, n_mol):
        """Record the molecule species + groups in the experiment DB."""
        mol_mass = sum(
            (experiment.species[sp].mass or mass_of(sp)) * count
            for sp, count in composition.items()
        )
        molecules = experiment.molecules
        molecules[molecule.name] = {
            "n_particles": n_mol,
            "mass": mol_mass,
            "composition": composition,
            "cutoff": molecule.cutoff,
            "groups": {
                str(m): {sp: list(idx) for sp, idx in group.items()}
                for m, group in enumerate(groups)
            },
            "properties": [
                {"name": mp.unwrapped_positions.name, "n_dims": 3},
                {"name": mp.positions.name, "n_dims": 3},
            ],
        }
        experiment.molecules = molecules
        experiment.refresh_property_groups()
