"""Experiment: the central analysis unit.

Counterpart of ``lammps_analysis_tpu/experiment/experiment.py`` with the same
public API: one experiment owns a trajectory store (here the npy store in
``<experiment>/database/``) and its metadata rows in the project's results
DB, whose schema is the JAX package's. All scalar metadata (temperature, time
step, units, counts, box, species) are lazy SQL-backed attributes so
re-opening a project restores everything.

Sources: a trajectory path (a LAMMPS dump ``.lammpstrj``, ``.lammpstraj``,
``.dump``; extxyz ``.extxyz``, ``.xyz``; GROMACS ``.gro``, ``.trr``; DCD
``.dcd``), a ``FileProcessor`` (those readers, ``LAMMPSFluxFile``,
``ChemfilesRead``, in-memory ``ScriptInput``), or a list of them.
"""

from __future__ import annotations

import logging
import pathlib
from typing import Dict, List, Optional, Union

import numpy as np

from ..database.contracts import SpeciesInfo, TrajectoryMetadata
from ..database.properties import PropertyInfo
from ..database.results_db import ResultsDatabase
from ..database.trajectory_store import TrajectoryStore, join_path
from ..data.elements import mass_of
from ..file_io.base import FileProcessor
from ..memory.planner import BatchPlanner
from ..parallel.multihost import rank_zero, shared
from ..utils.constants import DatasetKeys
from ..utils.units import UnitSystem, resolve_units

log = logging.getLogger(__name__)


def _processor_for_path(path: Union[str, pathlib.Path]) -> FileProcessor:
    """Choose a reader from the file suffix.

    Reference analog: ``experiment/experiment.py:62-86``.
    """
    from ..file_io.dcd import DCDFile
    from ..file_io.extxyz import EXTXYZFile
    from ..file_io.gro import GROFile
    from ..file_io.lammps_dump import LAMMPSDumpFile
    from ..file_io.trr import TRRFile

    suffix = pathlib.Path(path).suffix.lower()
    if suffix in (".lammpstraj", ".dump", ".lammpstrj"):
        return LAMMPSDumpFile(path)
    if suffix in (".extxyz", ".xyz"):
        return EXTXYZFile(path)
    if suffix == ".gro":
        return GROFile(path)
    if suffix == ".dcd":
        return DCDFile(path)
    if suffix == ".trr":
        return TRRFile(path)
    raise ValueError(
        f"Cannot infer a reader for {str(path)!r} (suffix {suffix!r}). Pass a "
        "FileProcessor instance (LAMMPSDumpFile, EXTXYZFile, LAMMPSFluxFile, "
        "GROFile, DCDFile, TRRFile, ChemfilesRead, ScriptInput) instead."
    )


class _DBAttribute:
    """Lazy SQL-backed attribute descriptor.

    Analog of the reference ``LazyProperty``
    (``experiment_database.py:46-83``).
    """

    def __init__(self, name: str, default=None):
        self.name = name
        self.default = default

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.db.get_attribute(obj.name, self.name, self.default)

    def __set__(self, obj, value):
        if value is not None:
            obj.db.set_attribute(obj.name, self.name, value)


class _BoundSpecies(SpeciesInfo):
    """A species entry bound to its experiment: assigning ``charge`` or
    ``mass`` persists through ``set_charge``/``set_mass`` — the
    reference's notebooks drive charges this way
    (``examples/notebooks/Molten_Salt_Comparison.ipynb``:
    ``project.experiments.NaCl.species["Na"].charge = 1``), and there
    the write lives only in the session cache; here it persists."""

    def __setattr__(self, key, value):
        if key in ("charge", "mass"):
            exp = object.__getattribute__(self, "_exp")
            setter = exp.set_charge if key == "charge" else exp.set_mass
            setter(self.name, float(value))
            object.__setattr__(self, key, float(value))
        else:
            super().__setattr__(key, value)  # FrozenInstanceError


class Experiment:
    """A single simulation's data + analyses."""

    temperature = _DBAttribute("temperature")
    time_step = _DBAttribute("time_step")
    number_of_configurations = _DBAttribute("number_of_configurations", 0)
    number_of_atoms = _DBAttribute("number_of_atoms", 0)
    sample_rate = _DBAttribute("sample_rate", 1)
    box_array = _DBAttribute("box_array")
    read_files = _DBAttribute("read_files", [])
    property_groups = _DBAttribute("property_groups", {})

    def __init__(
        self,
        project=None,
        name: str = "experiment",
        time_step: float = None,
        temperature: float = None,
        units: Union[str, UnitSystem] = None,
        storage_path: Union[str, pathlib.Path] = None,
    ):
        if not name or not name[0].isalpha():
            # the reference enforces this (experiment.py:163-165) so that
            # attribute-style access (project.experiments.<name>) works
            raise ValueError(
                "Experiment name must start with a letter! "
                f"Found {name[:1]!r} instead."
            )
        self.name = name
        if project is not None:
            self.path = pathlib.Path(project.path) / name
            self.db: ResultsDatabase = project.db
        else:
            base = pathlib.Path(storage_path or ".")
            self.path = base / name
            self.db = shared(ResultsDatabase, self.path / "project.db")
        self.path.mkdir(parents=True, exist_ok=True)
        (self.path / "figures").mkdir(exist_ok=True)
        self.db.ensure_experiment(name)

        self.store = shared(TrajectoryStore, self.path / "database", dtype="float32")
        self.planner = BatchPlanner()

        if time_step is not None:
            self.time_step = time_step
        if temperature is not None:
            self.temperature = temperature
        if units is not None:
            u = resolve_units(units)
            self.units_name = u.name
            from ..utils.units import units_dict

            if u.name not in units_dict:
                # custom unit systems persist their full factor set (the
                # reference stores the Units object; CI locks the
                # round-trip — test_experiment_database.py:205-228)
                import dataclasses
                import json

                self.db.set_attribute(
                    name, "units_custom", json.dumps(dataclasses.asdict(u))
                )
        elif self.db.get_attribute(name, "units_name") is None:
            self.units_name = "real"

    # ------------------------------------------------------------------ units
    @property
    def units_name(self) -> str:
        return self.db.get_attribute(self.name, "units_name", "real")

    @units_name.setter
    def units_name(self, value: str):
        self.db.set_attribute(self.name, "units_name", value)

    @property
    def units(self) -> UnitSystem:
        from ..utils.units import units_dict

        name = self.units_name
        if name not in units_dict:
            raw = self.db.get_attribute(self.name, "units_custom")
            if raw is not None:
                import json

                return UnitSystem(**json.loads(raw))
        return resolve_units(name)

    @property
    def version(self) -> int:
        return self.db.experiment_version(self.name)

    def units_to_si(self, quantity: str) -> float:
        """SI conversion factor for a named quantity.

        Reference analog: ``Experiment.units_to_si``
        (``experiment/experiment.py:284-318``). Supported quantities:
        time, length, energy, volume, pressure, temperature.
        """
        units = self.units
        factors = {
            "time": units.time,
            "length": units.length,
            "energy": units.energy,
            "volume": units.volume,
            "pressure": units.pressure,
            "temperature": units.temperature,
        }
        try:
            return factors[quantity.lower()]
        except KeyError as err:
            raise KeyError(
                f"Unknown quantity {quantity!r}; choose from {sorted(factors)}"
            ) from err

    @property
    def volume(self) -> float:
        box = self.box_array
        if not box:
            return 0.0
        return float(np.prod([b for b in box if b]))

    # ---------------------------------------------------------------- species
    @property
    def species(self) -> Dict[str, SpeciesInfo]:
        raw = self.db.get_attribute(self.name, "species", {}) or {}
        out = {}
        for sp_name, info in raw.items():
            sp = _BoundSpecies(
                name=sp_name,
                n_particles=info["n_particles"],
                properties=tuple(
                    PropertyInfo(p["name"], p["n_dims"])
                    for p in info.get("properties", [])
                ),
                mass=info.get("mass", 0.0),
                charge=info.get("charge", 0.0),
            )
            object.__setattr__(sp, "_exp", self)
            out[sp_name] = sp
        return out

    @species.setter
    def species(self, value: Dict[str, SpeciesInfo]):
        raw = {}
        for sp_name, sp in value.items():
            raw[sp_name] = {
                "n_particles": sp.n_particles,
                "properties": [
                    {"name": p.name, "n_dims": p.n_dims} for p in sp.properties
                ],
                "mass": sp.mass,
                "charge": sp.charge,
            }
        self.db.set_attribute(self.name, "species", raw)

    @property
    def simulation_data(self) -> Dict[str, object]:
        """Free-form simulation metadata dict (reference
        ``experiment_database.py:377-409``)."""
        return self.db.get_attribute(self.name, "simulation_data", {}) or {}

    @simulation_data.setter
    def simulation_data(self, value: Dict[str, object]):
        self.db.set_attribute(self.name, "simulation_data", value)

    @property
    def molecules(self) -> Dict[str, dict]:
        return self.db.get_attribute(self.name, "molecules", {}) or {}

    @molecules.setter
    def molecules(self, value: Dict[str, dict]):
        self.db.set_attribute(self.name, "molecules", value)

    def entity(self, name: str) -> SpeciesInfo:
        """Resolve a species OR mapped-molecule name to its static info.

        Calculators invoked with ``molecules=True`` receive molecule names;
        both kinds resolve here (reference: the ``molecules`` branches in
        calculators, e.g. ``radial_distribution_function.py:311-323``).
        """
        species = self.species
        if name in species:
            return species[name]
        molecules = self.molecules
        if name in molecules:
            m = molecules[name]
            return SpeciesInfo(
                name=name,
                n_particles=m["n_particles"],
                properties=tuple(
                    PropertyInfo(p["name"], p["n_dims"])
                    for p in m.get("properties", [])
                ),
                mass=m.get("mass", 0.0),
                charge=m.get("charge", 0.0),
            )
        from ..utils.constants import SpeciesNotFoundError

        raise SpeciesNotFoundError(
            f"{name!r} is neither a species nor a mapped molecule of "
            f"experiment {self.name!r}"
        )

    def set_charge(self, element: str, charge: float) -> None:
        """Set a species' charge (reference ``experiment.py:429-442``)."""
        species = self.species
        species[element] = SpeciesInfo(
            name=element,
            n_particles=species[element].n_particles,
            properties=species[element].properties,
            mass=species[element].mass,
            charge=charge,
        )
        self.species = species

    def set_mass(self, element: str, mass: float) -> None:
        """Set a species' mass (reference ``experiment.py:444-457``)."""
        species = self.species
        species[element] = SpeciesInfo(
            name=element,
            n_particles=species[element].n_particles,
            properties=species[element].properties,
            mass=mass,
            charge=species[element].charge,
        )
        self.species = species

    # -------------------------------------------------------------- ingestion
    @rank_zero
    def add_data(
        self,
        simulation_data,
        force: bool = False,
        update_with_pubchempy: bool = True,
    ):
        """Ingest a trajectory source into the store.

        Reference analog: ``Experiment.add_data`` +
        ``_add_data_from_file_processor`` (``experiment.py:459-552``):
        idempotent via the read-files ledger (re-adding the same source is a
        no-op unless ``force``), marks the ledger only after a successful
        read, bumps the experiment version so cached calculator results are
        invalidated. In a process group rank 0 ingests and the others wait.
        """
        if isinstance(simulation_data, (str, pathlib.Path)):
            processor = _processor_for_path(simulation_data)
        elif isinstance(simulation_data, FileProcessor):
            processor = simulation_data
        elif isinstance(simulation_data, (list, tuple)):
            for item in simulation_data:
                self.add_data(
                    item, force=force,
                    update_with_pubchempy=update_with_pubchempy,
                )
            return
        else:
            raise TypeError(
                f"Cannot ingest {type(simulation_data)}; expected a path, a "
                "FileProcessor, or a list of either."
            )

        key = str(processor)
        ledger = list(self.read_files)
        if key in ledger and not force:
            log.info("%s already read; skipping (force=True to re-read)", key)
            return

        meta: TrajectoryMetadata = processor.metadata
        self._validate_append(meta)

        # Crash-safe ordering: stream FIRST, persist metadata only after
        # success. A mid-stream failure (truncated file, Ctrl-C, disk
        # full) then leaves number_of_configurations at the pre-append
        # value — calculators keep reading only good frames, and a retry
        # of the same source is a clean rewrite, not a double count.
        old_count = self.number_of_configurations
        total = old_count + meta.n_configurations
        self.store.initialize(
            TrajectoryMetadata(
                n_configurations=total,
                species_list=meta.species_list,
            )
        )
        for sp in meta.species_list:
            for prop in sp.properties:
                path = join_path(sp.name, prop.name)
                cur = self.store.get_cursor(path)
                if cur == old_count:
                    continue
                if cur < old_count:
                    # dataset created by THIS source but absent from the
                    # earlier ones: its frames must land on the shared
                    # time axis at old_count.. — the leading frames stay
                    # zero-filled (cursor 0 would silently misalign it)
                    log.warning(
                        "%s first appears in %s: frames 0..%d have no "
                        "data for it and read as zeros.",
                        path, key, old_count - 1,
                    )
                # cur > old_count: a crashed earlier attempt at this same
                # append — rewind and rewrite its partial frames
                self.store.set_cursor(path, old_count)
        from ..pipeline.prefetch import iter_in_background
        from ..utils.progress import progress_iter

        # parse/write overlap: the reader parses chunk k+1 in a worker
        # thread while this thread writes chunk k to the store
        # (bounded lookahead — at most 2 parsed chunks in flight)
        for chunk in progress_iter(
            iter_in_background(processor.get_configurations_generator()),
            desc=f"ingest {key}", unit="chunk",
        ):
            self.store.add_chunk(chunk)

        self._merge_metadata(meta, update_with_pubchempy)
        self.read_files = ledger + [key]
        self.db.bump_experiment_version(self.name)
        self.refresh_property_groups()
        log.info(
            "Ingested %d configurations from %s (total now %d)",
            meta.n_configurations,
            key,
            self.number_of_configurations,
        )

    def _validate_append(self, meta: TrajectoryMetadata):
        """Reject incompatible appends BEFORE any store write."""
        existing = self.species
        if not existing:
            return
        # appending more data: species layout must match
        names_new = {s.name: s.n_particles for s in meta.species_list}
        names_old = {
            k: v.n_particles
            for k, v in existing.items()
            if k != DatasetKeys.OBSERVABLES
        }
        if set(names_new) != set(names_old):
            # A disjoint append would leave the missing species' datasets
            # short while number_of_configurations grows — later loads
            # would silently read resized-but-unwritten (zero) frames.
            raise ValueError(
                "Appended data source must cover the same species as the "
                f"experiment: existing {sorted(names_old)}, new source "
                f"{sorted(names_new)}. Use a separate experiment for "
                "disjoint species sets."
            )
        for k in names_new:
            if names_new[k] != names_old[k]:
                raise ValueError(
                    f"Species {k!r} particle count changed between data "
                    f"sources: {names_old[k]} vs {names_new[k]}"
                )

    def _merge_metadata(self, meta: TrajectoryMetadata, lookup_masses: bool):
        existing = self.species
        merged = dict(existing)
        for sp in meta.species_list:
            prev = merged.get(sp.name)
            mass = prev.mass if prev else (
                mass_of(sp.name) if lookup_masses else 0.0
            )
            charge = prev.charge if prev else 0.0
            merged[sp.name] = SpeciesInfo(
                name=sp.name,
                n_particles=sp.n_particles,
                properties=sp.properties,
                mass=mass,
                charge=charge,
            )
        self.species = merged
        self.number_of_atoms = sum(
            s.n_particles
            for n, s in merged.items()
            if n != DatasetKeys.OBSERVABLES
        )
        self.number_of_configurations = (
            self.number_of_configurations + meta.n_configurations
        )
        if meta.box_l:
            self.box_array = list(meta.box_l)
        if meta.sample_rate is not None:
            self.sample_rate = meta.sample_rate
        if meta.temperature is not None:
            self.temperature = meta.temperature

    def refresh_property_groups(self):
        """Record which properties exist per species (store introspection)."""
        groups = {}
        if self.store.path.exists():
            for sp in self.store.species_names():
                groups[sp] = self.store.properties_of(sp)
        self.property_groups = groups

    # ------------------------------------------------------------------ reads
    def load_matrix(
        self,
        property_name: str = None,
        species: Optional[List[str]] = None,
        frames=None,
        atoms=None,
        select_slice=None,
        path: Optional[List[str]] = None,
    ) -> Dict[str, np.ndarray]:
        """Load ``(frames, atoms, dims)`` arrays for each requested species.

        Reference analog: ``Experiment.load_matrix`` (``experiment.py:554-597``)
        including its ``select_slice``/``path`` kwargs: ``path`` loads the
        given store paths verbatim, and ``select_slice`` indexes each
        loaded array — in THIS store's (time, atoms, dims) layout.
        """
        if path is not None:
            data = self.store.load(list(path))
            if select_slice is not None:
                data = {k: v[select_slice] for k, v in data.items()}
            return data
        if property_name is None:
            raise ValueError("load_matrix needs property_name or path")
        species = species or list(self.species)
        paths = [join_path(sp, property_name) for sp in species]
        data = self.store.load(paths, frames=frames, atoms=atoms)
        out = {sp: data[join_path(sp, property_name)] for sp in species}
        if select_slice is not None:
            out = {k: v[select_slice] for k, v in out.items()}
        return out

    # ---------------------------------------------------------------- dispatch
    @property
    def run(self):
        """Calculator/transformation dispatch: ``exp.run.<Name>(...)``."""
        from .run import RunComputation

        return RunComputation(experiment=self)

    @property
    def time_series(self):
        """Time-series dispatch: ``exp.time_series.Energies(...)``.

        Analog of the reference RunModule (``experiment/run_module.py:35``).
        """
        from ..time_series import time_series_dict

        experiment = self

        class _TimeSeriesHub:
            def __getattr__(self, name):
                try:
                    cls = time_series_dict[name]
                except KeyError as err:
                    raise AttributeError(
                        f"No time series named {name!r}; available: "
                        f"{sorted(time_series_dict)}"
                    ) from err
                return cls(experiment)

            def __dir__(self):
                return sorted(time_series_dict)

        return _TimeSeriesHub()

    @rank_zero
    def run_visualization(
        self,
        species: Optional[List[str]] = None,
        molecules: bool = False,
        unwrapped: bool = False,
    ):
        """Particle-trajectory visualization: ``figures/trajectory.html``, and
        ``figures/trajectory.png`` where matplotlib imports (on rank 0 alone
        in a process group). Returns the HTML's path (the JAX package
        returns the PNG's).

        Signature parity with the reference (``experiment.py:336-380``,
        znvis backend there): ``unwrapped=True`` renders
        ``Unwrapped_Positions`` instead of the wrapped coordinates.
        """
        from ..visualizer.trajectory_visualizer import TrajectoryVisualizer

        viz = TrajectoryVisualizer(
            self, species=species, molecules=molecules,
            property_name="Unwrapped_Positions" if unwrapped else "Positions",
        )
        return viz.run()

    @rank_zero
    def cls_transformation_run(self, transformation, species=None):
        """Run a transformation instance on this experiment (on rank 0 alone
        in a process group: it writes the store).

        Reference analog: ``experiment.py:270-282``.
        """
        transformation.run_transformation(self, species=species)

    def __repr__(self):  # pragma: no cover - cosmetic
        return (
            f"Experiment(name={self.name!r}, "
            f"configurations={self.number_of_configurations}, "
            f"species={list(self.species)})"
        )
