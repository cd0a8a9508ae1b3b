"""Transformation base machinery: streamed derivation of per-frame tensors.

Counterpart of ``lammps_analysis_tpu/transformations/base.py`` (itself a
re-design of ``mdsuite/transformations/transformations.py:66-619``):

* a transformation declares ``input_properties`` -> ``output_property`` and
  ``transform_batch(batch, carryover) -> (out, carry)``, where ``batch`` maps
  property names to ``(T, N, d)`` tensors (time leading) on the configured
  device and the carry chains state across slabs (the unwrapper's last
  positions and image counts);
* the runner streams frame slabs from the store with a one-slab lookahead,
  resolves each input through the reference's cascade (stored dataset ->
  constant from experiment/species metadata -> recursively run the producing
  transformation, ``transformations.py:352-433``), and appends outputs at the
  dataset's cursor, so an append to the experiment extends the output from
  where it stopped (``bootstrap_carry`` rebuilds the carry there).

Single-species transformations run once per species and write
``<species>/<output>``; multi-species ones (the fluxes,
``flux_transforms.py``) consume every species' inputs in one batch
``{species: {property: tensor}}`` and write one system series ``(T, 1, d)``
under ``Observables/<output>`` (``bootstrap_carry_multi`` rebuilds their
carry after an append).

The JAX package jit-compiles ``transform_batch`` and routes slabs to the host
when the accelerator link is slow; here it runs as eager torch ops on
``config.device``. Single-species inputs arrive in the store's dtype
(float32); multi-species inputs keep their own dtype (float32 store data,
float64 metadata constants), and the fluxes sum in float64.

A transformation's run is the span ``trafo.<Name>``; the counter
``trafo.frames`` counts the frames it appends, per dataset
(``utils/profiling.py``).
"""

from __future__ import annotations

import abc
import concurrent.futures
import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..database.properties import PropertyInfo
from ..database.trajectory_store import join_path
from ..utils import profiling
from ..utils.config import get_device
from ..utils.constants import (
    CannotFindPropertyError,
    DatasetKeys,
    SpeciesNotFoundError,
)
from ..utils.progress import progress_iter

log = logging.getLogger(__name__)


class Transformation(abc.ABC):
    """Base class: declares I/O properties and the batch function."""

    #: inputs needed per species
    input_properties: List[PropertyInfo] = []
    #: derived property written back to the store
    output_property: PropertyInfo = None
    #: memory cost model spec (same format as the reference)
    scale_function: dict = {"linear": {"scale_factor": 1}}
    #: True -> consume every species, emit one system-wide series
    multi_species: bool = False
    #: stateful transformations need sequential batches (carryover)
    requires_carryover: bool = False

    @abc.abstractmethod
    def transform_batch(
        self, batch: Dict[str, torch.Tensor], carryover: Any = None
    ) -> Tuple[torch.Tensor, Any]:
        """Property tensors -> output tensor (+ new carry).

        Single-species: ``batch`` maps property name -> ``(T, N, d)``;
        constants broadcast; output is ``(T, N, d_out)`` on the inputs'
        device. Multi-species: ``batch`` is ``{species: {property:
        tensor}}`` and the output ``(T, d_out)``. A transformation with
        ``requires_carryover`` also defines ``bootstrap_carry(experiment,
        species, offset)`` (or ``bootstrap_carry_multi(experiment,
        species_list, offset)``), which rebuilds the carry at ``offset`` when
        an append resumes it.
        """

    # ------------------------------------------------------------------ runner
    def run_transformation(self, experiment, species: Optional[List[str]] = None):
        """Execute against an experiment, writing results into its store.

        Reference analog: ``SingleSpeciesTrafo.run_transformation``
        (``transformations.py:446-519``) / ``MultiSpeciesTrafo`` (:553).
        """
        with profiling.annotate(f"trafo.{type(self).__name__}"):
            if self.multi_species:
                self._run_multi(experiment, species or list(experiment.species))
                experiment.refresh_property_groups()
                return
            for sp_name in species or list(experiment.species):
                out_path = join_path(sp_name, self.output_property.name)
                if (
                    experiment.store.check_existence(out_path)
                    and experiment.store.get_cursor(out_path)
                    >= experiment.number_of_configurations
                ):
                    log.debug("%s exists for %s; skipping", out_path, sp_name)
                    continue
                self._transform_species(experiment, sp_name)
            experiment.refresh_property_groups()

    def _transform_species(self, experiment, sp_name: str):
        store = experiment.store
        n_configs = experiment.number_of_configurations
        sources = {
            prop.name: self._resolve_input(experiment, sp_name, prop)
            for prop in self.input_properties
        }
        # entity(): mapped-molecule names resolve too
        n_particles = experiment.entity(sp_name).n_particles
        out_path = join_path(sp_name, self.output_property.name)
        # creates the dataset, or grows it after an append
        store.ensure_dataset(
            sp_name, self.output_property.name, n_configs, n_particles,
            self.output_property.n_dims,
        )
        offset = store.get_cursor(out_path)
        carry = None
        if offset > 0 and self.requires_carryover:
            carry = self.bootstrap_carry(experiment, sp_name, offset)
        device = get_device()
        slabs = list(self._batches(experiment, n_configs, offset))
        for batch in progress_iter(
            self._prefetched_batches(sources, slabs),
            desc=f"{type(self).__name__} {sp_name}",
            total=len(slabs), unit="slab",
        ):
            tensors = {
                name: torch.from_numpy(
                    np.ascontiguousarray(a, dtype=store.dtype)
                ).to(device)
                for name, a in batch.items()
            }
            out, carry = self.transform_batch(tensors, carry)
            store.append(out_path, out.cpu().numpy())
            profiling.count("trafo.frames", out.shape[0])

    def _run_multi(self, experiment, species: List[str]):
        """Every species' inputs in one batch -> ``Observables/<output>``.

        Port of the JAX package's ``_run_multi`` (``base.py:161``): the
        inputs resolve through the same cascade, slabs stream with the
        one-slab lookahead, ``(T, d)`` outputs land as ``(T, 1, d)`` rows at
        the dataset's cursor, and an append resumes there.
        """
        store = experiment.store
        n_configs = experiment.number_of_configurations
        group, name = DatasetKeys.OBSERVABLES, self.output_property.name
        out_path = join_path(group, name)
        if store.check_existence(out_path) and store.get_cursor(out_path) >= n_configs:
            log.debug("%s exists; skipping", out_path)
            return
        sources = {
            sp: {
                prop.name: self._resolve_input(experiment, sp, prop)
                for prop in self.input_properties
            }
            for sp in species
        }
        store.ensure_dataset(group, name, n_configs, 1, self.output_property.n_dims)
        offset = store.get_cursor(out_path)
        carry = None
        if offset > 0 and self.requires_carryover:
            carry = self.bootstrap_carry_multi(experiment, species, offset)
        device = get_device()
        slabs = list(self._batches(experiment, n_configs, offset))
        for batch in progress_iter(
            self._prefetched_batches(sources, slabs),
            desc=type(self).__name__, total=len(slabs), unit="slab",
        ):
            # store data stays float32, metadata constants float64
            tensors = {
                sp: {
                    prop: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for prop, a in per.items()
                }
                for sp, per in batch.items()
            }
            out, carry = self.transform_batch(tensors, carry)
            store.append(out_path, out.to(torch.float32)[:, None, :].cpu().numpy())
            profiling.count("trafo.frames", out.shape[0])

    # -- plumbing -------------------------------------------------------------
    @staticmethod
    def _prefetched_batches(sources, slabs):
        """Yield host input batches with one-slab lookahead: the next slab's
        store reads run in a worker thread while the caller computes and
        writes the current one. ``sources`` maps a name to a fetch, or (multi
        species) a species to ``{property: fetch}``."""

        def load(bounds):
            start, stop = bounds
            return {
                name: (
                    {prop: f(start, stop) for prop, f in fetch.items()}
                    if isinstance(fetch, dict) else fetch(start, stop)
                )
                for name, fetch in sources.items()
            }

        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            pending = None
            for bounds in slabs:
                fut = pool.submit(load, bounds)
                if pending is not None:
                    yield pending.result()
                pending = fut
            if pending is not None:
                yield pending.result()

    def _batches(self, experiment, n_configs: int, offset: int):
        """Frame slabs [start, stop) still to process."""
        batch_frames = experiment.planner.transformation_batch_size(
            self, experiment
        )
        start = offset
        while start < n_configs:
            stop = min(start + batch_frames, n_configs)
            yield start, stop
            start = stop

    def _resolve_input(self, experiment, sp_name: str, prop: PropertyInfo):
        """Input cascade: dataset -> metadata constant -> producing trafo.
        Returns ``fetch(start, stop) -> ndarray``. The metadata constants are
        the box, time step and sample rate and the species' charge and mass
        (reference ``transformations.py:390-433``). A stored dataset that an
        append left short of the experiment's frames is extended first by
        its producing transformation, which resumes at its cursor."""
        from .registry import transformation_for_property

        store = experiment.store
        path = join_path(sp_name, prop.name)

        def fetch(a, b, p=path):
            return store.load([p], frames=slice(a, b))[p]

        stored = store.check_existence(path)
        if stored and store.get_cursor(path) >= experiment.number_of_configurations:
            return fetch
        const = None if stored else self._metadata_constant(experiment, sp_name, prop)
        if const is not None:
            return lambda a, b, c=const: c
        # recursively produce the input (reference:
        # ``get_prop_through_transformation``, transformations.py:352-388)
        producer = transformation_for_property(
            prop.name, experiment=experiment, species=sp_name
        )
        if producer is None and stored:
            return fetch  # ingested data nothing derives
        if producer is None:
            raise CannotFindPropertyError(
                f"Property {prop.name!r} for species {sp_name!r} is neither "
                "stored, derivable from metadata, nor produced by any "
                "transformation."
            )
        log.info(
            "Transformation dependency: running %s to obtain %s",
            type(producer).__name__,
            prop.name,
        )
        producer.run_transformation(experiment, [sp_name])
        return fetch

    @staticmethod
    def _metadata_constant(experiment, sp_name: str, prop: PropertyInfo):
        if prop.name == "Box_Array":
            return np.asarray(experiment.box_array)
        if prop.name == "Time_Step":
            return np.asarray(experiment.time_step)
        if prop.name == "Sample_Rate":
            return np.asarray(experiment.sample_rate)
        if prop.name not in ("Charge", "Masses"):
            return None
        try:
            sp = experiment.entity(sp_name)
        except SpeciesNotFoundError:
            return None
        value = sp.charge if prop.name == "Charge" else sp.mass
        if value is None or (prop.name == "Masses" and not value):
            return None
        return np.full((1, 1, 1), float(value))
