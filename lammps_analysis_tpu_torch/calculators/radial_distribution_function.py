"""Radial distribution function calculator.

Counterpart of ``lammps_analysis_tpu/calculators/radial_distribution_function.py``
with the same arguments, frame sampling, cache key and result layout
(``{"Na_Cl": {"x": ..., "y": ...}}``, x in nm). Frame batches stream from the
store through the prefetch pipeline to the pair-histogram kernel, their
frames split over the default mesh (``sharded_rdf_histogram``); the integer
counts accumulate on the device and come to the host once per run,
where the prefactors turn them into g(r). Spans (``utils/profiling.py``):
``rdf.dispatch`` a batch, ``rdf.fetch`` the one sync, ``rdf.normalise`` the
host's g(r).
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np
import torch

from ..database.properties import mdsuite_properties as mp
from ..database.trajectory_store import join_path
from ..ops import rdf as rdf_ops
from ..parallel.sharded_ops import sharded_rdf_histogram
from ..pipeline.prefetch import prefetch_to_device
from ..utils import profiling
from ..utils.config import get_device
from ..utils.progress import progress_iter
from .base import TrajectoryCalculator

log = logging.getLogger(__name__)


class RadialDistributionFunction(TrajectoryCalculator):
    """g(r) for all species pairs."""

    loaded_property = mp.positions
    scale_function = {"quadratic": {"outer_scale_factor": 1}}
    result_series_keys = ["x", "y"]

    def prepare_args(
        self,
        number_of_bins: int = None,
        cutoff: float = None,
        start: int = 0,
        stop: int = None,
        number_of_configurations: int = 500,
        species: list = None,
        atom_selection=None,
        molecules: bool = False,
        **kwargs,
    ) -> Dict[str, Any]:
        exp = self.experiment
        if stop is None:
            stop = exp.number_of_configurations - 1
        if cutoff is None:
            cutoff = exp.box_array[0] / 2 - 0.1  # reference default (:227)
        if number_of_configurations == -1:
            number_of_configurations = exp.number_of_configurations - 1
        number_of_configurations = min(
            number_of_configurations, exp.number_of_configurations
        )
        if number_of_bins is None:
            number_of_bins = int(cutoff / 0.01)  # 1/100 Angstrom bins (:238)
        if species is None:
            species = (
                list(exp.molecules) if molecules else list(exp.species)
            )
        return {
            "number_of_bins": int(number_of_bins),
            "cutoff": float(cutoff),
            "start": int(start),
            "stop": int(stop),
            "number_of_configurations": int(number_of_configurations),
            "species": list(species),
            "molecules": bool(molecules),
            "atom_selection": self.encode_atom_selection(atom_selection),
        }

    def run_calculator(self) -> Dict[str, dict]:
        a = self.args
        exp = self.experiment
        species = a["species"]
        n_bins, cutoff = a["number_of_bins"], a["cutoff"]
        self._run_dependency_check(species)
        device = get_device()

        sample_configs = np.linspace(
            a["start"], a["stop"], a["number_of_configurations"], dtype=int
        )
        sample_configs = np.unique(sample_configs)
        n_sampled = len(sample_configs)

        n_per_species = self.selected_counts(species)
        sid, n_pad, _, _, pair_order = rdf_ops.build_species_layout(
            n_per_species, pad_to=8
        )

        plan = self._plan_for(
            [join_path(sp, self.loaded_property.name) for sp in species]
        )
        # the JAX package's frame-batch model: positions plus per-i-block
        # intermediates of the plain version (the kernel needs far less)
        per_frame_bytes = plan.atom_block * n_pad * 24 + n_pad * 12
        budget = max(int(0.25 * exp.planner.budget_bytes), 1)
        frames_per_batch = int(
            np.clip(budget // max(per_frame_bytes, 1), 1, n_sampled)
        )
        batches = [
            sample_configs[s : s + frames_per_batch]
            for s in range(0, n_sampled, frames_per_batch)
        ]

        sid_dev = torch.from_numpy(sid).to(device)
        box = np.asarray(exp.box_array, dtype=np.float32)
        hist = torch.zeros(
            (len(pair_order), n_bins), dtype=torch.int64, device=device
        )
        for batch_pos in progress_iter(
            prefetch_to_device(
                lambda idx: self.load_concat_positions(
                    species, idx, n_pad, np.float32
                ),
                batches,
                device=device,
            ),
            desc=self.name, total=len(batches), unit="batch",
        ):
            with profiling.annotate("rdf.dispatch"):
                hist += sharded_rdf_histogram(
                    batch_pos, sid_dev, box, cutoff, n_bins, len(species)
                )
        with profiling.annotate("rdf.fetch"):
            counts = hist.cpu().numpy().astype(np.float64)  # one fetch per run
        log.info("RDF: %d frames x %d atoms on %s", n_sampled, sum(n_per_species), device)

        # normalisation + output (host side)
        with profiling.annotate("rdf.normalise"):
            bin_edges = np.linspace(0.0, cutoff, n_bins)
            prefactors = rdf_ops.rdf_prefactors(
                pair_order,
                n_per_species,
                exp.volume,
                n_sampled,
                bin_edges,
                exp.box_array[0],
            )
            x_nm = (exp.units.length / 1e-9) * bin_edges  # Angstrom -> nm (:384)

            results = {}
            for p, (ia, ib) in enumerate(pair_order):
                key = f"{species[ia]}_{species[ib]}"
                g = counts[p] * prefactors[p]
                results[key] = {"x": x_nm.tolist(), "y": g.tolist()}
        return results
