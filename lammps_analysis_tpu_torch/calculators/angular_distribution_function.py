"""Angular distribution function calculator.

Counterpart of ``lammps_analysis_tpu/calculators/angular_distribution_function.py``
with the same arguments, frame sampling, cache key, batch split and result
layout (``{"Na_Na_Na": {"max_peak", "angle", "adf"}}``, angles in degrees).
Frame batches stream from the store through the prefetch pipeline to the
neighbor-extract and angle-histogram kernels (``parallel/sharded_ops.py::
AdfBatchRunner``); each batch is density-normalised on the device, the sum
comes to the host once per run (span ``adf.fetch``; the host's angles and
peaks ``adf.normalise``, ``utils/profiling.py``).

The batch split is part of the result: each batch's histogram is divided by
its own total, so the ADF's scale is the number of batches. The split is
the JAX package's: the planner's frame batch under the quadratic cost model
with ``outer_scale_factor`` 10, balanced so batch sizes differ by at most
one (off a TPU its ``adf_frames_per_call`` is 1 and changes nothing).
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np
import torch

from ..database.properties import mdsuite_properties as mp
from ..database.trajectory_store import join_path
from ..ops import adf as adf_ops
from ..ops import rdf as rdf_ops
from ..parallel.sharded_ops import AdfBatchRunner
from ..pipeline.prefetch import prefetch_to_device
from ..utils import profiling
from ..utils.config import get_device
from ..utils.progress import progress_iter
from .base import TrajectoryCalculator

log = logging.getLogger(__name__)


class AngularDistributionFunction(TrajectoryCalculator):
    """ADF for all species triples."""

    loaded_property = mp.positions
    scale_function = {"quadratic": {"outer_scale_factor": 10}}
    result_series_keys = ["angle", "adf"]

    def prepare_args(
        self,
        number_of_configurations: int = 5,
        cutoff: float = 6.0,
        start: int = 1,
        stop: int = None,
        number_of_bins: int = 500,
        species: list = None,
        norm_power: int = 4,
        molecules: bool = False,
        atom_selection=None,
        **kwargs,
    ) -> Dict[str, Any]:
        exp = self.experiment
        if stop is None:
            stop = exp.number_of_configurations - 1
        if species is None:
            species = list(exp.molecules) if molecules else list(exp.species)
        number_of_configurations = min(
            number_of_configurations, exp.number_of_configurations
        )
        return {
            "number_of_configurations": int(number_of_configurations),
            "cutoff": float(cutoff),
            "start": int(start),
            "stop": int(stop),
            "number_of_bins": int(number_of_bins),
            "species": list(species),
            "norm_power": int(norm_power),
            "molecules": bool(molecules),
            "atom_selection": self.encode_atom_selection(atom_selection),
        }

    def run_calculator(self) -> Dict[str, dict]:
        a = self.args
        species = a["species"]
        n_bins = a["number_of_bins"]
        self._run_dependency_check(species)
        device = get_device()

        sample_configs = np.unique(
            np.linspace(a["start"], a["stop"], a["number_of_configurations"],
                        dtype=int)
        )
        n_sampled = len(sample_configs)
        n_per_species = self.selected_counts(species)
        sid, n_pad, _, _, _ = rdf_ops.build_species_layout(n_per_species, pad_to=8)
        _, triple_order = adf_ops.build_triple_table(len(species))

        plan = self._plan_for(
            [join_path(sp, self.loaded_property.name) for sp in species]
        )
        frames_per_batch = max(1, min(plan.frame_batch, n_sampled))
        n_batches = -(-n_sampled // frames_per_batch)
        # balanced split (sizes differ by <= 1), as the JAX package splits
        frames_per_batch = -(-n_sampled // n_batches)
        batches = [
            sample_configs[b * frames_per_batch : (b + 1) * frames_per_batch]
            for b in range(n_batches)
        ]

        lo, hi = adf_ops.ADF_BIN_RANGE
        box = np.asarray(self.experiment.box_array, dtype=np.float32)
        runner = AdfBatchRunner(
            n_atoms=n_pad,
            species_id=torch.from_numpy(sid).to(device),
            box=box,
            cutoff=a["cutoff"],
            n_bins=n_bins,
            n_species=len(species),
            norm_power=a["norm_power"],
            normalize_per_batch=(hi - lo) / n_bins,
        )

        n_passes = 0
        while True:
            n_passes += 1
            for pos in progress_iter(
                prefetch_to_device(
                    lambda idx: self.load_concat_positions(
                        species, idx, n_pad, np.float32
                    ),
                    batches,
                    device=device,
                ),
                desc=self.name, total=n_batches, unit="batch",
            ):
                runner.feed(pos)
            hist = runner.finalize()
            if hist is not None:
                break
        with profiling.annotate("adf.fetch"):
            hist_total = hist.cpu().numpy().astype(np.float64)  # one fetch per run
        log.info(
            "ADF: %d frames x %d atoms in %d batches, %d pass(es) at K=%d on %s",
            n_sampled, sum(n_per_species), n_batches, n_passes, runner.plan.k_n, device,
        )
        self.last_k_n = runner.plan.k_n

        with profiling.annotate("adf.normalise"):
            # degrees with the reference's literal 180/3.14159 (:457-459)
            angles_deg = np.linspace(lo * (180 / 3.14159), hi * (180 / 3.14159), n_bins)
            results = {}
            for t, (ia, ib, ic) in enumerate(triple_order):
                key = f"{species[ia]}_{species[ib]}_{species[ic]}"
                h = hist_total[t]
                results[key] = {
                    "max_peak": float(angles_deg[int(np.argmax(h))]),
                    "angle": angles_deg.tolist(),
                    "adf": h.tolist(),
                }
        return results
