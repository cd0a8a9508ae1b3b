"""Green-Kubo self-diffusion coefficients.

Counterpart of ``lammps_analysis_tpu/calculators/green_kubo_diffusion_coefficients.py``
(port of ``mdsuite/calculators/green_kubo_self_diffusion_coefficients.py``)
with the same arguments, cache key and result layout: per-window biased VACF
(the FFT estimator of ``ops/correlation.py``, on the device, its particles
split over the default mesh by ``sharded_windowed_acf``), unit scaling to
m^2/s^2, the reference's ``n_windows * (n_particles + 1)`` normalisation,
D = (1/3) * cumulative-trapezoid integral at ``integration_range - 1``, SEM
over per-window integrals. The ACF sums accumulate in float64 on the host.
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np
from scipy.integrate import cumulative_trapezoid

from ..database.properties import mdsuite_properties as mp
from ..memory.planner import BatchPlanner
from ..parallel.sharded_ops import sharded_windowed_acf
from .base import TrajectoryCalculator

log = logging.getLogger(__name__)


class GreenKuboDiffusionCoefficients(TrajectoryCalculator):
    """Self-diffusion from the velocity autocorrelation function."""

    loaded_property = mp.velocities
    scale_function = {"linear": {"scale_factor": 150}}
    result_keys = ["diffusion_coefficient", "uncertainty"]
    result_series_keys = ["time", "acf", "integral", "integral_uncertainty"]

    def prepare_args(
        self,
        species: list = None,
        data_range: int = 500,
        correlation_time: int = 1,
        tau_values=None,
        molecules: bool = False,
        integration_range: int = None,
        atom_selection=None,
        **kwargs,
    ) -> Dict[str, Any]:
        exp = self.experiment
        if species is None:
            species = list(exp.molecules) if molecules else list(exp.species)
        tau_enc = self.encode_tau_values(tau_values)
        if isinstance(tau_enc, list):
            data_range = tau_enc[-1] + 1
        if integration_range is None:
            integration_range = data_range - 1
        return {
            "species": list(species),
            "data_range": int(data_range),
            "correlation_time": int(correlation_time),
            "molecules": bool(molecules),
            "integration_range": int(integration_range),
            "tau_values": tau_enc,
            "atom_selection": self.encode_atom_selection(atom_selection),
        }

    def run_calculator(self) -> Dict[str, dict]:
        a = self.args
        exp = self.experiment
        results = {}
        vel_scale = exp.units.length**2 / exp.units.time**2
        budget = exp.planner.budget_bytes  # sizes the ACF's FFT batches
        for sp in a["species"]:
            self._run_dependency_check([sp])
            times = self._handle_tau_values() * exp.units.time
            data_range = a["data_range"]
            tau = None if a.get("tau_values") is None else self.tau_values

            # analytic reference counter (n_windows * (n_particles + 1)):
            # the ACF sums add over frame slabs and atom groups
            n_windows_total = BatchPlanner.window_plan(
                exp.number_of_configurations, data_range,
                a["correlation_time"],
            )
            if n_windows_total == 0:
                raise ValueError(
                    f"{self.name}: data_range {data_range} exceeds available "
                    "configurations."
                )
            n_particles = self.selected_counts([sp])[0]
            count = n_windows_total * (n_particles + 1)

            acf_sum = np.zeros(self.data_resolution)
            # per-slab per-window particle-mean ACFs; when the atom axis is
            # minibatched, group g's particle MEAN is re-weighted by its
            # atom count and summed across groups (mean over N = sum_g n_g *
            # mean_g / N), reconstructing the per-window series for the SEM
            # (reference :199-206)
            per_window_acc: list = []
            for slab, info in self._stream_property(
                sp, self.loaded_property.name, data_range,
                a["correlation_time"], with_info=True,
            ):
                s, per_window = sharded_windowed_acf(
                    slab, data_range, a["correlation_time"], budget, tau=tau
                )
                acf_sum += vel_scale * s.cpu().numpy()
                w = vel_scale * per_window.cpu().numpy()
                if info.n_groups > 1:
                    w = w * (slab.shape[1] / n_particles)
                if info.group == 0:
                    per_window_acc.append(w)
                else:
                    per_window_acc[info.slab_index] += w

            acf = acf_sum / count
            sigma = cumulative_trapezoid(acf, x=times)
            # per-window integrals for the SEM (reference :199-206)
            sigmas = np.concatenate(
                [
                    cumulative_trapezoid(w, x=times, axis=1)
                    for w in per_window_acc
                ],
                axis=0,
            )
            sigma_sem = np.std(sigmas, axis=0) / np.sqrt(len(sigmas))

            ir = min(a["integration_range"] - 1, len(sigma) - 1)
            results[sp] = {
                "diffusion_coefficient": [float(sigma[ir] / 3.0)],
                "uncertainty": [float(sigma_sem[ir] / 3.0)],
                "time": times.tolist(),
                "acf": acf.tolist(),
                "integral": sigma.tolist(),
                "integral_uncertainty": sigma_sem.tolist(),
            }
            log.info("%s D_%s = %.4e m^2/s", self.name, sp, sigma[ir] / 3.0)
        return results
