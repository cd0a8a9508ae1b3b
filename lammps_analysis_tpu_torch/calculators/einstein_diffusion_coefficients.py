"""Einstein self-diffusion coefficients.

Counterpart of ``lammps_analysis_tpu/calculators/einstein_diffusion_coefficients.py``
(port of ``mdsuite/calculators/einstein_diffusion_coefficients.py:64-322``)
with the same arguments, cache key and result layout: windowed MSD over
sliding ensembles (stride ``correlation_time``), the reference's
normalisation (sum over windows and particles divided by
``n_windows * (n_particles + 1)``: the reference increments its counter both
per window *and* per particle, ``:176,245``), SI conversion, spline-onset
linear fit, D = slope / 6. ``Unwrapped_Positions`` stream from the store to
the device slab by slab (the dependency check runs ``CoordinateUnwrapper``
first when they are missing, or with ``config.fuse_streaming`` the stream
unwraps the wrapped positions on the fly and stores nothing); the comb MSD
runs there in float32 with float64 sums, its particles split over the
default mesh (``sharded_windowed_msd``); the fit runs on the host. Spans
(``utils/profiling.py``): ``einstein.fetch`` a slab's sums to the host,
``einstein.normalise`` the normalisation and the fit.
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np

from ..database.properties import mdsuite_properties as mp
from ..memory.planner import BatchPlanner
from ..parallel.sharded_ops import sharded_windowed_msd
from ..utils import profiling
from ..utils.fitting import fit_einstein_curve
from .base import TrajectoryCalculator

log = logging.getLogger(__name__)


class EinsteinDiffusionCoefficients(TrajectoryCalculator):
    """Self-diffusion from the mean-squared displacement."""

    loaded_property = mp.unwrapped_positions
    #: with config.fuse_streaming, unwrap on the fly instead of materialising
    #: Unwrapped_Positions (every slab streams through _stream_property)
    supports_fused_streaming = True
    scale_function = {"linear": {"scale_factor": 10}}
    result_keys = ["diffusion_coefficient", "uncertainty", "gradient", "intercept"]
    result_series_keys = ["time", "msd", "gradients", "gradient_errors"]

    def prepare_args(
        self,
        species: list = None,
        data_range: int = 100,
        correlation_time: int = 1,
        tau_values=None,
        molecules: bool = False,
        fit_range: int = -1,
        atom_selection=None,
        **kwargs,
    ) -> Dict[str, Any]:
        exp = self.experiment
        if species is None:
            species = list(exp.molecules) if molecules else list(exp.species)
        if fit_range == -1:
            fit_range = int(data_range - 1)
        args = {
            "species": list(species),
            "data_range": int(data_range),
            "correlation_time": int(correlation_time),
            "molecules": bool(molecules),
            "fit_range": int(fit_range),
        }
        if isinstance(tau_values, (int, list, np.ndarray)):
            args["tau_values"] = (
                int(tau_values)
                if isinstance(tau_values, int)
                else [int(t) for t in tau_values]
            )
        else:
            args["tau_values"] = None
        args["atom_selection"] = self.encode_atom_selection(atom_selection)
        return args

    def run_calculator(self) -> Dict[str, dict]:
        a = self.args
        exp = self.experiment
        results = {}
        for sp in a["species"]:
            self._run_dependency_check([sp])
            times = self._handle_tau_values()
            data_range = self.args["data_range"]

            # the reference counter: n_particles per window plus 1 per
            # window. The window-aligned slabs enumerate every window exactly
            # once per atom group and the squared displacements add over
            # slabs and atom groups, so the count is the analytic total
            n_windows_total = BatchPlanner.window_plan(
                exp.number_of_configurations, data_range,
                a["correlation_time"],
            )
            if n_windows_total == 0:
                raise ValueError(
                    f"{self.name}: data_range {data_range} exceeds the "
                    f"{exp.number_of_configurations} available configurations."
                )
            n_particles = self.selected_counts([sp])[0]
            count = n_windows_total * (n_particles + 1)

            msd_sum = np.zeros(self.data_resolution)
            for slab in self._stream_property(
                sp, self.loaded_property.name, data_range, a["correlation_time"]
            ):
                s, _ = sharded_windowed_msd(
                    slab, self.tau_values, data_range, a["correlation_time"]
                )
                with profiling.annotate("einstein.fetch"):
                    msd_sum += s.cpu().numpy()
            with profiling.annotate("einstein.normalise"):
                msd = msd_sum / count
                msd *= exp.units.length**2  # -> m^2 (:196)
                time_si = times * exp.units.time

                popt, pcov, gradients, gradient_errors = fit_einstein_curve(
                    time_si, msd, fit_max_index=a["fit_range"]
                )
                error = np.sqrt(np.diag(pcov))[0]
                results[sp] = {
                    "diffusion_coefficient": popt[0] / 6.0,
                    "uncertainty": error / 6.0,
                    "gradient": popt[0],
                    "intercept": popt[1],
                    "time": time_si.tolist(),
                    "msd": msd.tolist(),
                    "gradients": (np.asarray(gradients) / 6.0).tolist(),
                    "gradient_errors": (np.asarray(gradient_errors) / 6.0).tolist(),
                }
            log.info(
                "%s D_%s = %.4e m^2/s", self.name, sp, popt[0] / 6.0
            )
        return results
