"""Distinct (cross-particle) diffusion coefficients: Einstein and Green-Kubo.

Counterpart of ``lammps_analysis_tpu/calculators/distinct_diffusion_coefficients.py``
(ports of MDSuite's ``einstein_distinct_diffusion_coefficients.py:60-351`` and
``green_kubo_distinct_diffusion_coefficients.py:58-362``, experimental
upstream) with the same arguments, cache key and result layout. The cross
term uses bilinearity, ``mean_{i,j} corr(a_i, b_j) == corr(mean_i a_i,
mean_j b_j)``: a correlation of particle-averaged series, O(N) work. For
identical species the atom-mean self term is subtracted from the mean over
all (i, j) pairs, MDSuite's definition (for independent particles it gives
about -D_self (1 - 1/N), not 0).

Where the JAX package loops over windows on the host, the port takes each
slab's windows in one batch on ``config.device``: the particle sums of the
two species stream to the card (``_stream_properties_multi``) and sum in
float64; the windows of the mean series are one gather at the window starts
plus ``tau_values``, their terms summed in float64. The same-species self term is
the windowed MSD (Einstein, ``ops/msd.py``) or the per-window
autocorrelation (Green-Kubo, ``ops/correlation.py::windowed_acf_sum``, FFT
batches sized from the experiment planner's budget), both float32 with
float64 sums. Atom minibatches add their particle sums and self terms per
slab and finish the slab's windows at its last group, so they give the
one-group series.
"""

from __future__ import annotations

import itertools
import logging
from typing import Any, Dict

import numpy as np
import torch

from ..database.properties import mdsuite_properties as mp
from ..ops import correlation
from ..ops import msd as msd_ops
from ..utils.fitting import fit_einstein_curve
from .base import TrajectoryCalculator

log = logging.getLogger(__name__)


class _DistinctPair(TrajectoryCalculator):
    """The stream shared by both classes: per-slab particle sums and self terms."""

    scale_function = {"linear": {"scale_factor": 10}}
    result_keys = ["diffusion_coefficient", "uncertainty"]

    def _self_term(self, x: torch.Tensor) -> torch.Tensor:
        """Same-species self term of one slab's atom group, summed over its
        particles (additive over atom groups)."""
        raise NotImplementedError

    def _finished_slabs(self, sp_a: str, sp_b: str):
        """Yield ``(mean_a, mean_b, self)`` once per slab, after its last atom
        group: the float64 ``(T, 3)`` particle-mean series of both species and,
        for identical species, the self term divided by the particle count
        (else None)."""
        a = self.args
        pend = None
        for slab, info in self._stream_properties_multi(
            [sp_a, sp_b], self.loaded_property.name, a["data_range"],
            a["correlation_time"], with_info=True,
        ):
            if info.group == 0:
                pend = {"sa": 0.0, "sb": 0.0, "na": 0, "nb": 0, "self": 0.0}
            xa = slab[sp_a]
            pend["sa"] = pend["sa"] + xa.sum(dim=1, dtype=torch.float64)
            pend["na"] += xa.shape[1]
            if sp_a == sp_b:
                pend["self"] = pend["self"] + self._self_term(xa)
            else:
                xb = slab[sp_b]
                pend["sb"] = pend["sb"] + xb.sum(dim=1, dtype=torch.float64)
                pend["nb"] += xb.shape[1]
            if info.group == info.n_groups - 1:
                mean_a = pend["sa"] / pend["na"]
                if sp_a == sp_b:
                    yield mean_a, mean_a, pend["self"] / pend["na"]
                else:
                    yield mean_a, pend["sb"] / pend["nb"], None
                pend = None

    def _windows(self, series: torch.Tensor, tau: torch.Tensor) -> tuple:
        """``(n_windows, R, 3)`` windows of a ``(T, 3)`` slab series gathered at
        the lags ``tau``, and ``(n_windows, 1, 3)`` their origins."""
        starts = correlation.window_starts(
            series.shape[0], self.args["data_range"], self.args["correlation_time"]
        ).to(series.device)
        return series[starts[:, None] + tau], series[starts][:, None]

    def _too_few_frames(self) -> ValueError:
        return ValueError(
            f"{self.name}: data_range {self.args['data_range']} exceeds the "
            f"{self.experiment.number_of_configurations} available configurations."
        )


class EinsteinDistinctDiffusionCoefficients(_DistinctPair):
    """Distinct Einstein diffusion: cross-particle displacement correlations.

    Per window: ``mean_dims[ avg_i d_i^a * avg_j d_j^b ]`` minus the self term
    ``mean_i mean_dims d_i^2`` for identical species (reference
    ``_map_over_particles`` / ``_compute_self_correlation``). D = slope / 2
    (the dimension average is inside the map, reference ``:293-303``).
    """

    loaded_property = mp.unwrapped_positions
    result_series_keys = ["time", "msd"]

    def prepare_args(
        self,
        species: list = None,
        data_range: int = 100,
        correlation_time: int = 1,
        fit_range: int = -1,
        tau_values=None,
        molecules: bool = False,
        atom_selection=None,
        **kwargs,
    ) -> Dict[str, Any]:
        if species is None:
            species = list(self.experiment.species)
        tau_enc = self.encode_tau_values(tau_values)
        if isinstance(tau_enc, list):
            data_range = tau_enc[-1] + 1
        if fit_range == -1:
            fit_range = int(data_range - 1)
        return {
            "species": list(species),
            "data_range": int(data_range),
            "correlation_time": int(correlation_time),
            "fit_range": int(fit_range),
            "molecules": bool(molecules),
            "tau_values": tau_enc,
            "atom_selection": self.encode_atom_selection(atom_selection),
        }

    def _self_term(self, x):
        # sum over windows and particles of the dimension-mean squared
        # displacement: every window's atom-mean self term, summed
        total, _ = msd_ops.windowed_msd_sum(
            x, self.tau_values, self.args["data_range"], self.args["correlation_time"]
        )
        return total / x.shape[2]

    def run_calculator(self) -> Dict[str, dict]:
        a = self.args
        exp = self.experiment
        self._run_dependency_check(a["species"])
        times = self._handle_tau_values() * exp.units.time
        results = {}
        for sp_a, sp_b in itertools.combinations_with_replacement(a["species"], 2):
            tau = None
            msd_sum, n_windows = 0.0, 0
            for mean_a, mean_b, self_sum in self._finished_slabs(sp_a, sp_b):
                if tau is None:
                    tau = torch.as_tensor(self.tau_values, dtype=torch.long, device=mean_a.device)
                wa, oa = self._windows(mean_a, tau)
                wb, ob = self._windows(mean_b, tau)
                cross = ((wa - oa) * (wb - ob)).mean(dim=-1).sum(dim=0)  # (R,)
                if self_sum is not None:
                    cross = cross - self_sum
                msd_sum = msd_sum + cross
                n_windows += wa.shape[0]
            if n_windows == 0:
                raise self._too_few_frames()
            msd = msd_sum.cpu().numpy() / n_windows
            msd *= exp.units.length**2
            try:
                popt, pcov, _, _ = fit_einstein_curve(times, msd, fit_max_index=a["fit_range"])
                sign = 1.0
            except ValueError:
                popt, pcov, _, _ = fit_einstein_curve(
                    times, np.abs(msd), fit_max_index=a["fit_range"]
                )
                sign = -1.0
            error = np.sqrt(np.diag(pcov))[0]
            results[f"{sp_a}_{sp_b}"] = {
                "diffusion_coefficient": sign * popt[0] / 2.0,
                "uncertainty": error / 2.0,
                "time": times.tolist(),
                "msd": msd.tolist(),
            }
        return results


class GreenKuboDistinctDiffusionCoefficients(_DistinctPair):
    """Distinct GK diffusion: cross-particle velocity correlations.

    Per window: the raw (unnormalised) positive-lag cross-correlation
    averaged over dimensions and particle pairs (reference ``correlate``
    helper, ``utils/calculator_helper_methods.py:110-150``), the self term
    subtracted for identical species; D = mean over windows of ``prefactor *
    trapz(vacf, t)`` with ``prefactor = length^2 / (time_unit * (data_range -
    1))`` (``green_kubo_distinct_diffusion_coefficients.py:297-313``), its
    uncertainty the standard error over the windows.
    """

    loaded_property = mp.velocities
    result_series_keys = ["time", "vacf"]

    def prepare_args(
        self,
        species: list = None,
        data_range: int = 500,
        correlation_time: int = 1,
        integration_range: int = None,
        tau_values=None,
        molecules: bool = False,
        atom_selection=None,
        **kwargs,
    ) -> Dict[str, Any]:
        if species is None:
            species = list(self.experiment.species)
        tau_enc = self.encode_tau_values(tau_values)
        if isinstance(tau_enc, list):
            data_range = tau_enc[-1] + 1
        if integration_range is None:
            integration_range = data_range - 1
        return {
            "species": list(species),
            "data_range": int(data_range),
            "correlation_time": int(correlation_time),
            "integration_range": int(integration_range),
            "molecules": bool(molecules),
            "tau_values": tau_enc,
            "atom_selection": self.encode_atom_selection(atom_selection),
        }

    def _self_term(self, x):
        # per window, the sum over particles of the dimension-mean raw
        # autocorrelation of the series gathered at tau_values
        tau = None if self.args.get("tau_values") is None else self.tau_values
        _, per_window = correlation.windowed_acf_sum(
            x, self.args["data_range"], self.args["correlation_time"],
            self.experiment.planner.budget_bytes, tau=tau,
        )  # (n_windows, R): particle-mean biased ACF, summed over dims
        return per_window * (x.shape[1] * per_window.shape[1] / x.shape[2])

    def run_calculator(self) -> Dict[str, dict]:
        a = self.args
        exp = self.experiment
        self._run_dependency_check(a["species"])
        times = self._handle_tau_values()  # raw sim units (reference parity)
        prefactor = exp.units.length**2 / (exp.units.time * (a["data_range"] - 1))
        results = {}
        for sp_a, sp_b in itertools.combinations_with_replacement(a["species"], 2):
            tau = times_t = None
            vacf_sum, sigmas = 0.0, []
            for mean_a, mean_b, self_w in self._finished_slabs(sp_a, sp_b):
                if tau is None:
                    tau = torch.as_tensor(self.tau_values, dtype=torch.long, device=mean_a.device)
                    times_t = torch.as_tensor(times, dtype=torch.float64, device=mean_a.device)
                seg_a, _ = self._windows(mean_a, tau)  # (n_windows, R, 3)
                seg_b, _ = self._windows(mean_b, tau)
                # sum_t b[t] a[t + k], mean over dimensions
                cross = correlation.cross_correlation_biased(seg_b, seg_a, dim=1).mean(dim=-1)
                cross = cross * seg_a.shape[1]
                if self_w is not None:
                    cross = cross - self_w
                vacf_sum = vacf_sum + cross.sum(dim=0)
                sigmas.append(prefactor * torch.trapezoid(cross, x=times_t, dim=-1))
            if not sigmas:
                raise self._too_few_frames()
            sigmas = torch.cat(sigmas).cpu().numpy()
            vacf = vacf_sum.cpu().numpy() / len(sigmas)
            results[f"{sp_a}_{sp_b}"] = {
                "diffusion_coefficient": float(np.mean(sigmas)),
                "uncertainty": float(np.std(sigmas) / np.sqrt(len(sigmas))),
                "time": times.tolist(),
                "vacf": vacf.tolist(),
            }
        return results
