"""System (flux-series) transport-coefficient calculators.

Counterpart of ``lammps_analysis_tpu/calculators/system_calculators.py`` with
the same arguments, cache keys, prefactors and result layouts. These operate
on the single ``Observables/<property>`` time series rather than per-atom
data: it streams to ``config.device`` in window-aligned slabs
(``_stream_property`` with one particle), the windowed ACF
(``ops/correlation.py``, FFT batches sized from the experiment planner's
budget) or MSD (``ops/msd.py``) runs there with float64 sums, and the
integrals, fits and prefactors run on the host in float64.

Ports (file:line refer to MDSuite's ``mdsuite/calculators/``):

* GreenKuboIonicConductivity      — ``green_kubo_ionic_conductivity.py:61-310``
* EinsteinHelfandIonicConductivity— ``einstein_helfand_ionic_conductivity.py:54-236``
* GreenKuboThermalConductivity    — ``green_kubo_thermal_conductivity.py:55-281``
* EinsteinHelfandThermalConductivity — ``einstein_helfand_thermal_conductivity.py:53-261``
* EinsteinHelfandThermalKinaci    — ``einstein_helfand_thermal_kinaci.py:54-267``
* GreenKuboViscosity              — ``green_kubo_viscosity.py:55-275``
* GreenKuboViscosityFlux          — ``green_kubo_viscosity_flux.py:55-273``

Note on the GK thermal/viscosity family: the reference's versions report
the FIRST window's integral as the value and the SECOND window's as the
"uncertainty" (``green_kubo_thermal_conductivity.py:199-233``; per-window
``sigma.append(trapz(jacf_w))`` then ``result[0]/result[1]``) — their
integration tests are disabled upstream. This build defaults to the
window-averaged formulation (identical to the *tested* GK
ionic-conductivity path) with the reference's exact prefactors: ACF
averaged over windows, trapezoid-integrated to ``integration_range``,
SEM over per-window integrals. Pass ``reference_estimator=True`` for the
upstream first-window estimator, reproduced exactly
(:meth:`_SystemWindowedCalculator._gk_flow_reference`).
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np
from scipy.integrate import cumulative_trapezoid

from ..database.properties import mdsuite_properties as mp
from ..ops import correlation, msd
from ..utils.constants import DatasetKeys
from ..utils.fitting import fit_einstein_curve
from ..utils.units import boltzmann_constant, elementary_charge
from .base import TrajectoryCalculator

log = logging.getLogger(__name__)


class _SystemWindowedCalculator(TrajectoryCalculator):
    """Shared flow for Observables-series calculators."""

    system_property = True

    def prepare_args(
        self,
        data_range: int = 500,
        correlation_time: int = 1,
        tau_values=None,
        integration_range: int = None,
        fit_range: int = -1,
        reference_estimator: bool = False,
        **kwargs,
    ) -> Dict[str, Any]:
        tau_enc = self.encode_tau_values(tau_values)
        if isinstance(tau_enc, list):
            # explicit lag list pins the window length
            # (reference ``trajectory_calculator.py:210-214``)
            data_range = tau_enc[-1] + 1
        args = {
            "data_range": int(data_range),
            "correlation_time": int(correlation_time),
            "tau_values": tau_enc,
        }
        if self._uses_integration:
            if integration_range is None:
                integration_range = self._default_integration_range(data_range)
            args["integration_range"] = int(integration_range)
        else:
            if fit_range == -1:
                fit_range = int(data_range - 1)
            args["fit_range"] = int(fit_range)
        if self._supports_reference_estimator:
            args["reference_estimator"] = bool(reference_estimator)
        elif reference_estimator:
            raise ValueError(
                f"{self.name}: reference_estimator applies only to the GK "
                "thermal-conductivity/viscosity family (the reference's "
                "other estimators are already reproduced exactly)."
            )
        return args

    _uses_integration = True
    #: True on the GK thermal/viscosity family, whose upstream estimator
    #: reports the FIRST window's integral as the value and the SECOND
    #: window's as the uncertainty (their integration tests are disabled
    #: upstream); ``reference_estimator=True`` reproduces that exactly.
    _supports_reference_estimator = False

    @staticmethod
    def _default_integration_range(data_range: int) -> int:
        return data_range - 1

    # -- data access ----------------------------------------------------------
    def _series_windows_acf(self):
        """Yield per-slab float64 numpy ``(acf_sum (R,), per_window (n_w,
        R))`` over the Observables series.

        When ``tau_values`` sub-samples the window, each window is gathered
        at those lags before the ACF (reference
        ``green_kubo_ionic_conductivity.py:201``).
        """
        a = self.args
        tau = None if a.get("tau_values") is None else self.tau_values
        budget = self.experiment.planner.budget_bytes  # sizes the FFT batches
        for slab in self._stream_property(
            DatasetKeys.OBSERVABLES,
            self.loaded_property.name,
            a["data_range"],
            a["correlation_time"],
        ):
            s, per_window = correlation.windowed_acf_sum(
                slab, a["data_range"], a["correlation_time"], budget, tau=tau
            )
            yield s.cpu().numpy(), per_window.cpu().numpy()

    def _series_windows_msd(self):
        """Yield per-slab ``(msd_sum (R,) float64 numpy, n_windows)``."""
        a = self.args
        for slab in self._stream_property(
            DatasetKeys.OBSERVABLES,
            self.loaded_property.name,
            a["data_range"],
            a["correlation_time"],
        ):
            s, n_windows = msd.windowed_msd_sum(
                slab, self.tau_values, a["data_range"], a["correlation_time"]
            )
            yield s.cpu().numpy(), n_windows

    # -- common GK/EH flows ---------------------------------------------------
    def _gk_flow_reference(
        self, prefactor: float, acf_scale: float
    ) -> Dict[str, dict]:
        """The reference's exact GK thermal/viscosity estimator.

        Per window w: ``jacf_w = data_range * sum_dims biased_acf`` and
        ``sigma_w = trapz(jacf_w[:integration_range],
        x=time[:integration_range])``; the reported value is
        ``prefactor * sigma_0`` (the FIRST window's integral) and the
        "uncertainty" is ``prefactor * sigma_1`` (the second window's) —
        ``green_kubo_thermal_conductivity.py:199-233``,
        ``green_kubo_viscosity.py:185-221``. The ``acf`` series is the
        running SUM of window ACFs (not averaged), also as upstream.
        """
        a = self.args
        times = self._handle_tau_values()
        ir = a["integration_range"]
        acf_running = np.zeros(self.data_resolution)
        sigmas = []
        for s, per_window in self._series_windows_acf():
            w = acf_scale * per_window
            acf_running += acf_scale * s
            sigmas.extend(
                np.trapezoid(w[:, :ir], x=times[:ir], axis=1).tolist()
            )
        if len(sigmas) < 2:
            raise ValueError(
                f"{self.name}: reference_estimator needs at least two "
                "windows (value = first window, uncertainty = second)."
            )
        value = prefactor * sigmas[0]
        value_sem = prefactor * sigmas[1]
        log.info(
            "%s = %.6e (+- %.2e) [reference estimator]",
            self.name, value, value_sem,
        )
        return {
            "System": {
                self.result_keys[0]: [float(value)],
                self.result_keys[1]: [float(value_sem)],
                "time": times.tolist(),
                "acf": acf_running.tolist(),
                "integral": (prefactor * np.asarray(sigmas)).tolist(),
                "integral_uncertainty": [],
            }
        }

    def _gk_flow(self, prefactor: float, acf_scale: float = 1.0) -> Dict[str, dict]:
        """Window-averaged ACF -> cumtrapz -> prefactor * integral + SEM."""
        a = self.args
        if a.get("reference_estimator"):
            return self._gk_flow_reference(prefactor, acf_scale)
        times = self._handle_tau_values()  # raw sim units (reference parity)
        acf_sum = np.zeros(self.data_resolution)
        sigmas = []
        count = 0
        for s, per_window in self._series_windows_acf():
            acf_sum += acf_scale * s
            sigmas.append(
                cumulative_trapezoid(
                    acf_scale * per_window,
                    x=times, axis=1,
                )
            )
            count += per_window.shape[0]
        if count == 0:
            raise ValueError(
                f"{self.name}: data_range {a['data_range']} exceeds the "
                "available configurations."
            )
        acf = acf_sum / count
        sigma = cumulative_trapezoid(acf, x=times)
        sigmas = np.concatenate(sigmas, axis=0)
        sigma_sem = np.std(sigmas, axis=0) / np.sqrt(len(sigmas))
        # cumtrapz yields W-1 points; integration_range == data_range means
        # "integrate the full window" (reference trapz[:integration_range])
        ir = min(a["integration_range"] - 1, len(sigma) - 1)
        value = prefactor * sigma[ir]
        value_sem = prefactor * sigma_sem[ir]
        log.info("%s = %.6e (+- %.2e)", self.name, value, value_sem)
        return {
            "System": {
                self.result_keys[0]: [float(value)],
                self.result_keys[1]: [float(value_sem)],
                "time": times.tolist(),
                "acf": acf.tolist(),
                "integral": sigma.tolist(),
                "integral_uncertainty": sigma_sem.tolist(),
            }
        }

    def _eh_flow(self, prefactor: float) -> Dict[str, dict]:
        """Windowed MSD of an integrated current -> linear fit -> value/6."""
        a = self.args
        times = self._handle_tau_values()  # raw sim units (reference parity)
        msd_sum = np.zeros(self.data_resolution)
        count = 0
        for s, n_windows in self._series_windows_msd():
            msd_sum += s
            count += int(n_windows)
        if count == 0:
            raise ValueError(
                f"{self.name}: data_range {a['data_range']} exceeds the "
                "available configurations."
            )
        msd = prefactor * msd_sum / count
        popt, pcov, gradients, gradient_errors = fit_einstein_curve(
            times, msd, fit_max_index=a["fit_range"]
        )
        error = np.sqrt(np.diag(pcov))[0]
        value = popt[0] / 6.0
        log.info("%s = %.6e (+- %.2e)", self.name, value, error / 6.0)
        return {
            "System": {
                self.result_keys[0]: float(value),
                self.result_keys[1]: float(error / 6.0),
                "time": times.tolist(),
                "msd": msd.tolist(),
            }
        }

    def run_calculator(self) -> Dict[str, dict]:
        self._run_dependency_check()
        return self._run_system()

    def _run_system(self) -> Dict[str, dict]:
        raise NotImplementedError


class GreenKuboIonicConductivity(_SystemWindowedCalculator):
    """sigma from the ionic-current ACF (depends on the IonicCurrent trafo)."""

    loaded_property = mp.ionic_current
    scale_function = {"linear": {"scale_factor": 5}}
    result_keys = ["ionic_conductivity", "uncertainty"]
    result_series_keys = ["time", "acf", "integral", "integral_uncertainty"]

    def _prefactor(self) -> float:
        # reference ``green_kubo_ionic_conductivity.py:167-186``
        exp = self.experiment
        numerator = elementary_charge**2 * exp.units.length**2
        denominator = (
            3
            * boltzmann_constant
            * exp.temperature
            * exp.volume
            * exp.units.volume
            * exp.units.time
        )
        return numerator / denominator

    def _run_system(self):
        return self._gk_flow(self._prefactor())


class EinsteinHelfandIonicConductivity(_SystemWindowedCalculator):
    """sigma from the translational-dipole-moment MSD."""

    loaded_property = mp.translational_dipole_moment
    scale_function = {"linear": {"scale_factor": 5}}
    result_keys = ["ionic_conductivity", "uncertainty"]
    result_series_keys = ["time", "msd"]
    _uses_integration = False

    def _prefactor(self) -> float:
        # reference ``einstein_helfand_ionic_conductivity.py:142-158``
        exp = self.experiment
        numerator = exp.units.length**2 * elementary_charge**2
        denominator = (
            exp.units.time
            * exp.volume
            * exp.units.volume
            * exp.temperature
            * boltzmann_constant
        )
        return numerator / denominator

    def _run_system(self):
        return self._eh_flow(self._prefactor())


class GreenKuboThermalConductivity(_SystemWindowedCalculator):
    """kappa from the thermal-flux ACF (depends on the ThermalFlux trafo)."""

    loaded_property = mp.thermal_flux
    scale_function = {"linear": {"scale_factor": 5}}
    result_keys = ["thermal_conductivity", "uncertainty"]
    result_series_keys = ["time", "acf", "integral", "integral_uncertainty"]
    _supports_reference_estimator = True

    @staticmethod
    def _default_integration_range(data_range: int) -> int:
        return data_range  # reference default (:129)

    def _prefactor(self) -> float:
        # reference ``green_kubo_thermal_conductivity.py:153-177``
        exp = self.experiment
        a = self.args
        denominator = (
            3
            * (a["data_range"] - 1)
            * exp.temperature**2
            * exp.units.boltzmann
            * exp.volume
        )
        prefactor_units = exp.units.energy / exp.units.length / exp.units.time
        return prefactor_units / denominator

    def _run_system(self):
        # reference multiplies the biased ACF by data_range (:203)
        return self._gk_flow(
            self._prefactor(), acf_scale=float(self.args["data_range"])
        )


class EinsteinHelfandThermalConductivity(_SystemWindowedCalculator):
    """kappa from the integrated heat current MSD."""

    loaded_property = mp.integrated_heat_current
    scale_function = {"linear": {"scale_factor": 5}}
    result_keys = ["thermal_conductivity", "uncertainty"]
    result_series_keys = ["time", "msd"]
    _uses_integration = False

    def _prefactor(self) -> float:
        # reference ``einstein_helfand_thermal_conductivity.py:151-172``
        exp = self.experiment
        denominator = exp.volume * exp.temperature * exp.units.boltzmann
        units_change = (
            exp.units.energy
            / exp.units.length
            / exp.units.time
            / exp.units.temperature
        )
        return units_change / denominator

    def _run_system(self):
        return self._eh_flow(self._prefactor())


class EinsteinHelfandThermalKinaci(_SystemWindowedCalculator):
    """kappa via the Kinaci integrated heat current MSD."""

    loaded_property = mp.kinaci_heat_current
    scale_function = {"linear": {"scale_factor": 5}}
    result_keys = ["thermal_conductivity", "uncertainty"]
    result_series_keys = ["time", "msd"]
    _uses_integration = False

    def _prefactor(self) -> float:
        # reference ``einstein_helfand_thermal_kinaci.py`` (same as EH thermal)
        exp = self.experiment
        denominator = exp.volume * exp.temperature * exp.units.boltzmann
        units_change = (
            exp.units.energy
            / exp.units.length
            / exp.units.time
            / exp.units.temperature
        )
        return units_change / denominator

    def _run_system(self):
        return self._eh_flow(self._prefactor())


class GreenKuboViscosity(_SystemWindowedCalculator):
    """eta from the momentum-flux (off-diagonal stress) ACF."""

    loaded_property = mp.momentum_flux
    scale_function = {"linear": {"scale_factor": 5}}
    result_keys = ["viscosity", "uncertainty"]
    result_series_keys = ["time", "acf", "integral", "integral_uncertainty"]
    _supports_reference_estimator = True

    @staticmethod
    def _default_integration_range(data_range: int) -> int:
        return data_range

    def _prefactor(self) -> float:
        # reference ``green_kubo_viscosity.py:147-172``
        exp = self.experiment
        a = self.args
        denominator = (
            3
            * (a["data_range"] - 1)
            * exp.temperature
            * exp.units.boltzmann
            * exp.volume
        )
        prefactor_units = (
            exp.units.pressure**2
            * exp.units.volume
            * exp.units.time
            / exp.units.energy
        )
        return prefactor_units / denominator

    def _run_system(self):
        return self._gk_flow(
            self._prefactor(), acf_scale=float(self.args["data_range"])
        )


class GreenKuboViscosityFlux(_SystemWindowedCalculator):
    """eta directly from flux-file stress columns (``Stress_Visc``)."""

    loaded_property = mp.stress_viscosity
    scale_function = {"linear": {"scale_factor": 5}}
    result_keys = ["viscosity", "uncertainty"]
    result_series_keys = ["time", "acf", "integral", "integral_uncertainty"]
    _supports_reference_estimator = True

    @staticmethod
    def _default_integration_range(data_range: int) -> int:
        return data_range

    def _prefactor(self) -> float:
        # reference ``green_kubo_viscosity_flux.py`` — volume in the numerator
        exp = self.experiment
        a = self.args
        numerator = exp.volume
        denominator = (
            3 * (a["data_range"] - 1) * exp.temperature * exp.units.boltzmann
        )
        prefactor_units = (
            exp.units.pressure**2
            * exp.units.volume
            * exp.units.time
            / exp.units.energy
        )
        return numerator / denominator * prefactor_units

    def _run_system(self):
        return self._gk_flow(
            self._prefactor(), acf_scale=float(self.args["data_range"])
        )
