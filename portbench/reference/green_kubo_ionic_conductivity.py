"""Plain reference of ``GreenKuboIonicConductivity`` and the judge of its answers.

MDSuite's Green-Kubo ionic conductivity (``green_kubo_ionic_conductivity.py``),
worked out from the velocities the configuration generated, with nothing of
the program and no FFT. The ionic current ``J(t) = sum_s q_s sum_i v_i(t)``
``(F, 3)`` is summed in float64 (the velocities taken in ``dtype``, the
charges from the configuration); windows of ``data_range`` frames start
every ``correlation_time`` frames while they fit, and a window's biased ACF
summed over the axes is ``acf_w[m] = sum_{t < R - m} J(t) . J(t + m) / R``
by direct lag sums (``portbench/lags.py``). Then, as MDSuite:

- the ACF: the windows' mean (sim units, (e A/ps)^2);
- ``sigma = e^2 / (3 V k_B T) * cumtrapz(acf, t)[integration_range - 1]``
  with ``t = m * timestep * sample_rate`` in the simulation's time unit and
  the conversions of MDSuite's prefactor written out: ``e^2 L^2 / (3 k_B T V
  L^3 t_unit)``, ``V`` the box's volume in A^3, so sigma is in S/m;
- the uncertainty: the prefactor times the standard error over the windows
  of each window's running integral.

Departures from MDSuite, all the program's too: the windows' ACFs are
averaged before the integral; the products run in ``dtype`` on the device
and every sum in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.integrate import cumulative_trapezoid

from portbench.lags import windowed_lag_sums

ELEMENTARY_CHARGE_C = 1.602176634e-19
BOLTZMANN_J_K = 1.380649e-23


def resolve_args(args: dict, config: dict) -> dict:
    data_range = int(args.get("data_range", 500))
    return dict(data_range=data_range, correlation_time=int(args.get("correlation_time", 1)),
                integration_range=int(args.get("integration_range") or data_range - 1))


def prefactor(config: dict) -> float:
    """e^2 L^2 / (3 k_B T V L^3 t_unit): S/m from sim units' integral."""
    volume = float(config["box_length"]) ** 3
    return (ELEMENTARY_CHARGE_C ** 2 * config["length_m"] ** 2
            / (3 * BOLTZMANN_J_K * config["temperature"] * volume * config["length_m"] ** 3
               * config["time_s"]))


def compute(inputs: dict, config: dict, args: dict,
            dtype: torch.dtype = torch.float64) -> tuple[dict, dict]:
    """``(answer, work)``: the answer as the calculator's ``data_dict`` holds
    it (numpy arrays) from ``inputs["Velocities"]`` ``(F, N, 3)``."""
    a = resolve_args(args, config)
    r = a["data_range"]
    velocities = inputs["Velocities"]
    charges = torch.cat([torch.full((n,), float(config["charges"][name]), device=velocities.device)
                         for name, n in config["species"].items()])
    current = torch.sum(velocities.to(dtype) * charges.to(dtype)[None, :, None], dim=1,
                        dtype=torch.float64)
    sums = windowed_lag_sums(current, r, a["correlation_time"], dtype).cpu().numpy() / r
    n_w = sums.shape[0]
    times = np.arange(r) * config["timestep"] * config["sample_rate"]
    acf = sums.sum(0) / n_w
    integral = cumulative_trapezoid(acf, x=times)
    sem = np.std(cumulative_trapezoid(sums, x=times, axis=1), axis=0) / math.sqrt(n_w)
    ir = min(a["integration_range"] - 1, len(integral) - 1)
    k = prefactor(config)
    answer = {"System": {"ionic_conductivity": np.array([k * integral[ir]]),
                         "uncertainty": np.array([k * sem[ir]]), "time": times, "acf": acf,
                         "integral": integral, "integral_uncertainty": sem}}
    work = dict(sequences=n_w * 3, fft_len=1 << (2 * r - 1).bit_length(),
                values_read=config["n_frames"] * 3, acf_written=n_w * r, prefactor=k)
    return answer, work


def judge(answer: dict, reference: dict, work: dict) -> dict:
    """``acf_gap``: the largest |acf - acf_ref| over the lags over acf_ref[0];
    ``sigma_gap``: |sigma - sigma_ref| over the largest conductivity an ACF
    of amplitude acf_ref[0] can integrate to in the window (prefactor x
    acf_ref[0] x the window's span). Not over sigma_ref: at 8 ps the
    integral's sampling noise is larger than its mean, so sigma_ref may lie
    near 0 on a seed. A missing series, a length or a time grid that
    differs, or a value not finite reads ``inf``."""
    failed = {"acf_gap": float("inf"), "sigma_gap": float("inf")}
    if set(answer) != {"System"}:
        return failed
    ref = reference["System"]
    got = {k: np.asarray(answer["System"][k], dtype=np.float64) for k in ref}
    if any(got[k].shape != ref[k].shape or not np.all(np.isfinite(got[k])) for k in ref):
        return failed
    if np.max(np.abs(got["time"] - ref["time"])) > 1e-9 * np.max(np.abs(ref["time"])):
        return failed
    scale = abs(ref["acf"][0])
    sigma_scale = work["prefactor"] * scale * (ref["time"][-1] - ref["time"][0])
    return {
        "acf_gap": float(np.max(np.abs(got["acf"] - ref["acf"])) / scale),
        "sigma_gap": float(abs(got["ionic_conductivity"][0] - ref["ionic_conductivity"][0])
                           / sigma_scale),
    }
