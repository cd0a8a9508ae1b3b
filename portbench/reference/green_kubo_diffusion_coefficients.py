"""Plain reference of ``GreenKuboDiffusionCoefficients`` and the judge of its answers.

MDSuite's Green-Kubo self-diffusion (``green_kubo_self_diffusion_coefficients.py``),
worked out from the velocities the configuration generated, with nothing of
the program and no FFT. Per species, windows of ``data_range`` frames start
every ``correlation_time`` frames while they fit; a window's biased VACF
summed over ions and axes is ``acf_w[m] = sum_{t < R - m} v(t) . v(t + m) /
R`` (``R = data_range``), the m-th superdiagonal sum of the window's Gram
matrix ``V_w V_w^T`` over ``R`` (``portbench/lags.py``: each window's Gram
matrix is a block of the trajectory's, so the products are made once for
the whole trajectory rather than window by window). Then, as MDSuite:

- the VACF: the windows' sum over ``n_windows * (N + 1)`` (MDSuite's
  counter, which counts each window once more), in m^2/s^2;
- ``D = cumtrapz(acf, t)[integration_range - 1] / 3``, ``t = m * timestep *
  sample_rate`` in s, ``integration_range = data_range - 1`` by default;
- the uncertainty: the standard error over the windows of each window's
  running integral of its VACF's mean over the ions, at the same index,
  over 3.

Departures from MDSuite, all the program's too: the windows' ACFs are summed
before the integral (MDSuite integrates each window's and sums); the
products run in ``dtype`` on the device and every sum in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.integrate import cumulative_trapezoid

from portbench.lags import windowed_lag_sums


def resolve_args(args: dict, config: dict) -> dict:
    data_range = int(args.get("data_range", 500))
    return dict(data_range=data_range, correlation_time=int(args.get("correlation_time", 1)),
                integration_range=int(args.get("integration_range") or data_range - 1))


def compute(inputs: dict, config: dict, args: dict,
            dtype: torch.dtype = torch.float64) -> tuple[dict, dict]:
    """``(answer, work)``: the answer as the calculator's ``data_dict`` holds
    it (numpy arrays) from ``inputs["Velocities"]`` ``(F, N, 3)``."""
    a = resolve_args(args, config)
    r = a["data_range"]
    velocities = inputs["Velocities"]
    times = np.arange(r) * config["timestep"] * config["sample_rate"] * config["time_s"]
    vel_scale = (config["length_m"] / config["time_s"]) ** 2
    answer, windows, offset = {}, {}, 0
    for name, n in config["species"].items():
        v = velocities[:, offset:offset + n].reshape(velocities.shape[0], n * 3)
        offset += n
        sums = windowed_lag_sums(v, r, a["correlation_time"], dtype).cpu().numpy() / r
        windows[name] = n_w = sums.shape[0]
        acf = vel_scale * sums.sum(0) / (n_w * (n + 1))
        integral = cumulative_trapezoid(acf, x=times)
        per_window = cumulative_trapezoid(vel_scale * sums / n, x=times, axis=1)
        sem = np.std(per_window, axis=0) / math.sqrt(n_w)
        ir = min(a["integration_range"] - 1, len(integral) - 1)
        answer[name] = {"diffusion_coefficient": np.array([integral[ir] / 3]),
                        "uncertainty": np.array([sem[ir] / 3]), "time": times, "acf": acf,
                        "integral": integral, "integral_uncertainty": sem}
    # what counts/acf.py needs: the FFT estimator's sequences (windows x ions x
    # axes), its padded length, the values read and the per-window ACFs written
    work = dict(sequences=sum(windows[name] * n * 3 for name, n in config["species"].items()),
                fft_len=1 << (2 * r - 1).bit_length(),
                values_read=config["n_frames"] * sum(config["species"].values()) * 3,
                acf_written=sum(windows.values()) * r)
    return answer, work


def judge(answer: dict, reference: dict, work: dict) -> dict:
    """``acf_gap``: the largest |acf - acf_ref| over the lags over acf_ref[0];
    ``d_gap``: |D - D_ref| / |D_ref|; ``sem_gap``: the same of the
    uncertainty; each of the worst species. A missing species, a length or a
    time grid that differs, or a value not finite reads ``inf``."""
    worst = {"acf_gap": 0.0, "d_gap": 0.0, "sem_gap": 0.0}
    failed = {name: float("inf") for name in worst}
    if set(answer) != set(reference):
        return failed
    for key, ref in reference.items():
        got = {k: np.asarray(answer[key][k], dtype=np.float64) for k in ref}
        if any(got[k].shape != ref[k].shape or not np.all(np.isfinite(got[k])) for k in ref):
            return failed
        if np.max(np.abs(got["time"] - ref["time"])) > 1e-9 * np.max(np.abs(ref["time"])):
            return failed
        gaps = {
            "acf_gap": np.max(np.abs(got["acf"] - ref["acf"])) / abs(ref["acf"][0]),
            "d_gap": abs(got["diffusion_coefficient"][0] - ref["diffusion_coefficient"][0])
            / abs(ref["diffusion_coefficient"][0]),
            "sem_gap": abs(got["uncertainty"][0] - ref["uncertainty"][0])
            / abs(ref["uncertainty"][0]),
        }
        for name, value in gaps.items():
            worst[name] = max(worst[name], float(value))
    return worst
