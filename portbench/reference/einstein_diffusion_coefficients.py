"""Plain reference of ``EinsteinDiffusionCoefficients`` and the judge of its answers.

MDSuite's windowed mean-squared displacement, worked out from the positions
the configuration generated, with nothing of the program. Each species'
positions are unwrapped (the image count is minus the running sum of
``round((x_t - x_{t-1}) / box)``, zero at the first frame); windows of
``data_range`` frames start every ``correlation_time`` frames while they fit;
``msd(tau)`` is the sum over windows, atoms and axes of ``(x(t0 + tau) -
x(t0))^2`` for every lag ``tau < data_range``, over ``n_windows *
(n_atoms + 1)`` (MDSuite's counter, which counts each window once more),
in m^2, against ``tau * timestep * sample_rate`` in s. The unwrap and the
sums run on the device in ``dtype`` (float64 for the reference); the sums
accumulate in float64. The fit of D on this MSD is host post-processing of
the compared series and is not compared.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_args(args: dict, config: dict) -> dict:
    return dict(data_range=int(args.get("data_range", 100)),
                correlation_time=int(args.get("correlation_time", 1)))


def msd_sums(x: torch.Tensor, box: float, data_range: int, stride: int,
             dtype: torch.dtype) -> tuple[torch.Tensor, int]:
    """``(sums (data_range,) float64, n_windows)`` of one species ``(F, N, 3)``."""
    x = x.to(dtype)
    jumps = torch.round(torch.diff(x, dim=0) / box)
    image = torch.cat([torch.zeros_like(x[:1]), -torch.cumsum(jumps, dim=0)])
    u = x + image * box
    starts = torch.arange(0, x.shape[0] - data_range + 1, stride, device=x.device)
    origin = u[starts]
    sums = torch.stack([
        ((u[starts + tau] - origin) ** 2).sum(dtype=torch.float64) for tau in range(data_range)
    ])
    return sums, len(starts)


def compute(positions: torch.Tensor, config: dict, args: dict,
            dtype: torch.dtype = torch.float64) -> tuple[dict, dict]:
    """``(answer, work)``: the answer as the calculator's ``data_dict`` holds
    it (numpy arrays)."""
    a = resolve_args(args, config)
    box = float(config["box_length"])
    answer, offset = {}, 0
    for name, n in config["species"].items():
        sums, n_windows = msd_sums(positions[:, offset:offset + n], box, a["data_range"],
                                   a["correlation_time"], dtype)
        offset += n
        msd = sums.cpu().numpy() / (n_windows * (n + 1)) * config["length_m"] ** 2
        time = (np.arange(a["data_range"]) * config["timestep"] * config["sample_rate"]
                * config["time_s"])
        answer[name] = {"msd": msd, "time": time}
    return answer, dict(frames=config["n_frames"], n_atoms=offset)


def judge(answer: dict, reference: dict, work: dict) -> dict:
    """``msd_gap``: the largest |msd - msd_ref| / msd_ref over every species
    and lag but 0 (where both are 0). A missing species, a length or a time
    grid that differs reads ``inf``."""
    gap = 0.0
    if set(answer) != set(reference):
        return {"msd_gap": float("inf")}
    for key, ref in reference.items():
        msd = np.asarray(answer[key]["msd"], dtype=np.float64)
        time = np.asarray(answer[key]["time"], dtype=np.float64)
        if msd.shape != ref["msd"].shape or time.shape != ref["time"].shape:
            return {"msd_gap": float("inf")}
        if np.max(np.abs(time - ref["time"])) > 1e-9 * np.max(np.abs(ref["time"])):
            return {"msd_gap": float("inf")}
        if msd[0] != 0.0 or not np.all(np.isfinite(msd)):
            return {"msd_gap": float("inf")}
        gap = max(gap, float(np.max(np.abs(msd[1:] - ref["msd"][1:]) / ref["msd"][1:])))
    return {"msd_gap": gap}
