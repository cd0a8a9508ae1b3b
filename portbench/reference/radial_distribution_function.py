"""Plain reference of ``RadialDistributionFunction`` and the judge of its answers.

MDSuite's g(r), worked out from the positions the configuration generated,
with nothing of the program: every unordered pair of atoms j > i under the
minimum image, counted in bin ``floor(r * n_bins / cutoff)`` of its species
pair when ``r < cutoff``, over the sampled frames
``unique(linspace(start, stop, number_of_configurations))``; then MDSuite's
normalisation: ``g = scale * count / (frames * rho_b * N_a * 4 pi r^2 * dr)``
with ``r`` the bin's edge from ``linspace(0, cutoff, n_bins)``, ``dr =
cutoff / n_bins``, ``scale`` 2 for a same-species pair, and ``x`` in nm.
The pair distances run on the device in blocks of rows, in ``dtype``
(float64 for the reference; the control passes a lower precision); the
counts are exact integers.
"""

from __future__ import annotations

import numpy as np
import torch

#: elements of one (rows, atoms, 3) block of pair vectors
BLOCK_ELEMENTS = 1 << 25


def resolve_args(args: dict, config: dict) -> dict:
    """MDSuite's defaults for the arguments the call left out."""
    n_frames = config["n_frames"]
    box = float(config["box_length"])
    cutoff = args.get("cutoff") or box / 2 - 0.1
    n_bins = args.get("number_of_bins") or int(cutoff / 0.01)
    stop = args.get("stop")
    stop = n_frames - 1 if stop is None else stop
    n_conf = args.get("number_of_configurations", 500)
    n_conf = n_frames - 1 if n_conf == -1 else min(n_conf, n_frames)
    frames = np.unique(np.linspace(args.get("start", 0), stop, n_conf, dtype=int))
    if cutoff > box / 2:
        raise ValueError("the reference covers cutoffs up to half the box")
    return dict(cutoff=float(cutoff), n_bins=int(n_bins), frames=frames)


def pair_order(species: list) -> list:
    return [(a, b) for a in range(len(species)) for b in range(a, len(species))]


def pair_counts(positions: torch.Tensor, counts: list, box: float, cutoff: float,
                n_bins: int, dtype: torch.dtype) -> torch.Tensor:
    """``(n_pairs, n_bins)`` int64 pair counts of ``positions`` ``(F, N, 3)``."""
    device = positions.device
    n_species = len(counts)
    n_pairs = n_species * (n_species + 1) // 2
    sid = torch.repeat_interleave(torch.arange(n_species, device=device),
                                  torch.tensor(counts, device=device))
    # index of the unordered pair (a <= b) in pair_order
    table = torch.zeros((n_species, n_species), dtype=torch.int64, device=device)
    for k, (a, b) in enumerate(pair_order(list(range(n_species)))):
        table[a, b] = table[b, a] = k
    hist = torch.zeros(n_pairs * n_bins + 1, dtype=torch.int64, device=device)
    n = positions.shape[1]
    rows = max(1, BLOCK_ELEMENTS // (3 * n))
    scale = n_bins / cutoff
    atom = torch.arange(n, device=device)
    for frame in positions:
        p = frame.to(dtype)
        for i0 in range(0, n, rows):
            i1 = min(n, i0 + rows)
            d = p[None, i0:, :] - p[i0:i1, None, :]  # (rows, N - i0, 3), j >= i0
            d -= box * torch.round(d / box)
            r = torch.sqrt((d * d).sum(-1))
            keep = (atom[None, i0:] > atom[i0:i1, None]) & (r < cutoff)
            bins = torch.clamp(torch.floor(r * scale).to(torch.int64), max=n_bins - 1)
            index = table[sid[i0:i1, None], sid[None, i0:]] * n_bins + bins
            hist += torch.bincount(torch.where(keep, index, n_pairs * n_bins).flatten(),
                                   minlength=n_pairs * n_bins + 1)
    return hist[:-1].view(n_pairs, n_bins)


def compute(positions: torch.Tensor, config: dict, args: dict,
            dtype: torch.dtype = torch.float64) -> tuple[dict, dict]:
    """``(answer, work)``: the answer as the calculator's ``data_dict`` holds
    it (numpy arrays), and the work the kernel needed (for ``counts/k1``)."""
    a = resolve_args(args, config)
    species = list(config["species"])
    counts = [config["species"][s] for s in species]
    box = float(config["box_length"])
    hist = pair_counts(positions[torch.as_tensor(a["frames"], device=positions.device)],
                       counts, box, a["cutoff"], a["n_bins"], dtype).cpu().numpy()
    edges = np.linspace(0.0, a["cutoff"], a["n_bins"])
    shell = 4.0 * np.pi * edges**2 * (a["cutoff"] / a["n_bins"])
    n_frames = len(a["frames"])
    answer, per_count = {}, {}
    for k, (i, j) in enumerate(pair_order(species)):
        key = f"{species[i]}_{species[j]}"
        denom = n_frames * (counts[j] / box**3) * counts[i] * shell
        scale = 2.0 if i == j else 1.0
        g = np.where(denom > 0, scale * hist[k] / np.where(denom > 0, denom, 1.0), 0.0)
        answer[key] = {"x": edges * config["length_m"] / 1e-9, "y": g}
        # g per pair counted: turns an answer's g back into counts
        per_count[key] = np.where(denom > 0, scale / np.where(denom > 0, denom, 1.0), 0.0)
    work = dict(frames=n_frames, n_atoms=sum(counts), n_bins=a["n_bins"],
                n_species=len(counts), kept=int(hist.sum()), per_count=per_count,
                counts=hist)
    return answer, work


def judge(answer: dict, reference: dict, work: dict) -> dict:
    """The numbers compared, each 0 for a perfect answer:

    ``g_l1``: the summed |g - g_ref| over every pair and bin, over the summed
    |g_ref|; ``cdf_gap``: the answer's g turned back into counts by the
    reference's normalisation, the largest gap of their running sum from the
    reference's, over the reference's total, worst pair. A missing pair, a
    length or an x grid that differs reads ``inf`` in both."""
    bad = {"g_l1": float("inf"), "cdf_gap": float("inf")}
    if set(answer) != set(reference):
        return bad
    l1 = norm = cdf = 0.0
    for key, ref in reference.items():
        y = np.asarray(answer[key]["y"], dtype=np.float64)
        x = np.asarray(answer[key]["x"], dtype=np.float64)
        if y.shape != ref["y"].shape or x.shape != ref["x"].shape:
            return bad
        if np.max(np.abs(x - ref["x"])) > 1e-9 * np.max(np.abs(ref["x"])):
            return bad
        if not np.all(np.isfinite(y)):
            return bad
        l1 += float(np.abs(y - ref["y"]).sum())
        norm += float(np.abs(ref["y"]).sum())
        w = np.where(work["per_count"][key] > 0, work["per_count"][key], 1.0)
        gap = np.cumsum(np.where(work["per_count"][key] > 0, (y - ref["y"]) / w, y))
        total = max(float(np.where(work["per_count"][key] > 0, ref["y"] / w, 0.0).sum()), 1.0)
        cdf = max(cdf, float(np.abs(gap).max()) / total)
    return {"g_l1": l1 / max(norm, 1e-300), "cdf_gap": cdf}
