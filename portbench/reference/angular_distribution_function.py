"""Plain reference of ``AngularDistributionFunction`` and the judge of its answers.

MDSuite's ADF, worked out from the positions the configuration generated,
with nothing of the program. Over the sampled frames
``unique(linspace(start, stop, number_of_configurations))``: every center i,
its neighbors j != i with minimum-image distance below the cutoff, and every
unordered pair (j, k) of them; the angle ``acos(r_ij . r_ik / (r_ij r_ik))``
in bin ``floor(theta * n_bins / 3.15)`` of the species triple ``(s_i,
min(s_j, s_k), max(s_j, s_k))``, kept when ``s_i <= min(s_j, s_k)``,
weighted ``(r_ij r_ik) ** -norm_power`` and twice when ``s_j == s_k`` (the
ordered pairs with a non-decreasing triple); where ``r_ij r_ik`` is 0 it
reads 1 in the angle and the weight, as in MDSuite's kernel. Each batch's histogram is
divided by its own total times the bin width (3.15 / n_bins) per triple and
the batches are summed. The batches are single frames: the calculator's
cost model (quadratic, factor 10, on 24 bytes an atom) puts one frame of
10^4 atoms or more over the memory of any card, so its planner takes one frame a
batch. The pair geometry runs on the device in blocks of centers, in
``dtype`` (float64 for the reference); the sums run in float64.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

BIN_RANGE = 3.15  # radians, MDSuite's "0 to a chemist's pi"
#: centers of one block of (centers, atoms, 3) pair vectors
BLOCK_CENTERS = 512


def resolve_args(args: dict, config: dict) -> dict:
    n_frames = config["n_frames"]
    stop = args.get("stop")
    stop = n_frames - 1 if stop is None else stop
    n_conf = min(args.get("number_of_configurations", 5), n_frames)
    frames = np.unique(np.linspace(args.get("start", 1), stop, n_conf, dtype=int))
    return dict(frames=frames, cutoff=float(args.get("cutoff", 6.0)),
                n_bins=int(args.get("number_of_bins", 500)),
                norm_power=int(args.get("norm_power", 4)))


def triples(n_species: int) -> list:
    return list(itertools.combinations_with_replacement(range(n_species), 3))


def frame_histogram(p: torch.Tensor, sid: torch.Tensor, box: float, cutoff: float,
                    n_bins: int, norm_power: int, dtype: torch.dtype, work: dict) -> torch.Tensor:
    """``(n_triples, n_bins)`` float64 weighted angle counts of one frame."""
    device = p.device
    n, n_species = p.shape[0], int(sid.max()) + 1
    table = torch.full((n_species,) * 3, -1, dtype=torch.int64, device=device)
    for k, (a, b, c) in enumerate(triples(n_species)):
        table[a, b, c] = k
    hist = torch.zeros(len(triples(n_species)) * n_bins, dtype=torch.float64, device=device)
    p = p.to(dtype)
    atom = torch.arange(n, device=device)
    for c0 in range(0, n, BLOCK_CENTERS):
        c1 = min(n, c0 + BLOCK_CENTERS)
        d = p[None, :, :] - p[c0:c1, None, :]  # (B, N, 3): r_ij = x_j - x_i
        d -= box * torch.round(d / box)
        r = torch.sqrt((d * d).sum(-1))
        near = (r < cutoff) & (atom[None, :] != atom[c0:c1, None])
        count = near.sum(1)
        k_max = int(count.max())
        center = sid[c0:c1]
        usable = (near & (sid[None, :] >= center[:, None])).sum(1).double()
        work["kept"] += int(count.sum())
        work["max_count"] = max(work["max_count"], k_max)
        work["angles"] += float((usable * (usable - 1) / 2).sum())
        work["listed_pairs"] += float((count.double() * (count.double() - 1) / 2).sum())
        if k_max < 2:
            continue
        # the neighbors first, in ascending j (a stable sort of "not near")
        order = torch.argsort((~near).to(torch.int8), dim=1, stable=True)[:, :k_max]
        listed = torch.arange(k_max, device=device)[None, :] < count[:, None]
        vec = d.gather(1, order[..., None].expand(-1, -1, 3))
        dist = r.gather(1, order)
        spec = sid[order]
        pj, pk = torch.triu_indices(k_max, k_max, offset=1, device=device)
        sj, sk = spec[:, pj], spec[:, pk]
        lo, hi = torch.minimum(sj, sk), torch.maximum(sj, sk)
        keep = listed[:, pj] & listed[:, pk] & (center[:, None] <= lo)
        den = dist[:, pj] * dist[:, pk]
        den = torch.where(keep & (den > 0), den, 1.0)  # two atoms at one place: 1
        cos = (vec[:, pj] * vec[:, pk]).sum(-1) / den
        theta = torch.acos(torch.clamp(cos, -1.0, 1.0))
        bins = torch.clamp(torch.floor(theta * (n_bins / BIN_RANGE)).to(torch.int64), max=n_bins - 1)
        weight = (den ** -norm_power).double()
        weight = torch.where(sj == sk, 2 * weight, weight)
        index = table[center[:, None].expand_as(lo), lo, hi] * n_bins + bins
        hist.index_add_(0, index[keep], weight[keep])
    return hist.view(-1, n_bins)


def compute(positions: torch.Tensor, config: dict, args: dict,
            dtype: torch.dtype = torch.float64) -> tuple[dict, dict]:
    """``(answer, work)``: the answer as the calculator's ``data_dict`` holds
    it (numpy arrays), and the work the kernels needed (``counts/k2``,
    ``counts/k3``)."""
    a = resolve_args(args, config)
    species = list(config["species"])
    counts = [config["species"][s] for s in species]
    device = positions.device
    sid = torch.repeat_interleave(torch.arange(len(species), device=device),
                                  torch.tensor(counts, device=device))
    box = float(config["box_length"])
    work = dict(frames=a["frames"], cutoff=a["cutoff"], n_atoms=sum(counts),
                n_species=len(species), n_bins=a["n_bins"], kept=0, max_count=0,
                angles=0.0, listed_pairs=0.0)
    total = torch.zeros((len(triples(len(species))), a["n_bins"]), dtype=torch.float64,
                        device=device)
    for f in a["frames"]:
        h = frame_histogram(positions[int(f)], sid, box, a["cutoff"], a["n_bins"],
                            a["norm_power"], dtype, work)
        norm = h.sum(1, keepdim=True) * (BIN_RANGE / a["n_bins"])
        total += torch.where(norm > 0, h / torch.where(norm > 0, norm, 1.0), 0.0)
    total = total.cpu().numpy()
    angles = np.linspace(0.0, BIN_RANGE * (180 / 3.14159), a["n_bins"])
    answer = {
        "_".join(species[s] for s in t): {"angle": angles, "adf": total[k]}
        for k, t in enumerate(triples(len(species)))
    }
    return answer, work


def judge(answer: dict, reference: dict, work: dict) -> dict:
    """The numbers compared, each 0 for a perfect answer:

    ``adf_l1``: the summed |adf - adf_ref| over every triple and bin, over the
    summed |adf_ref|; ``cdf_gap``: the largest gap of the running sum of
    ``adf - adf_ref`` over the bins, over the reference's sum, worst triple.
    A missing triple, a length or an angle grid that differs reads ``inf``."""
    bad = {"adf_l1": float("inf"), "cdf_gap": float("inf")}
    if set(answer) != set(reference):
        return bad
    l1 = norm = cdf = 0.0
    for key, ref in reference.items():
        y = np.asarray(answer[key]["adf"], dtype=np.float64)
        x = np.asarray(answer[key]["angle"], dtype=np.float64)
        if y.shape != ref["adf"].shape or x.shape != ref["angle"].shape:
            return bad
        if np.max(np.abs(x - ref["angle"])) > 1e-9 * np.max(np.abs(ref["angle"])):
            return bad
        if not np.all(np.isfinite(y)):
            return bad
        l1 += float(np.abs(y - ref["adf"]).sum())
        norm += float(np.abs(ref["adf"]).sum())
        gap = np.abs(np.cumsum(y - ref["adf"])).max()
        cdf = max(cdf, float(gap) / max(float(ref["adf"].sum()), 1e-300))
    return {"adf_l1": l1 / max(norm, 1e-300), "cdf_gap": cdf}
