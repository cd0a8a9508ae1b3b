"""RDF host helpers and the plain torch pair-distance histogram.

``build_species_layout``, ``ideal_gas_correction`` and ``rdf_prefactors`` are
copied from ``lammps_analysis_tpu/ops/rdf.py`` (numpy only). The counting
convention is the JAX package's: each unordered pair is counted once and the
same-species factor 2 is applied in the prefactor.

``rdf_histogram_reference`` is the plain torch version of the CUDA kernel in
``csrc/rdf_histogram.cu`` (wrapper: ``ops/rdf_kernel.py``), with the same
float32 arithmetic in the same order, so the two agree bin for bin. It is what
the wrapper runs for CPU tensors and what the kernel is held against on the
card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling
from .geometry import box_scalars, minimum_image, rounded_sqrt


def build_species_layout(n_per_species: list[int], pad_to: int = 8):
    """Concatenated species layout: ids, padding, unordered-pair index table.

    Returns ``(species_id (Npad,), n_pad, pair_table (S, S), n_pairs,
    pair_names_order)`` where ``pair_table[a, b]`` is the index of the
    unordered pair ``(min(a,b), max(a,b))`` in ``itertools``'
    combinations-with-replacement order — the same ordering the reference
    uses for its result keys (``radial_distribution_function.py:269-274``).
    """
    n_species = len(n_per_species)
    total = int(np.sum(n_per_species))
    n_pad = -(-total // pad_to) * pad_to
    sid = np.full((n_pad,), -1, dtype=np.int32)
    off = 0
    for s, n in enumerate(n_per_species):
        sid[off : off + n] = s
        off += n
    pair_table = np.zeros((n_species, n_species), dtype=np.int32)
    idx = 0
    order = []
    for a in range(n_species):
        for b in range(a, n_species):
            pair_table[a, b] = idx
            pair_table[b, a] = idx
            order.append((a, b))
            idx += 1
    return sid, n_pad, pair_table, idx, order


def rdf_scalars(box, cutoff: float, n_bins: int):
    """The float32 scalars both histogram versions use, computed once here.

    Returns ``(box (3,), 1/box (3,), cutoff, n_bins/cutoff)`` as Python floats
    holding float32 values: the reciprocals are float32 divisions, as the TPU
    kernel computes them (``pallas_rdf.py:161-163``).
    """
    b, ib = box_scalars(box, "the RDF pair histogram")
    cut = np.float32(cutoff)
    inv_bin = np.float32(n_bins) / cut
    return b, ib, float(cut), float(inv_bin)


def rdf_histogram_reference(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    n_bins: int,
    n_species: int,
    i_block: int = 128,
    rows=None,
) -> torch.Tensor:
    """Plain torch per-species-pair distance histogram, ``(n_pairs, n_bins)`` int64.

    ``positions`` is ``(F, N, 3)`` float32 with species concatenated,
    ``species_id`` ``(N,)`` with -1 for padding (an id of ``n_species`` or
    more counts as padding too). Each pair j > i with both species in
    ``[0, n_species)`` and minimum-image distance below ``cutoff`` counts once.
    ``rows=(i0, i1)`` counts only the pairs with ``i0 <= i < i1`` (still
    against every j > i), so the histograms of stripes that cover ``[0, N)``
    add up to the full one. Works i-block by i-block on ``(F, i_block, N -
    b0)`` tensors (j starts at the block's first row ``b0``; every earlier j
    fails j > i).
    """
    profiling.count("k1.plain")
    (bx, by, bz), (ibx, iby, ibz), cut, inv_bin = rdf_scalars(box, cutoff, n_bins)
    _, n, _ = positions.shape
    r0, r1 = (0, n) if rows is None else rows
    n_pairs = n_species * (n_species + 1) // 2
    device = positions.device
    hist = torch.zeros(n_pairs * n_bins, dtype=torch.int64, device=device)
    sid = species_id.to(torch.int64)
    sid = torch.where(sid < n_species, sid, -1)
    x, y, z = positions.unbind(-1)  # (F, N) each
    for i0 in range(r0, r1, i_block):
        i1 = min(i0 + i_block, r1)
        dx = x[:, i0:i1, None] - x[:, None, i0:]  # (F, B, N - i0)
        dy = y[:, i0:i1, None] - y[:, None, i0:]
        dz = z[:, i0:i1, None] - z[:, None, i0:]
        dx = minimum_image(dx, bx, ibx)
        dy = minimum_image(dy, by, iby)
        dz = minimum_image(dz, bz, ibz)
        d = rounded_sqrt(dx * dx + dy * dy + dz * dz)

        si = sid[i0:i1, None]  # (B, 1)
        sj = sid[None, i0:]  # (1, N - i0)
        i_ids = torch.arange(i0, i1, device=device)[:, None]
        j_ids = torch.arange(i0, n, device=device)[None, :]
        mask = (j_ids > i_ids) & (si >= 0) & (sj >= 0) & (d < cut)

        a = torch.minimum(si, sj)
        b = torch.maximum(si, sj)
        pair_id = a * n_species - a * (a - 1) // 2 + (b - a)  # (B, N - i0)
        bins = torch.clamp(torch.floor(d * inv_bin), max=n_bins - 1).to(torch.int64)
        combined = pair_id * n_bins + bins  # (F, B, N - i0)
        hist += torch.bincount(combined[mask], minlength=n_pairs * n_bins)
    return hist.view(n_pairs, n_bins)


def ideal_gas_correction(bin_edges: np.ndarray, box_l: float) -> np.ndarray:
    """Ideal-gas shell term with beyond-half-box corrections.

    Host-side port of the reference's piecewise correction
    (``radial_distribution_function.py:719-826``): plain ``4 pi r^2`` below
    L/2, analytic sphere-box intersection corrections up to ``sqrt(2) L / 2``.
    """
    r = np.asarray(bin_edges, dtype=float)
    lower = box_l / 2.0
    middle = np.sqrt(2.0) * box_l / 2.0
    x = r / box_l  # corrections are expressed in units of the box length

    spherical = 4.0 * np.pi * r**2

    with np.errstate(invalid="ignore", divide="ignore"):
        corr1 = 2.0 * np.pi * x * (3.0 - 4.0 * x) * box_l**2
        arg = 4.0 * x**2 - 2.0
        arctan_1 = np.arctan(np.sqrt(np.maximum(arg, 0.0)))
        arctan_2 = 8.0 * x * np.arctan(
            (2.0 * x * (4.0 * x**2 - 3.0))
            / (np.sqrt(np.maximum(arg, 1e-300)) * (4.0 * x**2 + 1.0))
        )
        corr2 = 2.0 * x * (3.0 * np.pi - 12.0 * arctan_1 + arctan_2) * box_l**2

    out = np.where(r <= lower, spherical, np.where(r < middle, corr1, corr2))
    return out


def rdf_prefactors(
    n_pairs_order: list[tuple[int, int]],
    n_per_species: list[int],
    volume: float,
    n_configurations: int,
    bin_edges: np.ndarray,
    box_l: float,
) -> np.ndarray:
    """Per-(pair, bin) normalisation turning counts into g(r).

    Mirrors ``_calculate_prefactor`` + ``ideal_correction``
    (``radial_distribution_function.py:299-345, 719-826``): factor 2 for
    same-species pairs (each unordered pair counted once), ideal-gas shell
    volume times partner density times observer count times frames.
    """
    # the histogram bins are [i, i+1) * cutoff / n_bins — the TRUE bin width
    # is cutoff / n_bins, NOT the x-axis spacing cutoff / (n_bins - 1)
    # (the reference's bin_width, radial_distribution_function.py:822)
    cutoff = float(bin_edges[-1]) if len(bin_edges) > 1 else 1.0
    bin_width = cutoff / len(bin_edges)
    ideal = ideal_gas_correction(bin_edges, box_l) * bin_width
    out = np.zeros((len(n_pairs_order), len(bin_edges)))
    with np.errstate(divide="ignore", invalid="ignore"):
        for p, (a, b) in enumerate(n_pairs_order):
            scale = 2.0 if a == b else 1.0
            rho = n_per_species[b] / volume
            denom = n_configurations * rho * ideal * n_per_species[a]
            out[p] = np.where(denom > 0, scale / np.where(denom > 0, denom, 1.0), 0.0)
    return out
