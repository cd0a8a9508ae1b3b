"""ADF host helpers and the plain torch versions of the two ADF kernels.

Counterpart of ``lammps_analysis_tpu/ops/adf.py`` and of the two Pallas
stages in ``lammps_analysis_tpu/ops/pallas_adf.py``:

* ``neighbor_extract_reference`` is the plain version of the CUDA neighbor
  extract (K2, both routes: the sweep ``csrc/adf_neighbor_extract.cu`` and
  the cell lists ``csrc/adf_neighbor_cells.cu``): for every center, every
  other atom inside the cutoff, in ascending atom order, in K slots, under
  the minimum image or with open boundaries, optionally with the neighbors'
  atom indices;
* ``sorted_neighbor_extract_reference`` is the plain version of the sweep's
  window mode: each frame sorted in space (``ops/sorting.py``), then the
  lists of the sorted frame;
* ``adf_pairs_histogram_reference`` is the plain version of the CUDA angle
  histogram (``csrc/adf_pairs_histogram.cu``, K3): for every center and
  every unordered pair of its listed neighbors, the angle binned per
  species triple, one histogram per frame;
* ``adf_histogram_reference`` chains the two over one frame batch with a K
  that never saturates: the whole plain ADF.

Counting convention (the reference's, ``ops/adf.py:10-14`` of the JAX
package): ordered neighbor pairs ``(j, k)``, ``j != k``, kept only when the
species triple ``(s_i, s_j, s_k)`` is non-decreasing. Here each unordered
pair is enumerated once, keyed by ``(s_i, min, max)`` and weighted twice when
``s_j == s_k`` (the TPU kernel's ``fold=True``): the same histogram.

The kernels and these versions run the same float32 operations in the same
order (``-fmad=false`` on the CUDA side), so K2 agrees exactly and K3 up to
the order of its float32 atomic sums and the last ulp of ``acos``. The plain
extract and angle histogram count their calls in ``utils/profiling.py``'s
counters ``k2.plain`` and ``k3.plain``.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..utils import profiling
from . import sorting
from .geometry import box_scalars, minimum_image, rounded_sqrt

ADF_BIN_RANGE = (0.0, 3.15)  # radians, the reference's "0 to a chemists pi"

#: elements of the largest (F, centers, ...) intermediate of a plain version
_BLOCK_ELEMENTS = 2**24


def build_triple_table(n_species: int):
    """Triple-key table ``T[a, b, c] -> key index`` (-1 = dropped).

    Key order matches ``itertools.combinations_with_replacement`` over the
    species list (reference ``angular_distribution_function.py:414``).
    """
    table = np.full((n_species,) * 3, -1, dtype=np.int32)
    order = []
    for idx, (a, b, c) in enumerate(
        itertools.combinations_with_replacement(range(n_species), 3)
    ):
        table[a, b, c] = idx
        order.append((a, b, c))
    return table, order


def n_triples_for(n_species: int) -> int:
    return n_species * (n_species + 1) * (n_species + 2) // 6


def triple_index(a, b, c, n_species: int):
    """Closed-form index of the non-decreasing triple ``a <= b <= c``.

    ``C(S+2, 3) - C(S-a+2, 3)`` triples start with a species below ``a``;
    within ``a``, the pair ``(b, c)`` counts as usual. Works on ints and on
    integer tensors; equals ``build_triple_table(S)[0][a, b, c]``.
    """
    s = n_species
    sa = s - a
    block_a = (s * (s + 1) * (s + 2) - sa * (sa + 1) * (sa + 2)) // 6
    bb = b - a
    return block_a + bb * sa - bb * (bb - 1) // 2 + (c - b)


def bin_scale(n_bins: int) -> float:
    """``n_bins / 3.15`` as a float32 value: angle times this is the bin."""
    lo, hi = ADF_BIN_RANGE
    return float(np.float32(n_bins) / np.float32(hi - lo))


def _valid_species(sid: torch.Tensor, n_species: int) -> torch.Tensor:
    """Ids as int64 with everything outside ``[0, n_species)`` set to -1."""
    sid = sid.to(torch.int64)
    return torch.where((sid >= 0) & (sid < n_species), sid, -1)


def int_power(x: torch.Tensor, p: int) -> torch.Tensor:
    """``x ** p`` by squaring, in the kernel's order of multiplications."""
    result = None
    base = x
    while p:
        if p & 1:
            result = base if result is None else result * base
        p >>= 1
        if p:
            base = base * base
    return torch.ones_like(x) if result is None else result


def neighbor_extract_reference(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    k_n: int,
    n_species: int,
    centers=None,
    with_idx: bool = False,
):
    """Plain per-center neighbor lists, the plain version of K2.

    ``positions`` ``(F, N, 3)`` float32, ``species_id`` ``(N,)`` int, or
    ``(F, N)`` for frames whose atoms were reordered per frame; an id outside
    ``[0, n_species)`` is padding. For every center i with a valid species,
    every j != i with a valid species and distance ``d < cutoff`` goes to the
    next of the center's ``k_n`` slots, in ascending j. The distance is the
    minimum image's in ``box`` (3 edge lengths), or plain with ``box=None``
    (open boundaries). Returns ``(rx, ry, rz, d, sid, counts)``: the first
    four ``(F, N, k_n)`` float32 with ``r = pos_j - pos_i``, ``sid`` ``(F, N,
    k_n)`` int32, empty slots 0 and sid -1; ``counts`` ``(F, N)`` int32 the
    true number in the cutoff, which may exceed ``k_n``. ``with_idx`` appends
    ``idx`` ``(F, N, k_n)`` int32, the neighbors' atom indices, -1 in empty
    slots.

    ``centers=(c0, c1)`` (the center stripe of one rank of
    ``sharded_adf_histogram_2d``) lists only the centers ``c0 <= i < c1``,
    still against every atom, in ``(F, c1 - c0, ...)`` outputs: row ``i -
    c0`` is row ``i`` of the full extract.
    """
    profiling.count("k2.plain")
    if box is None:
        wrap = None
    else:
        (bx, by, bz), (ibx, iby, ibz) = box_scalars(box, "the neighbor extract")
        wrap = ((bx, ibx), (by, iby), (bz, ibz))
    cut = float(np.float32(cutoff))
    f, n, _ = positions.shape
    c0, c1 = (0, n) if centers is None else centers
    device = positions.device
    out = [torch.zeros((f, c1 - c0, k_n), dtype=torch.float32, device=device) for _ in range(4)]
    sid_out = torch.full((f, c1 - c0, k_n), -1, dtype=torch.int32, device=device)
    idx_out = torch.full((f, c1 - c0, k_n), -1, dtype=torch.int32, device=device) if with_idx else None
    counts = torch.zeros((f, c1 - c0), dtype=torch.int32, device=device)
    sid = _valid_species(species_id, n_species)
    sid = sid.expand(f, n) if sid.dim() == 1 else sid  # (F, N)
    valid = sid >= 0
    coords = positions.unbind(-1)  # (F, N) each
    atom = torch.arange(n, device=device)
    block = max(1, min(n, _BLOCK_ELEMENTS // max(f * n, 1)))
    for i0 in range(c0, c1, block):
        i1 = min(i0 + block, c1)
        comps = []
        for axis, x in enumerate(coords):
            dx = x[:, None, :] - x[:, i0:i1, None]  # (F, B, N)
            comps.append(dx if wrap is None else minimum_image(dx, *wrap[axis]))
        dx, dy, dz = comps
        d = rounded_sqrt(dx * dx + dy * dy + dz * dz)
        mask = (
            (d < cut)
            & valid[:, None, :]
            & valid[:, i0:i1, None]
            & (atom[None, None, :] != atom[i0:i1, None])
        )
        slot = torch.cumsum(mask, dim=2, dtype=torch.int32) - 1
        counts[:, i0 - c0 : i1 - c0] = slot[..., -1] + 1
        fi, ci, ji = (mask & (slot < k_n)).nonzero(as_tuple=True)
        si = slot[fi, ci, ji].to(torch.int64)
        rows = (fi, ci + i0 - c0, si)
        for dst, src in zip(out, (dx, dy, dz, d)):
            dst[rows] = src[fi, ci, ji]
        sid_out[rows] = sid[fi, ji].to(torch.int32)
        if with_idx:
            idx_out[rows] = ji.to(torch.int32)
    rx, ry, rz, d_out = out
    if with_idx:
        return rx, ry, rz, d_out, sid_out, counts, idx_out
    return rx, ry, rz, d_out, sid_out, counts


def sorted_neighbor_extract_reference(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    k_n: int,
    n_species: int,
    sort: str = "z",
):
    """Plain version of the sorted route: each frame sorted in space by
    ``sort`` (``"z"`` or ``"brick"``, ``ops/sorting.py``), then
    :func:`neighbor_extract_reference` on the sorted frames with their
    per-frame ids. Returns ``(rx, ry, rz, d, sid, counts, sid_sorted)``:
    the lists in sorted center order, slots in ascending sorted j, and the
    sorted ids ``(F, N)`` int32. The sets per center are the unsorted
    extract's, with the centers permuted by the sort's ``order``."""
    if sort == "z":
        pos_s, sid_s, _ = sorting.spatial_sort(positions, species_id, n_species)
    elif sort == "brick":
        pos_s, sid_s, _ = sorting.brick_sort(positions, species_id, n_species, box, cutoff)
    else:
        raise ValueError(f"sort must be 'z' or 'brick', got {sort!r}")
    lists = neighbor_extract_reference(pos_s, sid_s, box, cutoff, k_n, n_species)
    return (*lists, sid_s.to(torch.int32))


def adf_pairs_histogram_reference(
    rx: torch.Tensor,
    ry: torch.Tensor,
    rz: torch.Tensor,
    d: torch.Tensor,
    sid_n: torch.Tensor,
    counts: torch.Tensor,
    sid_c: torch.Tensor,
    n_bins: int,
    n_species: int,
    norm_power: int = 4,
) -> torch.Tensor:
    """Plain per-frame angle histograms from neighbor lists, the plain K3.

    Lists as :func:`neighbor_extract_reference` returns them; slot ``s`` of a
    center counts only when ``s < min(counts, K)`` and its species is valid.
    For every center with species ``a`` and every unordered pair of its
    listed neighbors with species ``b <= c`` and ``a <= b``:
    ``theta = acos(clamp(g / (d_j d_k), -1, 1))`` (denominator 1 where it is
    0), bin ``min(floor(theta * n_bins / 3.15), n_bins - 1)``, weight
    ``(1 / (d_j d_k)) ** norm_power``, doubled when ``b == c``. Returns
    ``(F, n_triples, n_bins)`` float32; sums run in float64.
    """
    profiling.count("k3.plain")
    f, n, k = rx.shape
    device = rx.device
    n_triples = n_triples_for(n_species)
    out = torch.zeros(f * n_triples * n_bins, dtype=torch.float64, device=device)
    if k < 2 or f == 0 or n == 0:
        return out.to(torch.float32).view(f, n_triples, n_bins)
    inv_bw = bin_scale(n_bins)
    sc = _valid_species(sid_c, n_species)
    listed = torch.arange(k, device=device) < counts.clamp(max=k)[..., None]
    sn = torch.where(listed, _valid_species(sid_n, n_species), -1)  # (F, N, K)
    jj, kk = torch.triu_indices(k, k, offset=1, device=device)
    block = max(1, min(n, _BLOCK_ELEMENTS // max(f * jj.numel(), 1)))
    for c0 in range(0, n, block):
        c1 = min(c0 + block, n)
        s_j, s_k = sn[:, c0:c1, jj], sn[:, c0:c1, kk]  # (F, C, P)
        a = sc[c0:c1][None, :, None]
        b, c = torch.minimum(s_j, s_k), torch.maximum(s_j, s_k)
        fi, ci, pi = ((a >= 0) & (b >= 0) & (a <= b)).nonzero(as_tuple=True)
        t = triple_index(a[0, ci, 0], b[fi, ci, pi], c[fi, ci, pi], n_species)
        same = s_j[fi, ci, pi] == s_k[fi, ci, pi]
        row_j = (fi, ci + c0, jj[pi])
        row_k = (fi, ci + c0, kk[pi])
        g = rx[row_j] * rx[row_k] + ry[row_j] * ry[row_k] + rz[row_j] * rz[row_k]
        denom = d[row_j] * d[row_k]
        denom = torch.where(denom > 0, denom, 1.0)
        theta = torch.acos(torch.clamp(g / denom, -1.0, 1.0))
        bins = torch.clamp(torch.floor(theta * inv_bw), max=n_bins - 1).to(torch.int64)
        w = int_power(torch.reciprocal(denom), norm_power)
        w = torch.where(same, w + w, w)
        out.index_add_(0, (fi * n_triples + t) * n_bins + bins, w.to(torch.float64))
    return out.to(torch.float32).view(f, n_triples, n_bins)


def adf_histogram_reference(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    n_bins: int,
    n_species: int,
    norm_power: int = 4,
) -> torch.Tensor:
    """The whole plain ADF of one frame batch, ``(n_triples, n_bins)`` float32.

    Same semantics as the JAX package's ``ops/adf.py::adf_histogram``: a
    first extract finds the largest neighbor count and the second sizes K
    to it, so nothing saturates. Not density-normalised.
    """
    *_, counts = neighbor_extract_reference(
        positions, species_id, box, cutoff, 1, n_species
    )
    k = max(int(counts.max()) if counts.numel() else 0, 1)
    *lists, counts = neighbor_extract_reference(
        positions, species_id, box, cutoff, k, n_species
    )
    per_frame = adf_pairs_histogram_reference(
        *lists, counts, species_id, n_bins, n_species, norm_power
    )
    return per_frame.sum(0)
