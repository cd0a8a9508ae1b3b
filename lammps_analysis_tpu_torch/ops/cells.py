"""Cell binning for the binned neighbor extract (``csrc/adf_neighbor_cells.cu``).

The port's own counterpart of what it needs from
``lammps_analysis_tpu/ops/cells.py`` (``cells_per_dim``,
``cell_lists_applicable``, ``build_cell_table``, ``neighbor_cell_offsets``):
atoms bin into cells at least one cutoff wide, and a center's neighbors lie in
its 27 adjacent cells. Here the box may differ per axis, the cell width
carries a margin, and padding atoms go to no real cell.

Cells per axis are ``floor(L_a / (cutoff * (1 + CELL_MARGIN)))``. The kernels
decide a pair on float32 displacements of the stored, possibly unwrapped,
coordinates, whose rounding (about 2^-23 of the raw displacement) can let a
pair slightly beyond the cutoff in; the 1 % margin keeps every such pair
inside the 27-cell neighborhood while raw displacements stay below about 4e4
cutoffs (1.4e5 A at a cutoff of 3.6 A). Cells come from positions
wrapped into the box in float64, used only for the binning:
``f = x / L_a; f = f - floor(f); c = min(floor(f * n_a), n_a - 1)``, the
arithmetic the binning kernel repeats. Cell ids run with z fastest, ``(cx *
ny + cy) * nz + cz``, as the JAX package's do.

The binning functions here are the plain torch versions of the binning
kernel: the CPU tests use them to show that the 27 cells cover every pair.
"""

from __future__ import annotations

import numpy as np
import torch

#: cell width over cutoff, less one
CELL_MARGIN = 0.01


def cells_per_axis(box, cutoff: float) -> tuple[int, int, int]:
    """Cells along each box edge, each at least ``cutoff * (1 + CELL_MARGIN)`` wide."""
    edges = np.asarray(box, dtype=np.float64).reshape(3)
    width = float(np.float32(cutoff)) * (1.0 + CELL_MARGIN)
    return tuple(max(int(np.floor(e / width)), 1) for e in edges)


def cell_lists_applicable(box, cutoff: float) -> bool:
    """Three or more cells on every axis: the 27 neighbor cells are distinct."""
    return min(cells_per_axis(box, cutoff)) >= 3


def cell_of_atoms(
    positions: torch.Tensor, species_id: torch.Tensor, box, n_cells, n_species: int
) -> torch.Tensor:
    """``(F, N)`` int64 cell id of every atom; ``nx * ny * nz`` for padding.

    ``positions`` ``(F, N, 3)`` in any image; ``species_id`` outside ``[0,
    n_species)`` marks padding, which goes to the one cell past the real ones.
    """
    n = torch.as_tensor(n_cells, dtype=torch.int64, device=positions.device)
    edges = torch.as_tensor(
        np.asarray(box, np.float32).astype(np.float64), device=positions.device
    )
    frac = positions.double() / edges
    frac = frac - torch.floor(frac)
    coord = torch.minimum(torch.floor(frac * n.double()).long(), n - 1)
    cell = (coord[..., 0] * n[1] + coord[..., 1]) * n[2] + coord[..., 2]
    sid = species_id.long()
    valid = (sid >= 0) & (sid < n_species)
    return torch.where(valid[None, :], cell, int(torch.prod(n)))


def cell_occupancy(cell: torch.Tensor, n_total_cells: int) -> torch.Tensor:
    """``(F, n_total_cells + 1)`` atoms per cell, the padding cell last."""
    f = cell.shape[0]
    offset = torch.arange(f, device=cell.device)[:, None] * (n_total_cells + 1)
    counts = torch.bincount((cell + offset).reshape(-1), minlength=f * (n_total_cells + 1))
    return counts.view(f, n_total_cells + 1)


def neighbor_cells(n_cells) -> np.ndarray:
    """``(nx * ny * nz, 27)`` ids of each cell's 3 x 3 x 3 periodic neighborhood."""
    nx, ny, nz = n_cells
    ids = np.arange(nx * ny * nz)
    cx, cy, cz = ids // (ny * nz), (ids // nz) % ny, ids % nz
    r = np.arange(-1, 2)
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(27, 3)
    return (
        ((cx[:, None] + offs[:, 0]) % nx) * ny + (cy[:, None] + offs[:, 1]) % ny
    ) * nz + (cz[:, None] + offs[:, 2]) % nz
