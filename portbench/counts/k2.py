"""Frozen work count of K2, the ADF's neighbor extract (binned route
``csrc/adf_neighbor_cells.cu``, or the sweep ``csrc/adf_neighbor_extract.cu``),
for one call.

The function's work, whatever the route: for every cell of a grid of
cutoff-wide cells (``floor(box / cutoff)`` a side, periodic), its atoms
tested against the atoms of its 27 neighbor cells (every atom against every
atom where the grid has fewer than 3 cells a side), about 22 float32
operations a test and the square root of a kept neighbor; the frames read
once, the lists written once at the width the frames need (their largest
neighbor count): x, y, z, d and the species, 20 bytes a slot, and a count
a center.
"""

import torch

from portbench.peaks import bound_ms


def needed_tests(positions: torch.Tensor, box: float, cutoff: float) -> int:
    """Distance tests of the 27-cell neighborhoods, over ``positions`` ``(F, N, 3)``."""
    f, n, _ = positions.shape
    side = int(box // cutoff)
    if side < 3:
        return f * n * n
    cell = torch.clamp(torch.floor(positions.double() / box * side).long(), 0, side - 1)
    flat = (cell[..., 0] * side + cell[..., 1]) * side + cell[..., 2]  # (F, N)
    tests = 0
    for frame in flat:
        occ = torch.bincount(frame, minlength=side**3).view(side, side, side).double()
        hood = torch.zeros_like(occ)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    hood += torch.roll(occ, shifts=(dx, dy, dz), dims=(0, 1, 2))
        tests += int((occ * hood).sum())
    return tests


def bound(work: dict, positions: torch.Tensor, box: float) -> tuple[float, str]:
    """``(least ms a call, set by)`` from the reference's ``work`` and the
    positions of the configuration (``(all frames, N, 3)``)."""
    frames = positions[torch.as_tensor(work["frames"], device=positions.device)]
    f, n = frames.shape[0], work["n_atoms"]
    flops = 22 * needed_tests(frames, box, work["cutoff"]) + work["kept"]
    n_bytes = f * n * 12 + n * 4 + f * n * (work["max_count"] * 20 + 4)
    return bound_ms(flops, n_bytes)
