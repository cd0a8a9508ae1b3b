"""The seeded random walk a configuration draws its positions from.

Uniform starts in a cubic box, normal steps of ``sigma`` per axis per frame
summed over the frames, wrapped into ``[0, box)``: the JAX package's
molten-NaCl example generator, made on the device by one
``torch.Generator`` in three large calls. The same seed gives the same
positions on the same kind of device; every seed gives the same sizes.
"""

from __future__ import annotations

import torch


def wrapped_walk(n_frames: int, n_atoms: int, box: float, sigma: float, seed: int,
                 device: str) -> torch.Tensor:
    """``(n_frames, n_atoms, 3)`` float32 positions in ``[0, box)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    start = torch.rand((1, n_atoms, 3), generator=gen, device=device, dtype=torch.float64) * box
    steps = torch.randn((n_frames, n_atoms, 3), generator=gen, device=device,
                        dtype=torch.float64) * sigma
    steps[0] = 0.0
    pos = torch.cumsum(steps, dim=0) + start
    wrapped = (pos - box * torch.floor(pos / box)).to(torch.float32)
    # a coordinate just below 0 wraps to box - tiny, which rounds to box in float32
    return torch.where(wrapped >= box, wrapped - box, wrapped)
