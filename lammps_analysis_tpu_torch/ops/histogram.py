"""Masked histogram primitives.

Counterpart of ``bin_indices`` and ``histogram2d_masked`` in
``lammps_analysis_tpu/ops/histogram.py``, with the scatter strategy only (the
JAX package's ``compare`` and ``outer`` strategies exist for the TPU). Counts
are integers: each entry adds its mask (0 or 1) to its bin with
``index_add_``, so the counts are exact and independent of the order the
adds land in, and nothing waits on the host (boolean indexing and
``torch.bincount`` both read a size back from the device). Masked-out
entries add 0 to their own bin rather than 1 to a spare bin: in a shell
histogram they are nearly all the entries, and one spare bin would take
nearly every atomic add on the card.
"""

from __future__ import annotations

import torch


def bin_indices(
    values: torch.Tensor, range_min: float, range_max: float, n_bins: int
) -> torch.Tensor:
    """Uniform-bin index per value (int32), clipped to ``[0, n_bins - 1]``.

    ``(values - range_min) / (range_max - range_min) * n_bins`` in the
    values' dtype, truncated toward zero (``tf.histogram_fixed_width``
    binning): values below the range go to bin 0, above it to the last bin
    (callers mask those out).
    """
    scaled = (values - range_min) / (range_max - range_min) * n_bins
    return scaled.to(torch.int32).clamp_(0, n_bins - 1)


def histogram2d_masked(
    x_idx: torch.Tensor,
    y_idx: torch.Tensor,
    mask: torch.Tensor,
    n_x: int,
    n_y: int,
) -> torch.Tensor:
    """``(n_x, n_y)`` int64 counts of the ``(x_idx, y_idx)`` bins where ``mask``.

    The 2-D bin is one flat index ``x * n_y + y``; the inputs broadcast to
    one shape. Used by the spatial distribution function.
    """
    x_idx, y_idx, mask = torch.broadcast_tensors(x_idx, y_idx, mask)
    flat = x_idx.to(torch.int64) * n_y + y_idx
    hist = torch.zeros(n_x * n_y, dtype=torch.int64, device=flat.device)
    hist.index_add_(0, flat.reshape(-1), mask.reshape(-1).to(torch.int64))
    return hist.view(n_x, n_y)
