"""Host-side helpers the readers and the RDF post-processing need.

Copied from ``lammps_analysis_tpu/utils/meta.py``: ``optimize_batch_size``,
``golden_section_search`` and ``smooth_series``. That module's machine and
accelerator introspection asks jax for its devices; the port sizes device
work from ``memory/planner.py`` instead.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
from scipy.signal import savgol_filter

from .units import golden_ratio


def optimize_batch_size(
    filepath, number_of_configurations: int, expansion_factor: float = 5.0
) -> int:
    """How many configurations to parse per ingestion batch.

    Same heuristic as the reference (``meta_functions.py:185-238``): allow 10%
    of host RAM, assume ~``expansion_factor``x in-memory blow-up of the text.
    """
    import psutil

    file_size = os.path.getsize(filepath)
    memory_per_cfg = expansion_factor * file_size / max(number_of_configurations, 1)
    budget = 0.1 * psutil.virtual_memory().total
    batch = int(budget / max(memory_per_cfg, 1))
    return max(1, min(batch, number_of_configurations))


def golden_section_search(
    data: Sequence[np.ndarray], a: float, b: float, tol: float = 1e-5
) -> tuple:
    """Golden-section search for the minimum of sampled data on [a, b].

    Textbook iterative golden-section bracketing, evaluated at the nearest
    sampled grid points (reference analog ``meta_functions.py:376-437``,
    which implements the same recursion). ``data`` is ``(x, y)``; bound
    order is normalised; returns ``(lo, hi)`` bracketing the minimum.
    """
    x, y = np.asarray(data[0]), np.asarray(data[1])

    def snap(val):
        return int(np.argmin(np.abs(x - val)))

    inv_phi = 1.0 / golden_ratio  # 0.618...
    inv_phi2 = 1.0 / golden_ratio**2  # 0.381...
    a, b = (min(a, b), max(a, b))
    h = b - a
    if h <= tol:
        return a, b
    c = a + inv_phi2 * h
    d = a + inv_phi * h
    ic, idx = snap(c), snap(d)
    yc, yd = y[ic], y[idx]
    n = int(np.ceil(np.log(tol / h) / np.log(inv_phi)))
    for _ in range(n):
        if ic == idx:
            # both probes snap to the same sample — the grid can't resolve
            # the interval any further; [a, b] brackets the minimum.
            return a, b
        if yc < yd:
            # minimum in [a, d]: d becomes the upper bound, c the new d
            b, d, idx, yd = d, c, ic, yc
            h *= inv_phi
            c = a + inv_phi2 * h
            ic = snap(c)
            yc = y[ic]
        else:
            # minimum in [c, b]: c becomes the lower bound, d the new c
            a, c, ic, yc = c, d, idx, yd
            h *= inv_phi
            d = a + inv_phi * h
            idx = snap(d)
            yd = y[idx]
        if h <= tol:
            break
    return (a, d) if yc < yd else (c, b)


def smooth_series(y: np.ndarray, window: int = 17, order: int = 2) -> np.ndarray:
    """Savitzky-Golay smoothing with safe window clipping."""
    y = np.asarray(y, dtype=float)
    window = min(window, len(y) - (1 - len(y) % 2))
    if window < order + 2:
        return y
    if window % 2 == 0:
        window -= 1
    return savgol_filter(y, window, order)
