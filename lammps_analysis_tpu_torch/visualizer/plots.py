"""2-D result plotting (matplotlib backend).

A copy of ``lammps_analysis_tpu/visualizer/plots.py`` (the counterpart of the
reference's bokeh grid plots, ``mdsuite/visualizer/d2_data_visualization.py:36-140``):
one PNG per analysis under the experiment's ``figures/``, one panel per
subject. matplotlib is optional: ``have_matplotlib`` says whether it imports,
and the calculators write their HTML plot first and this PNG only then
(``calculators/base.py::Calculator.plot_results``).
"""

from __future__ import annotations

import importlib.util
import logging
import pathlib
from typing import List

import numpy as np

log = logging.getLogger(__name__)


def have_matplotlib() -> bool:
    """True where matplotlib imports (the PNG plots need it; the HTML ones
    do not)."""
    return importlib.util.find_spec("matplotlib") is not None


def plot_series_results(
    computation,
    series_keys: List[str],
    out_dir,
    title: str = "analysis",
) -> pathlib.Path:
    """Plot each subject's (x, y) series into one grid figure -> PNG path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if len(series_keys) < 2:
        raise ValueError("need at least x and y series keys to plot")
    x_key, y_key = series_keys[0], series_keys[1]

    subjects = [
        s for s in computation.keys() if x_key in computation[s] and y_key in computation[s]
    ]
    if not subjects:
        raise ValueError(f"No subjects with series ({x_key}, {y_key}) to plot")

    n = len(subjects)
    ncols = min(n, 3)
    nrows = -(-n // ncols)
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(5 * ncols, 3.5 * nrows), squeeze=False
    )
    for i, subject in enumerate(subjects):
        ax = axes[i // ncols][i % ncols]
        data = computation[subject]
        x = np.asarray(data[x_key], dtype=float)
        y = np.asarray(data[y_key], dtype=float)
        m = min(len(x), len(y))
        ax.plot(x[:m], y[:m], lw=1.2)
        ax.set_title(subject, fontsize=10)
        ax.set_xlabel(x_key)
        ax.set_ylabel(y_key)
        ax.grid(alpha=0.3)
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.suptitle(title)
    fig.tight_layout()

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{title}.png"
    fig.savefig(path, dpi=110)
    plt.close(fig)
    log.info("wrote %s", path)
    return path
