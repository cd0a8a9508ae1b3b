"""Spatial distribution function calculator.

Counterpart of ``lammps_analysis_tpu/calculators/spatial_distribution_function.py``
(port of MDSuite's ``spatial_distribution_function.py:72-330``, experimental
upstream) with the same arguments, cache key and result layout:
minimum-image displacement vectors from a reference species to a partner
species whose length lies in ``[r_min, r_max]`` are projected onto the unit
sphere and counted in a (theta, phi) 2-D histogram; the result is the
histogram and the unit-sphere bin coordinates.

The batch is the JAX package's ``sdf_batch`` as torch ops on
``config.device``: a (frames, a-block, Nb) displacement tile, the minimum
image dividing by the box, the spherical angles, the shell and self-pair
mask, integer counts (``ops/histogram.py``) summed in int64 and returned as
float64. The tiles are sized from the port's own peak memory a pair (eager
torch keeps every intermediate of the tile, where the JAX package sizes one
fused XLA program). ``plot=True`` writes the SDF on the unit sphere as a
self-contained 3-D HTML, and as a matplotlib scatter where matplotlib imports.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict

import numpy as np
import torch

from ..database.properties import mdsuite_properties as mp
from ..database.trajectory_store import join_path
from ..ops.geometry import (
    cartesian_to_spherical,
    minimum_image_divided,
    spherical_to_cartesian,
)
from ..ops.histogram import bin_indices, histogram2d_masked
from ..utils.config import get_device
from ..visualizer.html3d import write_html_3d
from ..visualizer.plots import have_matplotlib
from .base import TrajectoryCalculator

log = logging.getLogger(__name__)


def sdf_tile(pa, pb, box, r_min, r_max, n_bins, a0=None):
    """``(n_bins, n_bins)`` int64 counts of one tile.

    ``pa`` is ``(F, A, 3)`` (the a-block), ``pb`` ``(F, Nb, 3)``; ``a0`` is the
    a-block's first atom index for a same-species run (its self pairs are
    excluded by global atom id), else None.
    """
    r = minimum_image_divided(pb[:, None, :, :] - pa[:, :, None, :], box)
    rtp = cartesian_to_spherical(r)  # (F, A, Nb, 3)
    del r
    d = rtp[..., 0]
    mask = (d >= r_min) & (d <= r_max)
    if a0 is not None:
        a_ids = a0 + torch.arange(pa.shape[1], device=pa.device)
        b_ids = torch.arange(pb.shape[1], device=pb.device)
        mask &= a_ids[:, None] != b_ids[None, :]
    theta_idx = bin_indices(rtp[..., 1], 0.0, math.pi, n_bins)
    phi_idx = bin_indices(rtp[..., 2], -math.pi, math.pi, n_bins)
    del rtp, d
    return histogram2d_masked(theta_idx, phi_idx, mask, n_bins, n_bins)


class SpatialDistributionFunction(TrajectoryCalculator):
    """Angular density of neighbors in a radial shell."""

    loaded_property = mp.positions
    scale_function = {"quadratic": {"outer_scale_factor": 1}}
    result_series_keys = ["sdf", "sphere"]
    #: peak device bytes one pair of a tile holds in ``sdf_tile``: 37.0
    #: measured with ``torch.cuda.max_memory_allocated`` on an NVIDIA H100
    #: 80GB HBM3 (``chip_smoke.py``, ``[3 sdf]``, 1.3e8 pairs a tile)
    PEAK_BYTES_PER_PAIR = 40

    def prepare_args(
        self,
        molecules: bool = False,
        start: int = 1,
        stop: int = 10,
        number_of_configurations: int = 5,
        r_min: float = 4.0,
        r_max: float = 4.5,
        species: list = None,
        n_bins: int = 100,
        **kwargs,
    ) -> Dict[str, Any]:
        exp = self.experiment
        if species is None:
            species = list(exp.molecules) if molecules else list(exp.species)
        stop = min(stop, exp.number_of_configurations - 1)
        return {
            "molecules": bool(molecules),
            "start": int(start),
            "stop": int(stop),
            "number_of_configurations": int(number_of_configurations),
            "r_min": float(r_min),
            "r_max": float(r_max),
            "species": list(species)[:2],
            "n_bins": int(n_bins),
        }

    def tiles(self, n_a: int, n_b: int, n_frames: int) -> tuple[int, int]:
        """``(a_block, frames a batch)``: the a-axis is tiled so one frame's tile
        fits a fifth of the planner's budget at ``PEAK_BYTES_PER_PAIR``;
        frames batch up only when the whole (Na, Nb) block fits."""
        budget = max(int(0.2 * self.experiment.planner.budget_bytes), 1)
        a_block = int(np.clip(budget // max(n_b * self.PEAK_BYTES_PER_PAIR, 1), 1, n_a))
        fpb = 1
        if a_block >= n_a:
            fpb = int(np.clip(budget // max(n_a * n_b * self.PEAK_BYTES_PER_PAIR, 1), 1, n_frames))
        return a_block, fpb

    def run_calculator(self) -> Dict[str, dict]:
        a = self.args
        exp = self.experiment
        species = a["species"]
        sp_a = species[0]
        sp_b = species[1] if len(species) > 1 else species[0]
        n_bins = a["n_bins"]
        # derive Positions when only unwrapped/scaled positions are stored
        self._run_dependency_check(species)

        idx = np.unique(
            np.linspace(a["start"], a["stop"], a["number_of_configurations"], dtype=int)
        )
        n_a = exp.entity(sp_a).n_particles
        n_b = exp.entity(sp_b).n_particles
        device = get_device()
        box = torch.as_tensor(np.asarray(exp.box_array, dtype=np.float32), device=device)
        a_block, fpb = self.tiles(n_a, n_b, len(idx))
        same = sp_a == sp_b

        hist = torch.zeros((n_bins, n_bins), dtype=torch.int64, device=device)
        path_a = join_path(sp_a, mp.positions.name)
        path_b = join_path(sp_b, mp.positions.name)
        for f0 in range(0, len(idx), fpb):
            fsel = idx[f0 : f0 + fpb]
            pos_a = torch.from_numpy(
                exp.store.load([path_a], frames=fsel, dtype=np.float32)[path_a]
            ).to(device)
            # a same-species run reuses the tensor (one read, one copy)
            pos_b = pos_a if same else torch.from_numpy(
                exp.store.load([path_b], frames=fsel, dtype=np.float32)[path_b]
            ).to(device)
            for a0 in range(0, n_a, a_block):
                hist += sdf_tile(
                    pos_a[:, a0 : a0 + a_block], pos_b, box, a["r_min"], a["r_max"],
                    n_bins, a0 if same else None,
                )
        return {
            "System": {
                "sdf": hist.cpu().numpy().astype(np.float64).tolist(),
                "sphere": self._unit_sphere(n_bins).tolist(),
            }
        }

    @staticmethod
    def _unit_sphere(n_bins: int) -> np.ndarray:
        """Bin-centre coordinates on the unit sphere (reference ``:256-275``)."""
        theta = np.linspace(0, math.pi, n_bins)
        phi = np.linspace(-math.pi, math.pi, n_bins)
        tt, pp = np.meshgrid(theta, phi)
        rtp = np.stack([np.ones_like(tt), tt, pp], axis=-1)
        return spherical_to_cartesian(torch.from_numpy(rtp)).numpy()

    def plot_results(self, computation):
        """The unit-sphere cloud colored by SDF intensity: a drag and zoom
        HTML (``figures/SpatialDistributionFunction3D.html``, the open3d
        viewer's counterpart, ``d3_data_visualizer.py:39-208``), then a 3-D
        scatter PNG where matplotlib imports (JAX ``spatial_distribution_function.py:199-230``,
        which writes the PNG first)."""
        data = computation["System"]
        sphere = np.asarray(data["sphere"], dtype=float).reshape(-1, 3)
        colors = np.asarray(data["sdf"], dtype=float).T.reshape(-1)
        figures = self.experiment.path / "figures"
        write_html_3d(
            [[("SDF", sphere)]],
            figures / "SpatialDistributionFunction3D.html",
            title="Spatial distribution function",
            values=[colors],
            radius=3.0,
        )
        if not have_matplotlib():
            log.info("matplotlib does not import: SpatialDistributionFunction.png not written")
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")
        sc = ax.scatter(sphere[:, 0], sphere[:, 1], sphere[:, 2], c=colors, s=4, cmap="viridis")
        fig.colorbar(sc, shrink=0.7)
        ax.set_title("Spatial distribution function")
        out = figures / "SpatialDistributionFunction.png"
        out.parent.mkdir(exist_ok=True)
        fig.savefig(out, dpi=110)
        plt.close(fig)
