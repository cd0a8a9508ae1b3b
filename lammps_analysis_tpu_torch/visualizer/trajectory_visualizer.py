"""Particle-trajectory visualization: an interactive HTML, and a PNG where
matplotlib imports.

Counterpart of ``lammps_analysis_tpu/visualizer/trajectory_visualizer.py``
(the reference's znvis/open3d viewers, ``mdsuite/visualizer/
znvis_visualizer.py:41-140``, ``d3_data_visualizer.py:39-208``), reading the
port's npy store. It writes ``figures/trajectory.html`` (a drag, zoom and
play point cloud of up to 60 frames across the trajectory, or the frames
asked for) first, then ``figures/trajectory.png`` (a 3-D scatter of selected
frames, one panel each) where matplotlib imports: the JAX package writes the
PNG first, and a machine without matplotlib would get neither.
"""

from __future__ import annotations

import logging
import pathlib
from typing import List, Optional

import numpy as np

from ..database.trajectory_store import join_path
from .html3d import write_html_3d
from .plots import have_matplotlib

log = logging.getLogger(__name__)

_COLORS = ["tab:blue", "tab:orange", "tab:green", "tab:red", "tab:purple",
           "tab:brown", "tab:pink", "tab:gray"]


class TrajectoryVisualizer:
    """Render selected configurations of an experiment to HTML (and PNG)."""

    def __init__(
        self,
        experiment,
        species: Optional[List[str]] = None,
        molecules: bool = False,
        property_name: str = "Positions",
    ):
        self.experiment = experiment
        if species is None:
            species = (
                list(experiment.molecules)
                if molecules
                else [s for s in experiment.species if s != "Observables"]
            )
        self.species = species
        self.property_name = property_name

    def _stored(self) -> List[str]:
        exp = self.experiment
        return [sp for sp in self.species
                if exp.store.check_existence(join_path(sp, self.property_name))]

    def run(self, frames: Optional[List[int]] = None) -> pathlib.Path:
        """Write the HTML (and the PNG); returns the HTML's path."""
        exp = self.experiment
        n = exp.number_of_configurations
        anim = (
            np.unique(np.linspace(0, n - 1, min(n, 60), dtype=int))
            if frames is None
            else np.asarray(frames, dtype=int)
        )
        per_species = {}
        for sp in self._stored():
            path = join_path(sp, self.property_name)
            per_species[sp] = exp.store.load([path], frames=anim)[path]
        out = write_html_3d(
            [[(sp, data[i]) for sp, data in per_species.items()] for i in range(len(anim))],
            exp.path / "figures" / "trajectory.html",
            title=f"{exp.name} trajectory",
            frame_labels=[f"frame {int(f)}" for f in anim],
        )
        if have_matplotlib():
            self._png(sorted({0, n // 2, n - 1}) if frames is None else list(frames))
        else:
            log.info("matplotlib does not import: trajectory.png not written")
        return out

    def _png(self, frames: List[int]) -> pathlib.Path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        exp = self.experiment
        fig = plt.figure(figsize=(5 * len(frames), 5))
        for i, frame in enumerate(frames):
            ax = fig.add_subplot(1, len(frames), i + 1, projection="3d")
            for c, sp in enumerate(self.species):
                path = join_path(sp, self.property_name)
                if not exp.store.check_existence(path):
                    continue
                pos = exp.store.load([path], frames=slice(frame, frame + 1))[path][0]
                ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], s=12, label=sp,
                           color=_COLORS[c % len(_COLORS)], alpha=0.8)
            ax.set_title(f"frame {frame}")
            if i == 0:
                ax.legend(loc="upper left", fontsize=8)
        out = exp.path / "figures" / "trajectory.png"
        out.parent.mkdir(exist_ok=True)
        fig.tight_layout()
        fig.savefig(out, dpi=110)
        plt.close(fig)
        log.info("wrote %s", out)
        return out
