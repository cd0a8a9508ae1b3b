"""Time-series inspection: rolling means of stored per-atom properties.

Counterpart of ``lammps_analysis_tpu/time_series/base.py`` (the reference's
``mdsuite/time_series/base.py:47-120`` and ``energies.py:38-43``): a
TimeSeries loads one property for chosen species, sums it over atoms and
dimensions per frame on ``config.device`` in float64, applies a rolling mean,
and plots the per-frame totals over time (quick sanity checks, such as
potential-energy drift). The plot is an HTML (``visualizer/html_plots.py``),
and a PNG as well where matplotlib imports; the JAX package writes the PNG
alone.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from ..database.properties import mdsuite_properties as mp
from ..database.trajectory_store import join_path
from ..parallel.multihost import rank_zero
from ..utils.config import get_device
from ..visualizer.html_plots import write_html_plot
from ..visualizer.plots import have_matplotlib

log = logging.getLogger(__name__)


class TimeSeries:
    """Base: load -> per-frame total -> rolling mean -> plot."""

    loaded_property = None

    def __init__(self, experiment):
        self.experiment = experiment

    def __call__(
        self,
        species: Optional[List[str]] = None,
        window: int = 1,
        save_plot: bool = True,
    ) -> dict:
        """``{"time": (T,), "series": {species: (T,)}}`` numpy float64, the
        JAX package's result: ``T`` frames less ``window - 1``, times in
        simulation units (frame index times time step times sample rate)."""
        exp = self.experiment
        prop = self.loaded_property.name
        if species is None:
            species = [
                sp for sp in exp.species
                if exp.store.check_existence(join_path(sp, prop))
            ]
        if not species:
            raise ValueError(
                f"No species with stored property {prop!r} in {exp.name!r}"
            )
        device = get_device()
        series = {}
        for sp in species:
            data = exp.store.load([join_path(sp, prop)])[join_path(sp, prop)]
            total = torch.from_numpy(data).to(device, torch.float64).sum(dim=(1, 2))
            if window > 1:
                total = total.unfold(0, window, 1).mean(1)
            series[sp] = total.cpu().numpy()
        times = (
            np.arange(max(len(v) for v in series.values()))
            * exp.time_step
            * exp.sample_rate
        )
        if save_plot:
            rank_zero(self._plot)(times, series)
        return {"time": times, "series": series}

    def _plot(self, times, series) -> None:
        """``figures/timeseries_<property>.html``, then the PNG where
        matplotlib imports (on rank 0 alone in a process group)."""
        prop = self.loaded_property.name
        figures = self.experiment.path / "figures"
        panels = {sp: {"time": times[: len(v)], prop: v} for sp, v in series.items()}
        write_html_plot(panels, ["time", prop], out_dir=figures, title=f"timeseries_{prop}")
        if not have_matplotlib():
            log.info("matplotlib does not import: timeseries_%s.png not written", prop)
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4))
        for sp, vals in series.items():
            ax.plot(times[: len(vals)], vals, label=sp, lw=1.0)
        ax.set_xlabel("time (sim units)")
        ax.set_ylabel(prop)
        ax.legend()
        ax.grid(alpha=0.3)
        out = figures / f"timeseries_{prop}.png"
        out.parent.mkdir(exist_ok=True)
        fig.tight_layout()
        fig.savefig(out, dpi=110)
        plt.close(fig)
        log.info("wrote %s", out)


class Energies(TimeSeries):
    """Potential-energy time series (reference ``energies.py:38-43``)."""

    loaded_property = mp.potential_energy


class Temperature(TimeSeries):
    """Temperature time series."""

    loaded_property = mp.temperature


class KineticEnergies(TimeSeries):
    """Kinetic-energy time series."""

    loaded_property = mp.kinetic_energy


time_series_dict = {
    "Energies": Energies,
    "Temperature": Temperature,
    "KineticEnergies": KineticEnergies,
}
