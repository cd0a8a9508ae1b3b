"""Plotting and visualization: self-contained HTML, and PNG where matplotlib imports."""
from .plots import have_matplotlib, plot_series_results  # noqa: F401
from .trajectory_visualizer import TrajectoryVisualizer  # noqa: F401
