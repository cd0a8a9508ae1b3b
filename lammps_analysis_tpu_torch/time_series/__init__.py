"""Time-series inspection tools."""
from .base import Energies, KineticEnergies, Temperature, TimeSeries, time_series_dict  # noqa: F401
