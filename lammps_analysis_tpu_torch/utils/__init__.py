"""Utilities: units, configuration, constants."""
from . import units  # noqa: F401
from .config import config, get_device  # noqa: F401
