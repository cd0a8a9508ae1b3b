"""Experiments and the ``exp.run`` hub."""
from .experiment import Experiment  # noqa: F401
from .run import RunComputation  # noqa: F401
