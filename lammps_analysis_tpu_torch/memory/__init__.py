"""Memory-budgeted batch planning."""
from .planner import BatchPlan, BatchPlanner  # noqa: F401
