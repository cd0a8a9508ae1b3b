"""Device dispatch of the analysis kernels (single GPU in this slice)."""
from .sharded_ops import sharded_rdf_histogram  # noqa: F401
