"""Device dispatch of the analysis kernels (single GPU in this slice)."""
from .sharded_ops import (  # noqa: F401
    AdfBatchRunner,
    sharded_adf_histogram,
    sharded_rdf_histogram,
)
