"""Mesh + sharded kernel wrappers (multi-device execution layer)."""
from .mesh import (  # noqa: F401
    data_sharding,
    get_default_mesh,
    make_2d_mesh,
    make_data_mesh,
    use_mesh,
)
from .sharded_ops import (  # noqa: F401
    AdfBatchRunner,
    sharded_adf_histogram,
    sharded_adf_histogram_2d,
    sharded_rdf_histogram,
    sharded_rdf_histogram_2d,
    sharded_windowed_acf,
    sharded_windowed_msd,
)
from . import multihost  # noqa: F401
from .dryrun import dryrun_multichip  # noqa: F401
