"""Make the JAX package's readers parse as the port's do, for the tests that
hold the port against it."""

import time


def ensure_jax_native_parser(attempts=10, wait=3.0):
    """Load the JAX package's native table parser, waiting out another test
    process that builds it in place (``native/_table_parser.so``). A load
    that races that build marks the parser unavailable for the whole
    process, and the JAX readers then take their pandas engine, which
    parses to float64 where the native route gives float32."""
    from lammps_analysis_tpu.file_io import native_parser

    for _ in range(attempts):
        if native_parser.available():
            return
        time.sleep(wait)
        native_parser._build_failed = False  # try the load again
    raise RuntimeError("the JAX package's native table parser does not load")
