"""Host-side helpers the readers need.

Copied from ``lammps_analysis_tpu/utils/meta.py``: ``optimize_batch_size``
only. That module's machine and accelerator introspection asks jax for its
devices; the port sizes device work from ``memory/planner.py`` instead.
"""

from __future__ import annotations

import os


def optimize_batch_size(
    filepath, number_of_configurations: int, expansion_factor: float = 5.0
) -> int:
    """How many configurations to parse per ingestion batch.

    Same heuristic as the reference (``meta_functions.py:185-238``): allow 10%
    of host RAM, assume ~``expansion_factor``x in-memory blow-up of the text.
    """
    import psutil

    file_size = os.path.getsize(filepath)
    memory_per_cfg = expansion_factor * file_size / max(number_of_configurations, 1)
    budget = 0.1 * psutil.virtual_memory().total
    batch = int(budget / max(memory_per_cfg, 1))
    return max(1, min(batch, number_of_configurations))
