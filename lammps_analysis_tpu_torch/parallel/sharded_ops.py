"""Device dispatch of the RDF pair histogram.

Counterpart of ``sharded_rdf_histogram`` in
``lammps_analysis_tpu/parallel/sharded_ops.py``, for one GPU. The JAX
package chunks frames to fit the TPU kernel's VMEM and shards them over a
mesh; the CUDA kernel takes any frame count, so here the call goes straight
to the kernel wrapper. Multi-GPU frame sharding is a later slice.
"""

from __future__ import annotations

import torch

from ..ops import rdf_kernel


def sharded_rdf_histogram(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    n_bins: int,
    n_species: int,
    mesh=None,
) -> torch.Tensor:
    """``(n_pairs, n_bins)`` int64 counts of one frame batch, on its device."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-device RDF is not ported yet (the multi-GPU slice); "
            "call without a mesh to run on one device"
        )
    return rdf_kernel.rdf_histogram(
        positions, species_id, box, cutoff, n_bins, n_species
    )
