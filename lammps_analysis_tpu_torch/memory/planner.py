"""Static batch planner: memory budgets -> frame-slab / atom-tile plans.

Counterpart of ``lammps_analysis_tpu/memory/planner.py``: frame slabs (with
the windowed calculators' ``data_range`` floor), the atom-axis minibatch of
one window, transformation slabs, the pairwise i-tile and the window count.
The budget comes from the configured device: the GPU's total memory times
``config.device_memory_fraction`` on CUDA, physical host RAM times
``config.memory_fraction`` on the CPU, shared out among the ranks of a
process group that use the same device (``multihost.ranks_per_device``):
four ranks on one card plan a quarter each. The total, not the free memory,
so every rank of a group of like cards plans the same batches. It needs
neither psutil nor jax.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import numpy as np
import torch

from ..parallel.multihost import ranks_per_device
from ..utils.config import config, get_device
from ..utils.scale_functions import resolve_scale_function

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """A static plan for streaming one calculator run."""

    frame_batch: int  # frames per slab
    n_batches: int
    remainder: int  # frames in the final short slab (0 if exact)
    atom_block: int  # i-tile size for pairwise kernels
    total_frames: int
    #: largest full-atom-width slab that fits the budget BEFORE the
    #: data_range clamp: ``raw_frame_batch < data_range`` means one window
    #: of all atoms exceeds the budget and the stream must split the atom
    #: axis (reference ``_compute_atomwise_minibatch``,
    #: ``memory_manager.py:257-340``)
    raw_frame_batch: int = 0


class BatchPlanner:
    """Computes memory-bounded batch plans for the configured device."""

    def __init__(self, memory_budget_bytes: Optional[int] = None):
        self._budget_override = memory_budget_bytes

    @property
    def budget_bytes(self) -> int:
        if self._budget_override is not None:
            return self._budget_override
        device = get_device()
        if device.type == "cuda":
            total = torch.cuda.mem_get_info(device)[1]
            return int(total * config.device_memory_fraction / ranks_per_device())
        host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        return int(host * config.memory_fraction / ranks_per_device())

    def plan(
        self,
        n_frames: int,
        bytes_per_frame: float,
        scale_function: Optional[dict] = None,
        data_range: Optional[int] = None,
    ) -> BatchPlan:
        """Largest frame slab whose scaled footprint fits the budget.

        ``bytes_per_frame`` is the raw footprint of one configuration of all
        loaded datasets; the scale function turns it into the calculator's
        working-set estimate (monotone, so a bisection finds the batch). A
        windowed calculator passes ``data_range``: a slab holds at least one
        whole window.
        """
        fn, kwargs = resolve_scale_function(scale_function)
        budget = self.budget_bytes
        lo, hi = 1, max(n_frames, 1)
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if fn(mid * bytes_per_frame, **kwargs) <= budget:
                lo = mid
            else:
                hi = mid - 1
        batch = raw = lo
        if data_range is not None:
            batch = max(batch, data_range)
        batch = min(batch, n_frames) if n_frames else batch
        n_batches, rem = divmod(n_frames, batch)
        if rem:
            n_batches += 1
        plan = BatchPlan(
            frame_batch=batch,
            n_batches=n_batches,
            remainder=rem,
            atom_block=self.atom_block_for(scale_function),
            total_frames=n_frames,
            raw_frame_batch=raw,
        )
        log.debug("batch plan: %s (budget %.1f GB)", plan, budget / 2**30)
        return plan

    def window_atoms_per_group(
        self,
        n_atoms: int,
        data_range: int,
        bytes_per_atom_frame: float,
        scale_function: Optional[dict] = None,
    ) -> int:
        """Atoms per minibatch so ONE window of that many atoms fits.

        The reference's atom-wise minibatch fraction ladder
        (``memory_manager.py:257-340``) as a bisection for the largest atom
        count whose ``data_range``-frame window fits the budget. Floors at 1
        atom (the reference's single-atom fallback).
        """
        fn, kwargs = resolve_scale_function(scale_function)
        budget = self.budget_bytes
        lo, hi = 1, max(int(n_atoms), 1)
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if fn(data_range * mid * bytes_per_atom_frame, **kwargs) <= budget:
                lo = mid
            else:
                hi = mid - 1
        return lo

    #: per-slab ceiling for streamed transformations: many same-shaped
    #: moderate slabs let the one-slab lookahead overlap loads with compute
    TRANSFORMATION_SLAB_BYTES = 2**30

    def transformation_batch_size(self, trafo, experiment) -> int:
        """Frames per slab for a transformation run."""
        n_atoms = max(
            (sp.n_particles for sp in experiment.species.values()), default=1
        )
        n_props = len(trafo.input_properties) + 1
        bytes_per_frame = n_atoms * 3 * 8 * n_props
        fn, kwargs = resolve_scale_function(trafo.scale_function)
        budget = min(self.budget_bytes, self.TRANSFORMATION_SLAB_BYTES)
        batch = int(budget / max(fn(bytes_per_frame, **kwargs), 1))
        return int(np.clip(batch, 1, max(experiment.number_of_configurations, 1)))

    @staticmethod
    def window_plan(n_frames: int, data_range: int, correlation_time: int) -> int:
        """Number of sliding windows (reference ``get_ensemble_loop``)."""
        if n_frames < data_range:
            return 0
        return (n_frames - data_range) // correlation_time + 1

    @staticmethod
    def atom_block_for(scale_function: Optional[dict]) -> int:
        """i-tile size for pairwise kernels (128 for quadratic cost models)."""
        if scale_function and (
            "quadratic" in scale_function or "polynomial" in scale_function
        ):
            return 128
        return 512
