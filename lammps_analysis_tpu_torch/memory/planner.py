"""Static batch planner: memory budgets -> frame-slab / atom-tile plans.

Counterpart of ``lammps_analysis_tpu/memory/planner.py`` for the slice the
port carries (frame slabs and the pairwise i-tile). The budget comes from
the configured device: the GPU's total memory times
``config.device_memory_fraction`` on CUDA, physical host RAM times
``config.memory_fraction`` on the CPU. It needs neither psutil nor jax.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import torch

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
            return int(total * config.device_memory_fraction)
        host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        return int(host * config.memory_fraction)

    def plan(
        self,
        n_frames: int,
        bytes_per_frame: float,
        scale_function: Optional[dict] = None,
    ) -> BatchPlan:
        """Largest frame slab whose scaled footprint fits the budget.

        ``bytes_per_frame`` is the raw footprint of one configuration of all
        loaded datasets; the scale function turns it into the calculator's
        working-set estimate (monotone, so a bisection finds the batch).
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
        batch = min(lo, n_frames) if n_frames else lo
        n_batches, rem = divmod(n_frames, batch)
        if rem:
            n_batches += 1
        plan = BatchPlan(
            frame_batch=batch,
            n_batches=n_batches,
            remainder=rem,
            atom_block=self.atom_block_for(scale_function),
            total_frames=n_frames,
        )
        log.debug("batch plan: %s (budget %.1f GB)", plan, budget / 2**30)
        return plan

    @staticmethod
    def atom_block_for(scale_function: Optional[dict]) -> int:
        """i-tile size for pairwise kernels (128 for quadratic cost models)."""
        if scale_function and (
            "quadratic" in scale_function or "polynomial" in scale_function
        ):
            return 128
        return 512
