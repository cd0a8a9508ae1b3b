"""Tracing and profiling hooks.

Counterpart of ``lammps_analysis_tpu/utils/profiling.py``: ``Stopwatch`` (named
host timers and throughput), ``device_trace`` (a profiler trace of a region,
``torch.profiler`` where the JAX package runs ``jax.profiler``) and
``annotate`` (a named region in that trace).
"""

from __future__ import annotations

import contextlib
import logging
import os
import pathlib
import time
from typing import Dict, Optional

import torch

log = logging.getLogger(__name__)


class Stopwatch:
    """Accumulating named timers with throughput reporting."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [
            f"{name}: {total:.4f} s over {self.counts[name]} calls"
            for name, total in sorted(self.totals.items())
        ]
        return "\n".join(lines)

    def throughput(self, name: str, items: float) -> float:
        """items per second for an accumulated section."""
        total = self.totals.get(name, 0.0)
        return items / total if total > 0 else 0.0


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Record the region with ``torch.profiler`` and write a Chrome trace
    (``chrome://tracing``, Perfetto) under ``log_dir`` as
    ``trace-<time>-<pid>.json``: host operations, and with a CUDA device
    its kernels, copies and memsets.

    No-op when ``log_dir`` is None, so call sites can leave the hook in
    place unconditionally.
    """
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = out / f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    log.info("torch profiler trace -> %s", path)


@contextlib.contextmanager
def annotate(name: str):
    """Named region in profiler timelines: ``torch.profiler.record_function``,
    and an NVTX range where a CUDA device is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
