"""Opt-out progress bars for long-running loops.

The reference wraps every ingestion/batch loop in ``tqdm`` (e.g.
``mdsuite/file_io/tabular_text_files.py`` batch loop,
``mdsuite/calculators/trajectory_calculator.py`` ensemble loops). This
build streams through far fewer, larger slabs, but multi-minute stages
(large ingests, long transport stacks) still deserve a liveness signal.

``progress_iter`` is a zero-cost pass-through when disabled. Resolution
order for enablement:

1. ``config.progress_bars`` if explicitly set (True/False),
2. otherwise auto: on only when stderr is a TTY or inside a notebook
   (``config.jupyter``) — so pytest/benchmark/driver runs stay clean
   without any env plumbing.
"""

from __future__ import annotations

import sys
from typing import Iterable, Iterator, Optional

from .config import config


def _enabled() -> bool:
    flag = getattr(config, "progress_bars", None)
    if flag is not None:
        return bool(flag)
    if config.jupyter:
        return True
    try:
        return sys.stderr.isatty()
    except Exception:  # pragma: no cover - exotic stderr replacements
        return False


def progress_iter(
    iterable: Iterable,
    desc: str,
    total: Optional[int] = None,
    unit: str = "it",
) -> Iterator:
    """Wrap ``iterable`` in a tqdm bar when progress bars are enabled.

    Falls back to the bare iterable when disabled or tqdm is missing, so
    callers never need a conditional. ``leave=False`` keeps finished bars
    from stacking up across a multi-calculator session.
    """
    if not _enabled():
        return iter(iterable)
    try:
        from tqdm.auto import tqdm
    except ImportError:  # pragma: no cover - tqdm is in the base image
        return iter(iterable)
    return iter(
        tqdm(iterable, desc=desc, total=total, unit=unit, leave=False)
    )
