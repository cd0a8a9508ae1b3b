"""The program's spans and counters, and the operator's trace.

Counterpart of ``lammps_analysis_tpu/utils/profiling.py`` (``device_trace``,
``annotate``; the JAX package's ``Stopwatch`` is not ported: nothing reads
host timers, the spans time every layer).

**Spans.** ``with annotate(name):`` marks a region of the program. With
tracing off (the default) it costs one flag check. Inside ``tracing()``
each span appends a :class:`Span` to the log ``tracing()`` yields: its name,
thread, start and end (``time.perf_counter_ns``), its parent span and the
``call`` span it belongs to. A span on a worker thread takes as parent the
span its work was submitted from (``annotate(name, parent=current())``). A
live span also opens a ``torch.profiler.record_function`` range and, with a
CUDA device, an NVTX range, so the same names appear beside the kernels in
``torch.profiler`` (the thread that started it) and in Nsight Systems (every
thread).

**Counters.** ``counters`` is one process-wide ``collections.Counter``;
``count(name, n)`` adds to it, always, with one dict update. A counter that
threads may add to at once (the store's, whose load runs on the prefetch
workers) takes ``count_shared(name, n)``, which holds a lock for the update.
A region's counts are the difference of two copies (``counters - before``).

The names (``<layer>.<what>``):

=========================  ==================================================
span                       where
=========================  ==================================================
``call``                   ``Calculator.__call__``, one an experiment
``deps``                   the dependency check (transformations it runs)
``calc.plan``              a calculator's batch or slab plan (the store's shapes)
``db.<method>``            every public method of ``ResultsDatabase``
``store.load``             ``TrajectoryStore.load``
``prefetch.load``          worker: the item's ``load_fn`` (the store's load,
                           concatenation, padding)
``prefetch.pin``           worker: page-locking the loaded arrays
``prefetch.copy``          worker: enqueueing the host-to-device copy
``prefetch.wait``          consumer: queueing the next load, waiting for the
                           item
``rdf.dispatch``           one frame batch of the RDF to the kernel
``<calc>.fetch``           the host's sync on the result (``rdf``, ``adf``,
                           ``einstein``)
``<calc>.normalise``       host post-processing (and fit) of the result
``adf.feed``               ``AdfBatchRunner.feed``: one batch dispatched
``adf.finalize``           ``AdfBatchRunner.finalize``: the largest count's sync
``adf.empty_lists``        the neighbor lists' allocation
``k1``                     ``rdf_kernel.rdf_histogram``
``k2.<route>``             the neighbor extract: ``binned``, ``sweep``, ``z``,
                           ``brick``
``k3``                     ``adf_kernel.adf_pairs_histogram``
``msd.comb``               ``msd.windowed_msd_sum``
``collective``             ``sharded_ops._all_reduce`` (in a process group)
=========================  ==================================================

=============================  =============================================
counter                        counts
=============================  =============================================
``db.connections``             SQLite connections the results DB opened
``store.bytes``                bytes of the arrays the store's load returned
``store.frames``               frames the store's load returned (per dataset)
``prefetch.items``             items the prefetch pipeline delivered
``adf.batches``                ``AdfBatchRunner.feed`` calls (every pass)
``adf.passes``                 ``AdfBatchRunner.finalize`` calls
``k1.launches``                K1 launches
``k2.launches.<route>``        K2 launches by route (``binned``, ``sweep``,
                               ``z``, ``brick``); ``k2.launches.open`` and
                               ``k2.launches.idx.<route>`` those in a mode
``k3.launches``                K3 launches
``k1.plain``, ``k2.plain``,    calls of the plain torch versions
``k3.plain``                   (``ops/rdf.py``, ``ops/adf.py``)
``collectives``                collectives of the sharded ops
=============================  =============================================

To see them: ``with device_trace(dir):`` writes a Chrome trace (Perfetto,
``chrome://tracing``) in which the main thread's spans sit above the
kernels they launched; ``nsys profile -t cuda,nvtx`` shows the NVTX ranges
of every thread, the prefetch workers' too; ``with tracing() as log:``
hands the spans to a program (``chip_spans.py`` reads a benchmark cell's).
``torch.profiler`` also reports each live span among its CUDA events, as a
GPU user annotation of the span's name: leave those out of the device's
busy time.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import logging
import os
import pathlib
import threading
import time
from typing import Optional

import torch

log = logging.getLogger(__name__)

#: the process's counters, always on
counters: collections.Counter = collections.Counter()
_counters_lock = threading.Lock()

_on = False  # spans are recorded
_log: Optional[list] = None  # where the live spans go
_nvtx = False  # live spans open NVTX ranges
_ids = itertools.count(1)
_stacks = threading.local()  # each thread's open live spans


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``. Not atomic: every increment of
    ``name`` comes from one thread at a time, else it takes
    :func:`count_shared`."""
    counters[name] += n


def count_shared(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` from any thread, under a lock."""
    with _counters_lock:
        counters[name] += n


class Span:
    """One live span: ``id``, ``name``, ``thread`` (``threading.get_ident``),
    ``start_ns`` and ``end_ns`` (``time.perf_counter_ns``), the ``parent``
    span's id and the enclosing ``call`` span's id (``None`` where there is
    none). A context manager; the log receives it at its end."""

    __slots__ = ("id", "name", "thread", "start_ns", "end_ns", "parent", "call", "_log",
                 "_range")

    def __init__(self, name: str, parent: Optional["Span"]):
        self.name = name
        self.id = next(_ids)
        stack = _stack()
        above = stack[-1] if stack else parent
        self.parent = above.id if above is not None else None
        self.call = self.id if name == "call" else (above.call if above is not None else None)
        self.thread = threading.get_ident()
        self.end_ns = None
        self._log = _log

    # the span's own cost (the ranges it opens) lies inside it, not in its parent
    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        _stack().append(self)
        if _nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        if _nvtx:
            torch.cuda.nvtx.range_pop()
        stack = _stack()
        if self in stack:
            stack.remove(self)
        self.end_ns = time.perf_counter_ns()
        self._log.append(self)
        return False


class _Off:
    """The span of tracing off: enters and leaves, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_stacks, "spans", None)
    if stack is None:
        stack = _stacks.spans = []
    return stack


def annotate(name: str, parent: Optional[Span] = None):
    """A span named ``name`` (a context manager). Its parent is the
    innermost open span of this thread, else ``parent`` (a span of the
    thread that handed this one its work, from :func:`current`)."""
    return Span(name, parent) if _on else _OFF


def current() -> Optional[Span]:
    """This thread's innermost open span, ``None`` with tracing off."""
    if not _on:
        return None
    stack = _stack()
    return stack[-1] if stack else None


def method_spans(prefix: str):
    """Class decorator: every public method of the class runs in a span
    ``<prefix>.<method>``."""

    def wrap(cls):
        for name, fn in list(vars(cls).items()):
            if name.startswith("_") or not callable(fn):
                continue
            setattr(cls, name, _spanned(f"{prefix}.{name}", fn))
        return cls

    return wrap


def _spanned(name: str, fn):
    def inner(*args, **kwargs):
        with annotate(name):
            return fn(*args, **kwargs)

    # the method's name and doc, but no ``__wrapped__``: that marks the
    # wrappers that change what a call does (``multihost.rank_zero``)
    for attr in functools.WRAPPER_ASSIGNMENTS:
        setattr(inner, attr, getattr(fn, attr))
    return inner


@contextlib.contextmanager
def tracing():
    """Record spans inside the region; yields the log, a list of
    :class:`Span` in the order they ended. Nested regions share the outer
    log."""
    global _on, _log, _nvtx
    outer = _on, _log, _nvtx
    if _log is None:
        _log = []
    _on, _nvtx = True, torch.cuda.is_available()
    try:
        yield _log
    finally:
        _on, _log, _nvtx = outer


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Record the region with ``torch.profiler`` and write a Chrome trace
    (``chrome://tracing``, Perfetto) under ``log_dir`` as
    ``trace-<time>-<pid>.json``: host operations and the program's spans
    (``tracing()`` is on inside), and with a CUDA device its kernels, copies
    and memsets.

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
    with profile(activities=activities) as prof, tracing():
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = out / f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    log.info("torch profiler trace -> %s", path)
