"""Double-buffered host -> device prefetch pipeline.

Counterpart of ``lammps_analysis_tpu/pipeline/prefetch.py``. A worker thread
runs ``load_fn`` (disk I/O and numpy work) into a pinned host tensor and
issues a ``non_blocking`` copy on a dedicated copy stream (every array of a
dict of arrays, for a slab of several species); the consumer's
stream waits on an event recorded after the copy, so the copy of batch k+1
overlaps the kernels of batch k. On the CPU device the worker only loads.
"""

from __future__ import annotations

import collections
import concurrent.futures
import logging
from typing import Callable, Dict, Iterator, Sequence, TypeVar

import numpy as np
import torch

from ..utils.config import get_device

log = logging.getLogger(__name__)

T = TypeVar("T")


def prefetch_to_device(
    load_fn: Callable[[T], np.ndarray | Dict[str, np.ndarray]],
    items: Sequence[T],
    depth: int = 2,
    device: torch.device | None = None,
) -> Iterator[torch.Tensor | Dict[str, torch.Tensor]]:
    """Yield ``load_fn(item)`` as a tensor on ``device``, ``depth`` items ahead.

    ``load_fn`` returns an array, or a dict of arrays (several species of
    one slab), which arrives as a dict of tensors copied together.
    ``device=None`` means the configured device (``config.device``). Each
    yielded tensor is ready for use on the caller's current stream.
    """
    items = list(items)
    if not items:
        return
    device = get_device() if device is None else torch.device(device)
    copy_stream = (
        torch.cuda.Stream(device=device) if device.type == "cuda" else None
    )

    def load_and_copy(item):
        loaded = load_fn(item)
        as_dict = isinstance(loaded, dict)
        tensors = {
            k: torch.from_numpy(np.ascontiguousarray(a))
            for k, a in (loaded.items() if as_dict else [(None, loaded)])
        }
        done = None
        if copy_stream is not None:
            pinned = {k: t.pin_memory() for k, t in tensors.items()}
            with torch.cuda.stream(copy_stream):
                tensors = {k: t.to(device, non_blocking=True) for k, t in pinned.items()}
                done = torch.cuda.Event()
                done.record(copy_stream)
        return (tensors if as_dict else tensors[None]), done

    with concurrent.futures.ThreadPoolExecutor(max_workers=depth) as pool:
        queue = collections.deque()
        it = iter(items)
        for _ in range(depth):
            try:
                queue.append(pool.submit(load_and_copy, next(it)))
            except StopIteration:
                break
        while queue:
            fut = queue.popleft()
            try:
                queue.append(pool.submit(load_and_copy, next(it)))
            except StopIteration:
                pass
            out, done = fut.result()
            if done is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(done)
                # the tensors were allocated on the copy stream: tell the
                # caching allocator the consumer's stream uses them too
                for tensor in out.values() if isinstance(out, dict) else (out,):
                    tensor.record_stream(consumer)
            yield out


def iter_in_background(iterable, depth: int = 2):
    """Run a (host-side) iterator in a worker thread with bounded lookahead.

    Parse/write overlap for ingestion: the reader produces chunk k+1 while
    the caller writes chunk k to the store. ``depth`` bounds the number of
    produced-but-unconsumed chunks. Exceptions from the producer re-raise at
    the consumer's next pull; abandoning the iterator stops the producer.
    """
    import queue as queue_mod
    import threading

    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=max(int(depth), 1))
    _END = object()
    stop = threading.Event()

    def _put_until_stopped(item) -> bool:
        """Bounded put that gives up once the consumer signals stop."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def produce():
        try:
            for item in iterable:
                if not _put_until_stopped(item):
                    return
            _put_until_stopped(_END)
        except BaseException as err:  # propagate to the consumer
            _put_until_stopped(err)

    worker = threading.Thread(target=produce, daemon=True, name="ingest-parse")
    worker.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
