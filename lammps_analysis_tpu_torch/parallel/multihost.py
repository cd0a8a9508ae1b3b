"""Multi-process initialisation on ``torch.distributed``: one process per GPU.

Counterpart of ``lammps_analysis_tpu/parallel/multihost.py``. The JAX package
runs one process over every local device and ``jax.distributed`` across
hosts; the port runs one process per GPU, the PyTorch idiom: every process
runs the same analysis script, and the sharded ops (``sharded_ops.py``) split
frames, particles, i-rows or centers over the ranks of the process group and
merge with collectives. NCCL carries the collectives between cards, gloo on
the CPU. One Python thread per card also spreads the host work (loads,
launches) that sets the pace of most calls.

Usage, one call near the top of the script on every process::

    from lammps_analysis_tpu_torch.parallel import multihost
    multihost.initialize()      # under torchrun --nproc-per-node 4 script.py
    # or explicitly:
    multihost.initialize(coordinator_address="10.0.0.1:29500",
                         num_processes=4, process_id=rank)

Shared state on disk (the npy trajectory store and the results DB) is written
by rank 0 alone, so that every rank sees the same state and takes the same
branch: ``shared`` makes a project's store and DB behind ``RankZeroWrites``,
which runs each of their writes through ``rank_zero``, and the entry points
that write much (ingest, transformations) or decide for every rank (the
cache lookup) run whole through ``rank_zero``; the storage modules know no
process group. ``launch_local`` runs a function on a
world of local processes (the tests, the dry run and ``chip_smoke.py`` use it).
"""

from __future__ import annotations

import datetime
import functools
import logging
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..utils.config import config, get_device

log = logging.getLogger(__name__)

#: ranks of the group that share this rank's device (the planner's divisor)
_ranks_per_device = 1
#: depth of ``rank_zero`` calls running on rank 0 (nested writes run as they are)
_rank_zero_depth = 0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: float = 600.0,
) -> None:
    """Join the process group (no-op if this process has joined one).

    Without a coordinator address the torchrun environment is read
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). An address
    ``host:port`` rendezvouses over TCP; a ``tcp://`` or ``file://`` URL is
    used as it is. ``timeout`` (seconds) bounds the rendezvous and every
    collective, so a rank that never arrives fails the others instead of
    hanging them.

    The backend follows ``config.device``: gloo on the CPU; on CUDA, each
    rank takes card ``local_rank % torch.cuda.device_count()`` (it becomes
    ``config.device``) and NCCL, which needs a card per rank. Ranks that
    would share a card raise unless the caller passes ``backend="gloo"``:
    gloo then carries the collectives, staging CUDA tensors through the host
    (``sharded_ops._all_reduce``). The ranks of a host (its local world) are
    found through the rendezvous (``local_world_of``), so ranks on several
    hosts need no torchrun environment.
    """
    global _ranks_per_device
    if dist.is_initialized():
        log.info("torch.distributed already initialised")
        return
    env = os.environ
    limit = datetime.timedelta(seconds=timeout)
    if coordinator_address is None:
        if "RANK" not in env or "WORLD_SIZE" not in env:
            raise RuntimeError(
                "multihost.initialize() without a coordinator address reads "
                "torchrun's RANK and WORLD_SIZE, which are not set; run under "
                "torchrun or pass coordinator_address, num_processes and process_id"
            )
        init_method = "env://"
        num_processes = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(env["RANK"]) if process_id is None else process_id
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init_method = (
            coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}"
        )
    store = next(dist.rendezvous(init_method, process_id, num_processes, timeout=limit))[0]
    store.set_timeout(limit)
    local_rank, local_world = local_world_of(store, process_id, num_processes)
    device = get_device()
    if device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"config.device is 'cpu': backend {backend!r} needs a GPU, use gloo")
        backend = "gloo"
        per_device = local_world
    else:
        n_cards = torch.cuda.device_count()
        index = local_rank % n_cards
        per_device = local_world // n_cards + (1 if index < local_world % n_cards else 0)
        if per_device > 1 and backend != "gloo":
            raise RuntimeError(
                f"{local_world} ranks on {n_cards} card(s) of this host: ranks would share a "
                "card, which NCCL refuses; give each rank its own card, or pass "
                "backend='gloo' to share one (collectives then go through the host)"
            )
        backend = backend or "nccl"
        torch.cuda.set_device(index)
        config.device = f"cuda:{index}"
    dist.init_process_group(
        backend, store=store, world_size=num_processes, rank=process_id, timeout=limit,
    )
    _ranks_per_device = per_device
    log.info(
        "process group: rank %d of %d on %s, backend %s, %d rank(s) on this device",
        process_id, num_processes, config.device, backend, per_device,
    )


def local_world_of(store, process_id: int, num_processes: int,
                   host: Optional[str] = None) -> tuple[int, int]:
    """This rank's index among the ranks of its host, and their number.

    Every rank posts its host name (``socket.gethostname()`` by default) to
    the rendezvous ``store`` and reads every other rank's; the ranks of a
    host are numbered in the order of their global ranks, as torchrun
    numbers ``LOCAL_RANK``.
    """
    host = socket.gethostname() if host is None else host
    store.set(f"local_world/{process_id}", host)
    hosts = [store.get(f"local_world/{r}").decode() for r in range(num_processes)]
    local = [r for r, h in enumerate(hosts) if h == host]
    return local.index(process_id), len(local)


def is_multihost() -> bool:
    """True in a process group of more than one rank."""
    return world_size() > 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """Ranks of the process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def ranks_per_device() -> int:
    """Ranks of the group that share this rank's device (1 without a group):
    the batch planner gives each of them its share of the device's budget."""
    return _ranks_per_device if dist.is_initialized() else 1


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    global _ranks_per_device
    if dist.is_initialized():
        dist.destroy_process_group()
    _ranks_per_device = 1


def in_rank_zero() -> bool:
    """True inside a ``rank_zero`` call, which runs on rank 0 alone: code
    there must not enter a collective (``mesh.get_default_mesh`` is this
    process alone there)."""
    return _rank_zero_depth > 0


def rank_zero(fn: Callable) -> Callable:
    """Run ``fn`` on rank 0 alone and hand its result to every rank.

    For writes to state that every rank reads (the trajectory store, the
    results DB) and for decisions every rank must share (a cache hit). Every
    rank calls the wrapped function at the same point: all ranks arrive
    (a barrier: each has finished its reads of the old state), rank 0 runs
    ``fn``, and its result or its error goes to every rank
    (``broadcast_object_list``), which also holds the others until the write
    is done. A call inside another ``rank_zero`` call, or outside a group of
    more than one rank, runs ``fn`` as it is.
    """

    @functools.wraps(fn)
    def run(*args, **kwargs):
        global _rank_zero_depth
        if _rank_zero_depth or not is_multihost():
            return fn(*args, **kwargs)
        dist.barrier()
        box, error = [None], None
        if dist.get_rank() == 0:
            _rank_zero_depth += 1
            try:
                box[0] = (True, fn(*args, **kwargs))
            except Exception as err:  # every rank raises, not rank 0 alone
                error = err
                box[0] = (False, f"{type(err).__name__}: {err}")
            finally:
                _rank_zero_depth -= 1
        dist.broadcast_object_list(box, src=0)
        ok, value = box[0]
        if error is not None:
            raise error
        if not ok:
            raise RuntimeError(f"{fn.__qualname__} failed on rank 0: {value}")
        return value

    return run


class RankZeroWrites:
    """A storage object of the process group (the trajectory store, the
    results DB): the methods its class names in ``WRITES`` run through
    ``rank_zero``; every other attribute is the object's own."""

    def __init__(self, target):
        self._target = target

    def __getattr__(self, name):
        attr = getattr(self._target, name)
        return rank_zero(attr) if name in type(self._target).WRITES else attr


def shared(cls, *args, **kwargs) -> RankZeroWrites:
    """``cls(*args, **kwargs)`` behind ``RankZeroWrites`` on every rank,
    made on rank 0 first (a constructor may create files)."""
    made = []
    rank_zero(lambda: made.append(cls(*args, **kwargs)))()
    return RankZeroWrites(made[0] if made else cls(*args, **kwargs))


def launch_local(
    n: int,
    target: Callable,
    *args,
    backend: Optional[str] = None,
    device: Optional[str] = None,
    timeout: float = 300.0,
    collective_timeout: float = 60.0,
    workdir=None,
) -> list:
    """Run ``target(*args)`` on a world of ``n`` local processes; the return
    values by rank.

    Each process sets ``config.device`` to ``device`` (this process's
    ``config.device`` by default) and joins a group of ``n`` ranks over a
    ``file://`` rendezvous in ``workdir`` (a temporary directory by
    default), with ``backend`` (``initialize`` picks it by default: NCCL
    with a card a rank, gloo on the CPU); ``target`` must be a function
    of an importable module (the processes get this process's ``sys.path``),
    its arguments and return value picklable. A rank that fails stops the
    world at once; a world that has not finished after ``timeout`` seconds
    is killed. Either raises ``RuntimeError`` with each failed rank's
    traceback. ``backend="gloo"`` on CUDA puts every rank on card
    ``rank % device_count``, sharing it when there are fewer cards.
    """
    device = str(config.device) if device is None else device
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(workdir or tmp)
        root.mkdir(parents=True, exist_ok=True)
        spec = root / "spec.pkl"
        spec.write_bytes(pickle.dumps(dict(
            target=(target.__module__, target.__qualname__), args=args, backend=backend,
            device=device, n=n, collective_timeout=collective_timeout,
            rendezvous=f"file://{(root / 'rendezvous').resolve()}",
        )))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
        env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n)))
        code = "from lammps_analysis_tpu_torch.parallel.multihost import _child; _child()"
        procs = [
            subprocess.Popen([sys.executable, "-c", code, str(spec), str(r)], env=env)
            for r in range(n)
        ]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        failures = []
        for r, p in enumerate(procs):
            err = root / f"error-{r}.txt"
            if err.exists():
                failures.append(f"rank {r}:\n{err.read_text()}")
            elif p.returncode != 0:
                failures.append(f"rank {r}: exit code {p.returncode} (killed after the "
                                "world's timeout or another rank's failure)")
        if failures:
            raise RuntimeError(f"a world of {n} failed:\n" + "\n".join(failures))
        return [pickle.loads((root / f"result-{r}.pkl").read_bytes()) for r in range(n)]


def _child() -> None:
    """One rank of ``launch_local``: ``python -c ... <spec> <rank>``."""
    import importlib

    spec_path, rank_ = pathlib.Path(sys.argv[1]), int(sys.argv[2])
    spec = pickle.loads(spec_path.read_bytes())
    root = spec_path.parent
    try:
        config.device = spec["device"]
        initialize(spec["rendezvous"], spec["n"], rank_, backend=spec["backend"],
                   timeout=spec["collective_timeout"])
        module, name = spec["target"]
        fn = importlib.import_module(module)
        for part in name.split("."):
            fn = getattr(fn, part)
        result = fn(*spec["args"])
        (root / f"result-{rank_}.pkl").write_bytes(pickle.dumps(result))
    except BaseException:  # the parent reports it with the other ranks'
        (root / f"error-{rank_}.txt").write_text(traceback.format_exc())
        raise
    finally:
        shutdown()
