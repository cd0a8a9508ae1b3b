"""Device meshes over the ranks of the process group.

Counterpart of ``lammps_analysis_tpu/parallel/mesh.py`` with its names and
semantics: a process-wide default mesh over which the sharded ops
(``sharded_ops.py``) split their work, a 1-D ``("data",)`` mesh by default
and a 2-D ``("data", "atoms")`` mesh for the pairwise ops of large systems.

One divergence: the JAX default mesh is every local device of its one
process; the port runs one process per GPU (``multihost.py``), so its
default mesh is every rank of the process group, or this process alone when
there is no group. A mesh of one rank inside a group (``make_data_mesh(1)``,
the one-device reference of the tests) is this process alone as well: its
ops run no collective.

The port keeps a small mesh class of its own rather than
``torch.distributed.device_mesh.init_device_mesh``. That call picks each
rank's card itself (``rank % device_count`` when none is set) and builds a
communicator per axis; the port picks the card in
``multihost.initialize`` (sharing it under gloo where ranks outnumber
cards) and needs no per-axis communicator, since every merge of the sharded
ops reduces over all axes of the mesh, as the JAX ``shard_map`` bodies
``psum`` over every axis. A class of its own also behaves the same under the
torch of the tests (2.13, CPU) and of the card's machine (2.11). So a mesh
holds its axis sizes, this rank's coordinates (row-major, as JAX reshapes
its device array) and one process group over all of its ranks.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch.distributed as dist

from . import multihost


class Mesh:
    """Named axes over the ranks of the process group, or over this process
    alone (``group`` None: no collective)."""

    def __init__(self, shape: dict, group=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.group = group
        self.rank = dist.get_rank() if group is not None else 0

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        names = self.axis_names
        stride = math.prod(self.shape[a] for a in names[names.index(axis) + 1 :])
        return (self.rank // stride) % self.shape[axis]


_active_mesh: Optional[Mesh] = None


def _mesh(shape: dict) -> Mesh:
    """A mesh of ``shape`` over every rank of the group, or over this
    process when ``shape`` has one rank and the group more."""
    size = math.prod(shape.values())
    world = multihost.world_size()
    if dist.is_initialized() and size == world:
        return Mesh(shape, dist.group.WORLD)
    if size == 1:
        return Mesh(shape)
    raise ValueError(
        f"a mesh of {size} ranks in a process group of {world if dist.is_initialized() else 0}: "
        "a mesh spans every rank of the group, or one (this process alone); "
        "start the group with multihost.initialize"
    )


def make_data_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh, axis ``data``, over every rank of the group (``None``) or
    this process alone (``1``)."""
    return _mesh({"data": multihost.world_size() if n_devices is None else n_devices})


def make_2d_mesh(data: int, atoms: int) -> Mesh:
    """2-D ``(data, atoms)`` mesh for frame x atom-stripe sharding."""
    return _mesh({"data": data, "atoms": atoms})


def get_default_mesh() -> Mesh:
    """The active mesh (context-set), else every rank on ``data``. Inside a
    ``multihost.rank_zero`` call, which runs on rank 0 alone, this process."""
    if multihost.in_rank_zero():
        return Mesh({"data": 1})
    if _active_mesh is not None:
        return _active_mesh
    return make_data_mesh()


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Override the default mesh within a scope."""
    global _active_mesh
    prev = _active_mesh
    _active_mesh = mesh
    try:
        yield mesh
    finally:
        _active_mesh = prev


def data_sharding(
    mesh: Mesh, n: int, axis: Optional[str] = None, turn: int = 0
) -> tuple[int, int]:
    """This rank's ``[lo, hi)`` of an array axis of length ``n`` split over
    the mesh axis ``axis``, or over every mesh axis (``None``, row-major).

    The split is the same on every rank and covers every index once: each
    part has ``n // parts`` indices and the leading ``n % parts`` one more,
    so a rank may get none. ``turn`` rotates the parts over the ranks (part
    ``i`` to rank ``(i + turn) mod parts``): a caller that splits many
    small batches passes its batch count, so that their remainders do not
    all land on the first ranks.
    """
    if axis is None:
        parts, index = mesh.size, mesh.rank
    else:
        parts, index = mesh.shape[axis], mesh.coordinate(axis)
    index = (index - turn) % parts
    base, extra = divmod(n, parts)
    lo = index * base + min(index, extra)
    return lo, lo + base + (1 if index < extra else 0)
