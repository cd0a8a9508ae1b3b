"""Wrappers of the three CUDA ADF kernels, and the neighbor extract's route.

The neighbor extract (counterpart of
``lammps_analysis_tpu/ops/pallas_adf.py::_neighbor_extract_pallas``) has three
routes:

* ``neighbor_extract_binned`` wraps ``csrc/adf_neighbor_cells.cu``: cell
  lists, 27 neighbor cells per center;
* ``neighbor_extract_sweep`` wraps ``csrc/adf_neighbor_extract.cu``: every
  center against every atom, under the minimum image or, with ``box=None``,
  open boundaries; it stages each center's kept slots in shared memory and
  writes them a whole 128-byte line at a time, so ``_empty_lists`` starts
  every output on a 128-byte boundary;
* ``sorted_neighbor_extract`` runs the same kernel in its window mode on
  frames sorted in space (``ops/sorting.py``; counterpart of
  ``sorted_neighbor_extract``, ``pallas_adf.py:1214``): each group of
  ``sorting.BLOCK_CENTERS`` centers tests only its window's atoms. Its lists
  come in sorted center order, with the sorted frames' ids beside them.

The first two share one contract, ``ops/adf.py::neighbor_extract_reference``'s,
and may add the neighbors' atom indices (``with_idx``; the TPU kernel's
``lean=False``). ``neighbor_extract`` takes the binned route or the sweep, as
``extract_route`` names them, a pure function of the shapes; where it names
the sorted route, whose rows are not in atom order, ``neighbor_extract``
sweeps, and the callers that take any center order (``adf_histogram``,
``parallel/sharded_ops.py``) sort. Both routes take ``centers=(c0, c1)``: the
lists of one stripe of centers, by atom index, against every atom (the stage 1
of ``parallel/sharded_ops.py::sharded_adf_histogram_2d``; the TPU kernel's
``centers=`` mode, ``pallas_adf.py:232``). The counterparts of the JAX
package's entry points are ``neighbor_indices`` (``neighbor_indices_pallas``
:1395), ``neighbor_lists`` and ``neighbor_components``
(``pallas_neighbor_lists`` :1422, ``pallas_neighbor_components`` :1449) and
``adf_histogram`` (``adf_histogram_pallas`` :2173). ``adf_pairs_histogram`` wraps
``csrc/adf_pairs_histogram.cu`` (counterpart of ``adf_pairs_histogram_pallas``
with ``fold=True``); ``pairs_split`` (pure) cuts each center's pairs into
chunks and sizes the grid, and ``pairs_histogram_route`` reports what a
launch does. Each wrapper checks its inputs, then launches its kernel
on CUDA tensors or runs the plain torch version (``ops/adf.py``) on CPU
tensors; a CUDA tensor never falls back. The kernel library builds from the
checkout's sources at first use (``_build.py``).

Each wrapper runs in a span, ``k2.<route>`` (``binned``, ``sweep``, ``z``,
``brick``) or ``k3``, and counts its kernel launches in
``utils/profiling.py``'s counters: ``k2.launches.<route>`` and ``k3.launches``,
and ``k2.launches.open`` and ``k2.launches.idx.<route>`` those of K2 in a
mode; the lists' allocation is the span ``adf.empty_lists``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..utils import profiling
from . import sorting
from .adf import (
    adf_pairs_histogram_reference,
    bin_scale,
    n_triples_for,
    neighbor_extract_reference,
    sorted_neighbor_extract_reference,
)
from .cells import cell_lists_applicable, cells_per_axis
from .geometry import box_scalars, squared_cutoff

#: widest neighbor list the binned route stages (``kMaxK`` in
#: ``csrc/adf_neighbor_cells.cu``: 4 warps x 16 centers x K ints of shared memory)
BINNED_MAX_K = 512
#: atoms from which the sorted route sorts by (z-slab, y) and below which by z
#: (the JAX package's measured switch, ``parallel/sharded_ops.py:327-334``)
BRICK_MIN_ATOMS = 16384


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library()
    lib.adf_neighbor_extract_launch.argtypes = (
        [ctypes.c_void_p] * 9
        + [ctypes.c_int64] * 8
        + [ctypes.c_void_p]
        + [ctypes.c_int64] * 2
        + [ctypes.c_void_p]
        + [ctypes.c_float] * 7
        + [ctypes.c_void_p]
    )
    lib.adf_neighbor_extract_launch.restype = ctypes.c_int
    for fn in (lib.adf_neighbor_extract_arc_centers, lib.adf_neighbor_extract_chunk_atoms):
        fn.argtypes, fn.restype = [], ctypes.c_int
    shape = (lib.adf_neighbor_extract_arc_centers(), lib.adf_neighbor_extract_chunk_atoms())
    if shape != (sorting.BLOCK_CENTERS, sorting.CHUNK_ATOMS):
        raise RuntimeError(
            f"the sweep kernel's (centers an arc list serves, chunk atoms) {shape} differ from ops/sorting.py's "
            f"{(sorting.BLOCK_CENTERS, sorting.CHUNK_ATOMS)}"
        )
    lib.adf_neighbor_cells_launch.argtypes = (
        [ctypes.c_void_p] * 11
        + [ctypes.c_int64] * 9
        + [ctypes.c_float] * 7
        + [ctypes.c_void_p]
    )
    lib.adf_neighbor_cells_launch.restype = ctypes.c_int
    lib.adf_neighbor_cells_scratch_ints.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.adf_neighbor_cells_scratch_ints.restype = ctypes.c_int64
    lib.adf_pairs_histogram_launch.argtypes = (
        [ctypes.c_void_p] * 9
        + [ctypes.c_int64] * 6
        + [ctypes.c_float]
        + [ctypes.c_int64] * 3
        + [ctypes.c_void_p]
    )
    lib.adf_pairs_histogram_launch.restype = ctypes.c_int
    lib.adf_pairs_histogram_shape.argtypes = [ctypes.c_int64] + [ctypes.POINTER(ctypes.c_int)] * 4
    lib.adf_pairs_histogram_shape.restype = ctypes.c_int
    lib.rdf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rdf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_tensor(name, t, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_device(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({lib.rdf_cuda_error_string(err).decode()})"
        )


def sort_for(n_atoms: int) -> str:
    """The sorted route's sort for ``n_atoms``: ``"brick"`` from
    ``BRICK_MIN_ATOMS`` on, ``"z"`` below."""
    return "brick" if n_atoms >= BRICK_MIN_ATOMS else "z"


def extract_route(box, cutoff: float, k_n: int, n_atoms: int) -> str:
    """``"binned"``, ``"sorted"`` or ``"sweep"``: the neighbor extract's route
    for this shape.

    The sweep for open boundaries (``box=None``). Binned when the box holds
    three or more cells on every axis (``ops/cells.py``) and K is at most
    ``BINNED_MAX_K``. Else sorted when the z window's bound
    (``ops/sorting.py::window_chunk_bound``, from ``2.1 cutoff / L_z``) is
    narrower than the whole frame; the sweep otherwise.
    """
    if box is None:
        return "sweep"
    if k_n <= BINNED_MAX_K and cell_lists_applicable(box, cutoff):
        return "binned"
    if sorting.window_chunk_bound(n_atoms, box, cutoff) < -(-n_atoms // sorting.CHUNK_ATOMS):
        return "sorted"
    return "sweep"


def _check_extract(positions, species_id, cutoff, k_n, n_species, centers=None) -> tuple:
    """Checks the extract's inputs; returns the stripe ``(c0, c1)``."""
    if not isinstance(positions, torch.Tensor):
        raise TypeError("positions must be a torch tensor")
    if positions.dim() != 3 or positions.shape[2] != 3:
        raise ValueError(f"positions must have shape (F, N, 3), got {tuple(positions.shape)}")
    device = positions.device
    _check_tensor("positions", positions, torch.float32, positions.shape, device)
    _check_tensor("species_id", species_id, torch.int32, (positions.shape[1],), device)
    if not cutoff > 0 or k_n < 1 or n_species < 1:
        raise ValueError(
            f"need cutoff > 0, k_n >= 1, n_species >= 1; got {cutoff}, {k_n}, {n_species}"
        )
    if positions.shape[1] >= 2**31:
        raise ValueError(f"{positions.shape[1]} atoms: the kernels index atoms with int32")
    n_atoms = positions.shape[1]
    c0, c1 = (0, n_atoms) if centers is None else (int(centers[0]), int(centers[1]))
    if not 0 <= c0 <= c1 <= n_atoms:
        raise ValueError(f"centers must satisfy 0 <= c0 <= c1 <= {n_atoms}, got {centers}")
    return c0, c1


def _lines(n: int) -> int:
    """``n`` 4-byte elements rounded up to whole 128-byte lines."""
    return -(-n // 32) * 32


def _empty_lists(n_frames, n_rows, k_n, device, extra_floats=0, extra_ints=0):
    """``(rx, ry, rz, d, sid, counts)`` of ``n_rows`` centers uncleared, from
    two allocations, with ``extra_floats`` and ``extra_ints`` more of scratch.
    Each list and each scratch starts on a 128-byte boundary, where the sweep
    kernel writes whole lines."""
    size, rows = n_frames * n_rows * k_n, n_frames * n_rows
    stride = _lines(size)
    with profiling.annotate("adf.empty_lists"):
        floats = torch.empty(4 * stride + extra_floats, dtype=torch.float32, device=device)
        ints = torch.empty(stride + _lines(rows) + extra_ints, dtype=torch.int32, device=device)
    lists = [floats[f * stride : f * stride + size].view(n_frames, n_rows, k_n) for f in range(4)]
    sid_n = ints[:size].view(n_frames, n_rows, k_n)
    counts = ints[stride : stride + rows].view(n_frames, n_rows)
    return (*lists, sid_n, counts), floats[4 * stride :], ints[stride + _lines(rows) :]


@functools.lru_cache(maxsize=64)
def _extract_geometry(box: tuple | None, cutoff: float):
    """``(box, 1/box, squared-cutoff threshold, cells per axis)`` of a box
    given as a tuple of 3 floats; zeros and no cells for ``None`` (open
    boundaries)."""
    if box is None:
        return (0.0,) * 3, (0.0,) * 3, squared_cutoff(cutoff), None
    b, ib = box_scalars(box, "the neighbor extract")
    return b, ib, squared_cutoff(cutoff), cells_per_axis(b, cutoff)


def _box_key(box) -> tuple | None:
    """The box as a tuple of floats (``None`` stays), the cache key of
    ``_extract_geometry``."""
    if box is None:
        return None
    key = tuple(float(x) for x in np.asarray(box, dtype=np.float64).reshape(-1))
    if len(key) != 3:
        raise ValueError(f"box must hold 3 edge lengths, got {len(key)}")
    return key


def neighbor_extract(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    k_n: int,
    n_species: int,
    centers=None,
    with_idx: bool = False,
):
    """Per-center neighbor lists ``(rx, ry, rz, d, sid, counts)``, and
    ``idx`` after them with ``with_idx``.

    ``positions`` ``(F, N, 3)`` float32 contiguous, ``species_id`` ``(N,)``
    int32 (outside ``[0, n_species)`` is padding), ``box`` 3 edge lengths or
    ``None`` for open boundaries. The contract is
    ``ops/adf.py::neighbor_extract_reference``'s: ``(F, N, k_n)`` lists in
    ascending neighbor order, empty slots 0 and sid -1 (idx -1), and
    ``counts`` ``(F, N)`` int32 the true in-cutoff count (above ``k_n`` the
    list is cut: the caller retries with a larger K). On CUDA tensors the
    route is ``extract_route``'s, the sweep where that is the sorted route.

    ``centers=(c0, c1)`` lists only the centers ``c0 <= i < c1`` against
    every atom: ``(F, c1 - c0, k_n)`` lists whose row ``i - c0`` equals row
    ``i`` of the full extract (the self pair is left out by global index).
    The stripe is by atom index, not by a spatial sort as in the JAX
    package: the angle histogram is the same for any partition of the
    centers, the stripe's center species are ``species_id[c0:c1]`` for every
    frame, and an index stripe of a well-mixed layout carries about the same
    work on every rank whatever the box's density profile.
    """
    _check_extract(positions, species_id, cutoff, k_n, n_species, centers)
    route = extract_route(_box_key(box), cutoff, k_n, positions.shape[1])
    extract = neighbor_extract_binned if route == "binned" else neighbor_extract_sweep
    return extract(positions, species_id, box, cutoff, k_n, n_species, centers, with_idx)


def _launch_sweep(positions, species_id, box, cutoff, k_n, n_species, c0, c1, with_idx,
                  arcs=None, bound=0):
    """One launch of the sweep kernel: the lists (and idx), and in the
    window mode (``arcs``) the overflow flag, a 0-d int32 tensor (else
    ``None``)."""
    device = positions.device
    (bx, by, bz), (ibx, iby, ibz), threshold, _ = _extract_geometry(_box_key(box), cutoff)
    n_frames, n_atoms, _ = positions.shape
    size = n_frames * (c1 - c0) * k_n
    out, _, ints = _empty_lists(n_frames, c1 - c0, k_n, device,
                                extra_ints=(size if with_idx else 0) + 1)
    idx = ints[:size].view(n_frames, c1 - c0, k_n) if with_idx else None
    overflow = ints[-1:].zero_() if arcs is not None else None
    outputs = (*out, idx) if with_idx else out
    if n_frames == 0 or c0 == c1:
        return outputs, overflow
    lib = _library()
    with torch.cuda.device(device):
        err = lib.adf_neighbor_extract_launch(
            positions.data_ptr(), species_id.data_ptr(), *(t.data_ptr() for t in out),
            idx.data_ptr() if with_idx else None,
            n_frames, n_atoms, n_species, k_n, c0, c1 - c0,
            n_atoms if species_id.dim() == 2 else 0, int(box is not None),
            arcs.data_ptr() if arcs is not None else None,
            arcs.shape[1] // 2 if arcs is not None else 0, bound,
            overflow.data_ptr() if arcs is not None else None,
            bx, by, bz, ibx, iby, ibz, threshold,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(err, lib, "adf_neighbor_extract")
    return outputs, overflow


def neighbor_extract_sweep(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    k_n: int,
    n_species: int,
    centers=None,
    with_idx: bool = False,
):
    """:func:`neighbor_extract` through the sweep kernel, on any box or with
    open boundaries (``box=None``); the grid covers the stripe's centers
    only."""
    c0, c1 = _check_extract(positions, species_id, cutoff, k_n, n_species, centers)
    with profiling.annotate("k2.sweep"):
        if positions.device.type == "cpu":
            return neighbor_extract_reference(
                positions, species_id, box, cutoff, k_n, n_species, (c0, c1), with_idx
            )
        _check_device(positions.device)
        outputs, _ = _launch_sweep(positions, species_id, box, cutoff, k_n, n_species, c0, c1,
                                   with_idx)
    if positions.shape[0] and c1 > c0:
        _count_extract("sweep", box is None, with_idx)
    return outputs


def _count_extract(route: str, open_box: bool, with_idx: bool) -> None:
    profiling.count(f"k2.launches.{route}")
    if open_box:
        profiling.count("k2.launches.open")
    if with_idx:
        profiling.count(f"k2.launches.idx.{route}")


def neighbor_extract_binned(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    k_n: int,
    n_species: int,
    centers=None,
    with_idx: bool = False,
):
    """:func:`neighbor_extract` through the cell-list kernel.

    Needs a periodic box with three or more cells on every axis and ``k_n <=
    BINNED_MAX_K`` on CUDA tensors (``ValueError`` otherwise); coordinates
    may lie in any image. A stripe bins every atom into the cells and lists
    the stripe's centers.
    """
    c0, c1 = _check_extract(positions, species_id, cutoff, k_n, n_species, centers)
    if box is None:
        raise ValueError("the binned extract needs a periodic box; box=None takes the sweep")
    with profiling.annotate("k2.binned"):
        if positions.device.type == "cpu":
            return neighbor_extract_reference(
                positions, species_id, box, cutoff, k_n, n_species, (c0, c1), with_idx
            )
        device = positions.device
        _check_device(device)
        (bx, by, bz), (ibx, iby, ibz), threshold, n_cells = _extract_geometry(
            _box_key(box), cutoff)
        if min(n_cells) < 3 or k_n > BINNED_MAX_K:
            raise ValueError(
                f"the binned extract needs >= 3 cells per axis and k_n <= {BINNED_MAX_K}; "
                f"got cells {n_cells} and k_n {k_n}: use the sweep"
            )
        n_frames, n_atoms, _ = positions.shape
        lib = _library()
        n_cells_all = n_cells[0] * n_cells[1] * n_cells[2]
        per_frame = lib.adf_neighbor_cells_scratch_ints(n_atoms, n_cells_all)
        size = n_frames * (c1 - c0) * k_n
        idx_ints = size if with_idx else 0
        # scratch: the cell-sorted atoms as float4, the per-frame ints (and idx first)
        out, sorted_atoms, ints = _empty_lists(
            n_frames, c1 - c0, k_n, device, 4 * n_frames * n_atoms, idx_ints + n_frames * per_frame
        )
        idx = ints[:size].view(n_frames, c1 - c0, k_n) if with_idx else None
        outputs = (*out, idx) if with_idx else out
        if n_frames == 0 or c0 == c1:
            return outputs
        with torch.cuda.device(device):
            err = lib.adf_neighbor_cells_launch(
                positions.data_ptr(), species_id.data_ptr(), *(t.data_ptr() for t in out),
                idx.data_ptr() if with_idx else None,
                ints[idx_ints:].data_ptr(), sorted_atoms.data_ptr(),
                n_frames, n_atoms, n_species, k_n, c0, c1 - c0, *n_cells,
                bx, by, bz, ibx, iby, ibz, threshold,
                torch.cuda.current_stream(device).cuda_stream,
            )
        _raise_on(err, lib, "adf_neighbor_cells")
        _count_extract("binned", False, with_idx)
        return outputs


def sorted_neighbor_extract(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    k_n: int,
    n_species: int,
    sort: str = "z",
    bound: int | None = None,
):
    """The sorted route: ``(rx, ry, rz, d, sid, counts, sid_sorted, overflow)``.

    Counterpart of ``sorted_neighbor_extract`` (``pallas_adf.py:1214``). Each
    frame is sorted in space by ``sort`` (``"z"``, or ``"brick"``: (z-slab,
    serpentine y); ``ops/sorting.py``), each block of centers gets the arcs of
    the sorted order that may hold its neighbors, and the sweep kernel tests
    those atoms only. The lists are ``neighbor_extract_reference``'s on the
    sorted frames: rows in sorted center order, slots in ascending sorted j,
    the same neighbor sets as the unsorted extract once the centers are
    permuted back (``sorting.spatial_sort``'s ``order``). ``sid_sorted``
    ``(F, N)`` int32 holds each frame's sorted ids, the center species of the
    rows. ``overflow`` (0-d int32) is 1 where some block's window covers more
    than ``bound`` chunks (``sorting.window_chunk_bound`` /
    ``brick_window_bound``; never with ``bound=None``): the lists are exact
    all the same, the window is swept whole, but the frames are far from the
    density the route was sized for, and the JAX contract has the caller
    repeat on the plain sweep (``parallel/sharded_ops.py::AdfBatchRunner``).
    Needs a periodic box.
    """
    _check_extract(positions, species_id, cutoff, k_n, n_species)
    if box is None:
        raise ValueError("the sorted route needs a periodic box; box=None takes the sweep")
    with profiling.annotate(f"k2.{sort}"):
        n_frames, n_atoms, _ = positions.shape
        limit = -(-n_atoms // sorting.CHUNK_ATOMS) if bound is None else int(bound)
        if positions.device.type == "cpu":
            *lists, sid_s = sorted_neighbor_extract_reference(
                positions, species_id, box, cutoff, k_n, n_species, sort
            )
            overflow = torch.zeros((), dtype=torch.int32)
            if bound is not None and n_frames:
                total = sorting.sort_frames(positions, species_id, n_species, box, cutoff, sort)[4]
                overflow = (total.max() > limit).to(torch.int32)
            return (*lists, sid_s, overflow)
        _check_device(positions.device)
        pos_s, sid_s, _, arcs, _ = sorting.sort_frames(
            positions, species_id, n_species, box, cutoff, sort
        )
        sid_s = sid_s.to(torch.int32)
        lists, overflow = _launch_sweep(pos_s, sid_s, box, cutoff, k_n, n_species, 0, n_atoms,
                                        False, arcs.contiguous(), limit)
        if n_frames and n_atoms:
            profiling.count(f"k2.launches.{sort}")
        return (*lists, sid_s, overflow.view(()))


def neighbor_indices(
    positions: torch.Tensor, species_id: torch.Tensor, box, cutoff: float, k_n: int,
    n_species: int,
) -> torch.Tensor:
    """``idx`` ``(F, N, k_n)`` int32: each center's in-cutoff neighbors' atom
    indices in ascending order, -1 in empty slots (counterpart of
    ``neighbor_indices_pallas``, ``pallas_adf.py:1395``); ``box=None`` for
    open boundaries. The route is :func:`neighbor_extract`'s."""
    return neighbor_extract(positions, species_id, box, cutoff, k_n, n_species,
                            with_idx=True)[6]


def neighbor_components(
    positions: torch.Tensor, species_id: torch.Tensor, box, cutoff: float, k_n: int,
    n_species: int,
):
    """``((rx, ry, rz), d, sid, sid_pad, max_count)``, the structure-of-arrays
    lists of :func:`neighbor_extract` (counterpart of
    ``pallas_neighbor_components``, ``pallas_adf.py:1449``): each ``(F, N,
    k_n)``, ``sid_pad`` the centers' species (the port pads no atoms:
    ``species_id`` itself) and ``max_count`` a 0-d int32 tensor, the largest
    true count (above ``k_n``: the lists are cut; the JAX kernel reports at
    most ``k_n``)."""
    rx, ry, rz, d, sid_n, counts = neighbor_extract(
        positions, species_id, box, cutoff, k_n, n_species
    )
    return (rx, ry, rz), d, sid_n, species_id, _max_count(counts)


def neighbor_lists(
    positions: torch.Tensor, species_id: torch.Tensor, box, cutoff: float, k_n: int,
    n_species: int,
):
    """``(r_n, d, sid, sid_pad, max_count)`` as :func:`neighbor_components`
    with the displacements stacked ``(F, N, k_n, 3)`` (counterpart of
    ``pallas_neighbor_lists``, ``pallas_adf.py:1422``)."""
    (rx, ry, rz), d, sid_n, sid_pad, max_count = neighbor_components(
        positions, species_id, box, cutoff, k_n, n_species
    )
    return torch.stack([rx, ry, rz], dim=-1), d, sid_n, sid_pad, max_count


def _max_count(counts: torch.Tensor) -> torch.Tensor:
    if counts.numel() == 0:
        return torch.zeros((), dtype=torch.int32, device=counts.device)
    return counts.max()


def frame_angle_histograms(
    positions, species_id, box, cutoff: float, k_n: int, n_species: int, n_bins: int,
    norm_power: int = 4, sort: str | None = None, bound: int | None = None, centers=None,
):
    """``(hists (F, n_triples, n_bins), counts, overflow)``: the neighbor
    extract, then the angle histogram of each frame. ``sort=None`` takes
    :func:`neighbor_extract` (its route; ``centers`` a stripe) and
    ``overflow`` is ``None``; ``sort="z"`` or ``"brick"`` the sorted route
    with ``bound``, each frame's angle histogram with its sorted center
    species (one launch a frame)."""
    if sort is None:
        *lists, counts = neighbor_extract(positions, species_id, box, cutoff, k_n, n_species,
                                          centers=centers)
        c0, c1 = (0, positions.shape[1]) if centers is None else centers
        return adf_pairs_histogram(*lists, counts, species_id[c0:c1], n_bins, n_species,
                                   norm_power), counts, None
    *lists, counts, sid_s, overflow = sorted_neighbor_extract(
        positions, species_id, box, cutoff, k_n, n_species, sort, bound
    )
    hists = [
        adf_pairs_histogram(*(t[f:f + 1] for t in lists), counts[f:f + 1], sid_s[f], n_bins,
                            n_species, norm_power)
        for f in range(positions.shape[0])
    ]
    if not hists:
        return torch.zeros((0, n_triples_for(n_species), n_bins), dtype=torch.float32,
                           device=positions.device), counts, overflow
    return torch.cat(hists), counts, overflow


def adf_histogram(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    n_bins: int,
    n_species: int,
    norm_power: int = 4,
    k_n: int = 128,
):
    """``(hist (n_triples, n_bins) float32, max_count)``: the angle histogram
    of the frames of ``positions``, summed (not density-normalised), and the
    largest true neighbor count, a 0-d int32 tensor (counterpart of
    ``adf_histogram_pallas``, ``pallas_adf.py:2173``).

    The neighbor extract takes ``extract_route``'s route (the sweep for
    ``box=None``; the sorted route with ``sort_for``'s sort and no bound),
    then the angle histogram. ``max_count > k_n`` means the lists were cut
    and the histogram under-counts: retry with a larger ``k_n`` (the JAX
    function reports ``k_n`` there).
    """
    _check_extract(positions, species_id, cutoff, k_n, n_species)
    n_atoms = positions.shape[1]
    sorted_route = extract_route(_box_key(box), cutoff, k_n, n_atoms) == "sorted"
    per_frame, counts, _ = frame_angle_histograms(
        positions, species_id, box, cutoff, k_n, n_species, n_bins, norm_power,
        sort_for(n_atoms) if sorted_route else None,
    )
    return per_frame.sum(0), _max_count(counts)


def adf_pairs_histogram(
    rx: torch.Tensor,
    ry: torch.Tensor,
    rz: torch.Tensor,
    d: torch.Tensor,
    sid_n: torch.Tensor,
    counts: torch.Tensor,
    sid_c: torch.Tensor,
    n_bins: int,
    n_species: int,
    norm_power: int = 4,
) -> torch.Tensor:
    """Per-frame angle histograms ``(F, n_triples, n_bins)`` float32.

    Lists as :func:`neighbor_extract` returns them, ``sid_c`` ``(N,)`` int32
    the center species. The contract is
    ``ops/adf.py::adf_pairs_histogram_reference``'s; the kernel sums the
    float32 weights in float64 as the plain version does, with atomics, so
    sums agree up to their order. On CUDA a call is two device operations: a
    memset of the float64 scratch and the kernel, split as
    ``pairs_histogram_route`` reports.
    """
    if not isinstance(rx, torch.Tensor):
        raise TypeError("rx must be a torch tensor")
    if rx.dim() != 3:
        raise ValueError(f"rx must have shape (F, N, K), got {tuple(rx.shape)}")
    n_frames, n_atoms, k_n = rx.shape
    device = rx.device
    for name, t in (("rx", rx), ("ry", ry), ("rz", rz), ("d", d)):
        _check_tensor(name, t, torch.float32, rx.shape, device)
    _check_tensor("sid_n", sid_n, torch.int32, rx.shape, device)
    _check_tensor("counts", counts, torch.int32, (n_frames, n_atoms), device)
    _check_tensor("sid_c", sid_c, torch.int32, (n_atoms,), device)
    if n_bins < 1 or n_species < 1 or int(norm_power) != norm_power or norm_power < 0:
        raise ValueError(
            f"need n_bins >= 1, n_species >= 1 and an integer norm_power >= 0; "
            f"got {n_bins}, {n_species}, {norm_power}"
        )
    with profiling.annotate("k3"):
        if device.type == "cpu":
            return adf_pairs_histogram_reference(
                rx, ry, rz, d, sid_n, counts, sid_c, n_bins, n_species, int(norm_power)
            )
        _check_device(device)
        shape = (n_frames, n_triples_for(n_species), n_bins)
        if n_frames == 0 or n_atoms == 0 or k_n < 2:
            return torch.zeros(shape, dtype=torch.float32, device=device)
        out = torch.empty(shape, dtype=torch.float32, device=device)
        # float64 sums, then one uint32 "blocks done" counter a frame; cleared by the launch
        scratch = torch.empty(out.numel() + (n_frames + 1) // 2, dtype=torch.float64, device=device)
        lib = _library()
        with torch.cuda.device(device):
            route = pairs_histogram_route(n_species, n_bins, k_n, n_atoms, n_frames)
            err = lib.adf_pairs_histogram_launch(
                rx.data_ptr(), ry.data_ptr(), rz.data_ptr(), d.data_ptr(),
                sid_n.data_ptr(), counts.data_ptr(), sid_c.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), n_frames, n_atoms, k_n, n_species, n_bins, int(norm_power),
                bin_scale(n_bins), route.chunk_pairs, route.chunks_per_center,
                route.blocks_per_frame, torch.cuda.current_stream(device).cuda_stream,
            )
        _raise_on(err, lib, "adf_pairs_histogram")
        profiling.count("k3.launches")
        return out


#: flat pairs of one work unit of the angle kernel: a center with more pairs
#: is cut into chunks of this many, which go to different warps and blocks
PAIRS_CHUNK = 1024


class PairsRoute(NamedTuple):
    """How the angle kernel runs one launch (``pairs_histogram_route``)."""

    histogram: str  # "shared" (a float64 histogram a block) or "global" (adds into the accumulator)
    chunk_pairs: int  # flat pairs of one unit
    chunks_per_center: int  # units of one center
    blocks_per_frame: int  # grid x; frames are grid y
    warps_per_block: int


def pairs_split(
    n_frames: int, n_atoms: int, k_n: int, resident_blocks: int, warps_per_block: int,
    chunk_pairs: int = PAIRS_CHUNK,
) -> tuple[int, int]:
    """``(chunks per center, blocks per frame)`` of the angle kernel.

    A center has up to ``K(K-1)/2`` pairs, cut into at least ``ceil(K(K-1)/2
    / chunk_pairs)`` units. The launch's frames share the ``resident_blocks``
    that the card holds at once (one wave; at least one block a frame, and no
    frame more blocks than it has units). The kernel deals unit ``center *
    chunks + chunk`` to warp ``unit mod warps``: the chunk count is raised to
    the next one prime to the frame's warps, so that the live chunks of
    narrow centers (the first few of each) spread over every warp.
    """
    pairs_k = k_n * (k_n - 1) // 2
    chunks = max(1, -(-pairs_k // chunk_pairs))
    blocks = max(1, resident_blocks // max(n_frames, 1))
    blocks = min(blocks, max(1, -(-n_atoms * chunks // warps_per_block)))
    while math.gcd(chunks, blocks * warps_per_block) != 1:
        chunks += 1
    return chunks, blocks


@functools.lru_cache(maxsize=64)
def _pairs_shape(n_total_bins: int, device_index: int) -> tuple[bool, int, int, int]:
    """``(histogram in shared memory, blocks an SM holds, SMs, warps a
    block)`` of the angle kernel on the device."""
    shared, per_sm, n_sms, warps = (ctypes.c_int() for _ in range(4))
    lib = _library()
    with torch.cuda.device(device_index):
        err = lib.adf_pairs_histogram_shape(
            n_total_bins, ctypes.byref(shared), ctypes.byref(per_sm), ctypes.byref(n_sms),
            ctypes.byref(warps),
        )
    _raise_on(err, lib, "adf_pairs_histogram (occupancy)")
    if per_sm.value < 1:
        raise RuntimeError(f"the angle kernel fits no SM with {n_total_bins} float64 bins")
    return bool(shared.value), per_sm.value, n_sms.value, warps.value


def pairs_histogram_route(
    n_species: int, n_bins: int, k_n: int, n_atoms: int, n_frames: int = 1
) -> PairsRoute:
    """What the angle kernel does for lists ``(n_frames, n_atoms, k_n)`` on
    the current CUDA device: where its float64 histogram lives (shared memory
    when ``n_triples * n_bins`` doubles fit a block's opt-in, else global
    memory) and how the pairs are split (``pairs_split`` over the blocks the
    card holds at once). Every K and every histogram size runs."""
    n_total = n_triples_for(n_species) * n_bins
    shared, per_sm, n_sms, warps = _pairs_shape(n_total, torch.cuda.current_device())
    chunks, blocks = pairs_split(n_frames, n_atoms, k_n, per_sm * n_sms, warps, PAIRS_CHUNK)
    return PairsRoute("shared" if shared else "global", PAIRS_CHUNK, chunks, blocks, warps)
