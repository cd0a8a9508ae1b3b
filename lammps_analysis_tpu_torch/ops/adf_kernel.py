"""Wrappers of the three CUDA ADF kernels, and the neighbor extract's route.

The neighbor extract (counterpart of
``lammps_analysis_tpu/ops/pallas_adf.py::_neighbor_extract_pallas``) has two
routes with one contract, ``ops/adf.py::neighbor_extract_reference``'s:

* ``neighbor_extract_binned`` wraps ``csrc/adf_neighbor_cells.cu``: cell
  lists, 27 neighbor cells per center;
* ``neighbor_extract_sweep`` wraps ``csrc/adf_neighbor_extract.cu``: every
  center against every atom.

``neighbor_extract`` takes the route that ``extract_route`` names, a pure
function of the shapes. Both routes take ``centers=(c0, c1)``: the lists of
one stripe of centers, by atom index, against every atom (the stage 1 of
``parallel/sharded_ops.py::sharded_adf_histogram_2d``; the TPU kernel's
``centers=`` mode, ``pallas_adf.py:232``). ``adf_pairs_histogram`` wraps
``csrc/adf_pairs_histogram.cu`` (counterpart of ``adf_pairs_histogram_pallas``
with ``fold=True``); ``pairs_split`` (pure) cuts each center's pairs into
chunks and sizes the grid, and ``pairs_histogram_route`` reports what a
launch does. Each wrapper checks its inputs, then launches its kernel
on CUDA tensors or runs the plain torch version (``ops/adf.py``) on CPU
tensors; a CUDA tensor never falls back. The kernel library builds from the
checkout's sources at first use (``_build.py``).

``neighbor_extract_binned.launches``, ``neighbor_extract_sweep.launches`` and
``adf_pairs_histogram.launches`` count the kernel launches made through each
wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .adf import (
    adf_pairs_histogram_reference,
    bin_scale,
    n_triples_for,
    neighbor_extract_reference,
)
from .cells import cell_lists_applicable, cells_per_axis
from .geometry import box_scalars, squared_cutoff

#: widest neighbor list the binned route stages (``kMaxK`` in
#: ``csrc/adf_neighbor_cells.cu``: 4 warps x 16 centers x K ints of shared memory)
BINNED_MAX_K = 512


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library()
    lib.adf_neighbor_extract_launch.argtypes = (
        [ctypes.c_void_p] * 8
        + [ctypes.c_int64] * 6
        + [ctypes.c_float] * 7
        + [ctypes.c_void_p]
    )
    lib.adf_neighbor_extract_launch.restype = ctypes.c_int
    lib.adf_neighbor_cells_launch.argtypes = (
        [ctypes.c_void_p] * 10
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


def extract_route(box, cutoff: float, k_n: int) -> str:
    """``"binned"`` or ``"sweep"``: the neighbor extract's route for this shape.

    Binned when the box holds three or more cells on every axis
    (``ops/cells.py``) and K is at most ``BINNED_MAX_K``; the sweep otherwise.
    """
    if k_n <= BINNED_MAX_K and cell_lists_applicable(box, cutoff):
        return "binned"
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


def _empty_lists(n_frames, n_rows, k_n, device, extra_floats=0, extra_ints=0):
    """``(rx, ry, rz, d, sid, counts)`` of ``n_rows`` centers uncleared, from
    two allocations, with ``extra_floats`` (16-byte aligned) and
    ``extra_ints`` more of scratch."""
    size = n_frames * n_rows * k_n
    floats = torch.empty(4 * size + extra_floats, dtype=torch.float32, device=device)
    ints = torch.empty(size + n_frames * n_rows + extra_ints, dtype=torch.int32, device=device)
    lists = floats[: 4 * size].view(4, n_frames, n_rows, k_n).unbind(0)
    sid_n = ints[:size].view(n_frames, n_rows, k_n)
    counts = ints[size : size + n_frames * n_rows].view(n_frames, n_rows)
    return (*lists, sid_n, counts), floats[4 * size :], ints[size + n_frames * n_rows :]


@functools.lru_cache(maxsize=64)
def _extract_geometry(box: tuple, cutoff: float):
    """``(box, 1/box, squared-cutoff threshold, cells per axis)`` of a box
    given as a tuple of 3 floats."""
    b, ib = box_scalars(box, "the neighbor extract")
    return b, ib, squared_cutoff(cutoff), cells_per_axis(b, cutoff)


def _box_key(box) -> tuple:
    """The box as a tuple of floats, the cache key of ``_extract_geometry``."""
    if box is None:
        raise ValueError(
            "the neighbor extract applies the minimum image and needs a periodic box; "
            "got box=None"
        )
    return tuple(float(x) for x in np.asarray(box, dtype=np.float64).reshape(-1))


def neighbor_extract(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    k_n: int,
    n_species: int,
    centers=None,
):
    """Per-center neighbor lists ``(rx, ry, rz, d, sid, counts)``.

    ``positions`` ``(F, N, 3)`` float32 contiguous, ``species_id`` ``(N,)``
    int32 (outside ``[0, n_species)`` is padding), ``box`` 3 edge lengths.
    The contract is ``ops/adf.py::neighbor_extract_reference``'s: ``(F, N,
    k_n)`` lists in ascending neighbor order, empty slots 0 and sid -1, and
    ``counts`` ``(F, N)`` int32 the true in-cutoff count (above ``k_n`` the
    list is cut: the caller retries with a larger K). On CUDA tensors the
    route is ``extract_route``'s.

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
    route = extract_route(_box_key(box), cutoff, k_n)
    extract = neighbor_extract_binned if route == "binned" else neighbor_extract_sweep
    return extract(positions, species_id, box, cutoff, k_n, n_species, centers)


def neighbor_extract_sweep(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    k_n: int,
    n_species: int,
    centers=None,
):
    """:func:`neighbor_extract` through the sweep kernel, on any box; the
    grid covers the stripe's centers only."""
    c0, c1 = _check_extract(positions, species_id, cutoff, k_n, n_species, centers)
    if positions.device.type == "cpu":
        return neighbor_extract_reference(
            positions, species_id, box, cutoff, k_n, n_species, (c0, c1)
        )
    device = positions.device
    _check_device(device)
    (bx, by, bz), (ibx, iby, ibz), threshold, _ = _extract_geometry(_box_key(box), cutoff)
    n_frames, n_atoms, _ = positions.shape
    out, _, _ = _empty_lists(n_frames, c1 - c0, k_n, device)
    if n_frames == 0 or c0 == c1:
        return out
    lib = _library()
    with torch.cuda.device(device):
        err = lib.adf_neighbor_extract_launch(
            positions.data_ptr(), species_id.data_ptr(), *(t.data_ptr() for t in out),
            n_frames, n_atoms, n_species, k_n, c0, c1 - c0,
            bx, by, bz, ibx, iby, ibz, threshold,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(err, lib, "adf_neighbor_extract")
    neighbor_extract_sweep.launches += 1
    return out


neighbor_extract_sweep.launches = 0


def neighbor_extract_binned(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    k_n: int,
    n_species: int,
    centers=None,
):
    """:func:`neighbor_extract` through the cell-list kernel.

    Needs three or more cells on every axis and ``k_n <= BINNED_MAX_K`` on
    CUDA tensors (``ValueError`` otherwise); coordinates may lie in any image.
    A stripe bins every atom into the cells and lists the stripe's centers.
    """
    c0, c1 = _check_extract(positions, species_id, cutoff, k_n, n_species, centers)
    if positions.device.type == "cpu":
        return neighbor_extract_reference(
            positions, species_id, box, cutoff, k_n, n_species, (c0, c1)
        )
    device = positions.device
    _check_device(device)
    (bx, by, bz), (ibx, iby, ibz), threshold, n_cells = _extract_geometry(_box_key(box), cutoff)
    if min(n_cells) < 3 or k_n > BINNED_MAX_K:
        raise ValueError(
            f"the binned extract needs >= 3 cells per axis and k_n <= {BINNED_MAX_K}; "
            f"got cells {n_cells} and k_n {k_n}: use the sweep"
        )
    n_frames, n_atoms, _ = positions.shape
    lib = _library()
    per_frame = lib.adf_neighbor_cells_scratch_ints(n_atoms, n_cells[0] * n_cells[1] * n_cells[2])
    # scratch: the cell-sorted atoms as float4, the per-frame ints
    out, sorted_atoms, ints = _empty_lists(
        n_frames, c1 - c0, k_n, device, 4 * n_frames * n_atoms, n_frames * per_frame
    )
    if n_frames == 0 or c0 == c1:
        return out
    with torch.cuda.device(device):
        err = lib.adf_neighbor_cells_launch(
            positions.data_ptr(), species_id.data_ptr(), *(t.data_ptr() for t in out),
            ints.data_ptr(), sorted_atoms.data_ptr(),
            n_frames, n_atoms, n_species, k_n, c0, c1 - c0, *n_cells,
            bx, by, bz, ibx, iby, ibz, threshold,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(err, lib, "adf_neighbor_cells")
    neighbor_extract_binned.launches += 1
    return out


neighbor_extract_binned.launches = 0


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
    adf_pairs_histogram.launches += 1
    return out


adf_pairs_histogram.launches = 0

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
