"""Wrapper of the CUDA pair-distance histogram kernel (``csrc/rdf_histogram.cu``).

Counterpart of ``lammps_analysis_tpu/ops/pallas_rdf.py::rdf_histogram_pallas``.
``rdf_histogram`` checks its inputs, then runs the kernel on a CUDA tensor or
the plain torch version (``ops/rdf.py::rdf_histogram_reference``) on a CPU
tensor; a CUDA tensor never falls back to the plain version. The kernel
library builds from the checkout's sources at first use (``_build.py``).

Each call runs in the span ``k1``; the counter ``k1.launches``
(``utils/profiling.py``) counts the kernel launches, so a run can show that
it went through the kernel, ``k1.layout.<layout>`` counts them by where
the kernel kept its counts (``LAYOUTS``), and ``k1.pair_rows`` adds each
launch's species-pair rows of the histogram.

The kernel takes its in-box sequences (the minimum image and the bin on the
FP32 and ALU pipes, ``csrc/rdf_histogram.cu``) wherever every atom of a
warp's tile and j-chunk lies within one box edge of the origin, and its
general ones elsewhere. Where they all lie in ``[0, box]`` and ``folds``
holds, it folds the minimum image as well: ``min(|dx|, box - |dx|)``. It
adds the j-chunk sweeps that took the general sequences, and those that
took the in-box ones unfolded, into two int64 words per device, which the
wrapper allocates at the first launch there and never clears:
``general_sweeps(device)`` and ``unfolded_sweeps(device)`` read them (they
synchronise: for tests and ``chip_spans.py``, never the call path), and
readers take differences. Wrapped coordinates, in ``[0, box)``, under a
cutoff below half the smallest edge, take neither.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..utils import profiling
from .geometry import squared_cutoff
from .rdf import rdf_histogram_reference, rdf_scalars

#: i-atoms per tile; must equal ``kTile`` in ``csrc/rdf_histogram.cu``
TILE = 128

#: where the kernel keeps its counts, by ``rdf_histogram_layout``'s code (the
#: shared-memory copies a block; 0: atomics into device memory): the name
#: ``histogram_mode`` gives and the counter's suffix
LAYOUTS = {
    8: ("warp", "c8"),
    4: ("shared4", "c4"),
    2: ("shared2", "c2"),
    1: ("block", "c1"),
    0: ("global", "global"),
}


class Layout(NamedTuple):
    """The kernel's layout for a histogram on the current device."""

    mode: str  #: ``LAYOUTS`` name
    copies: int  #: shared-memory copies a block, 0 for global atomics
    blocks_per_sm: int  #: blocks resident on an SM (8 warps each)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library()
    lib.rdf_histogram_launch.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int64] * 6
        + [ctypes.c_float] * 8
        + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.rdf_histogram_launch.restype = ctypes.c_int
    lib.rdf_histogram_layout.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
    lib.rdf_histogram_layout.restype = ctypes.c_int
    lib.rdf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rdf_cuda_error_string.restype = ctypes.c_char_p
    return lib


#: the sweep words of each CUDA device, by device index: the general sweeps,
#: then the unfolded ones
_sweep_words: dict[int, torch.Tensor] = {}
_sweep_words_lock = threading.Lock()


def _device_index(device) -> int:
    device = torch.device(device)
    return device.index if device.index is not None else torch.cuda.current_device()


def _sweep_words_of(device: torch.device) -> torch.Tensor:
    index = _device_index(device)
    with _sweep_words_lock:
        if index not in _sweep_words:
            _sweep_words[index] = torch.zeros(2, dtype=torch.int64, device=device)
        return _sweep_words[index]


def _sweeps(device, which: int) -> int:
    words = _sweep_words.get(_device_index(device))
    if words is None:
        return 0
    torch.cuda.synchronize(device)
    return int(words[which].item())


def general_sweeps(device="cuda") -> int:
    """The j-chunk sweeps of K1's warps on ``device`` that took the general
    sequences since the process began (0 before the first launch there).
    Synchronises the device."""
    return _sweeps(device, 0)


def unfolded_sweeps(device="cuda") -> int:
    """The j-chunk sweeps of K1's warps on ``device`` that took the in-box
    sequences without the fold since the process began: their atoms lay
    within one box edge of the origin but not all in ``[0, box]``, or
    ``folds`` did not hold. Synchronises the device."""
    return _sweeps(device, 1)


def folds(box, cutoff: float, n_bins: int) -> bool:
    """Whether K1 may fold the minimum image of a histogram with these 3
    box edges, cutoff and bins.

    On the edges and cutoff rounded to float32, as the kernel gets them: the
    cutoff at most ``(1 - 2^-16)`` times half the smallest edge, every edge
    in ``[2^-60, 2^100]`` and ``n_bins <= 2^22``. Folding picks ``|dx|`` or
    ``box - |dx|`` otherwise than the rounded minimum image only where both
    lie within a few ulps of half the edge; under this cutoff the
    component's square alone then exceeds the threshold, so the pair is
    rejected either way. The lower edge keeps that square a normal float.
    """
    edges = [float(np.float32(b)) for b in box]
    cut = float(np.float32(cutoff))
    return (
        n_bins <= 2**22
        and all(2.0**-60 <= b <= 2.0**100 for b in edges)
        and cut <= (1 - 2.0**-16) * min(edges) / 2
    )


def _check(positions, species_id, box, cutoff, n_bins, n_species) -> None:
    if not isinstance(positions, torch.Tensor) or not isinstance(
        species_id, torch.Tensor
    ):
        raise TypeError("positions and species_id must be torch tensors")
    if positions.dtype != torch.float32:
        raise TypeError(f"positions must be float32, got {positions.dtype}")
    if positions.dim() != 3 or positions.shape[2] != 3:
        raise ValueError(
            f"positions must have shape (F, N, 3), got {tuple(positions.shape)}"
        )
    if species_id.dtype != torch.int32:
        raise TypeError(f"species_id must be int32, got {species_id.dtype}")
    if species_id.shape != (positions.shape[1],):
        raise ValueError(
            f"species_id must have shape ({positions.shape[1]},), got "
            f"{tuple(species_id.shape)}"
        )
    if species_id.device != positions.device:
        raise ValueError(
            f"positions on {positions.device} but species_id on {species_id.device}"
        )
    if not (positions.is_contiguous() and species_id.is_contiguous()):
        raise ValueError("positions and species_id must be contiguous")
    if box is None:
        raise ValueError("box is required: the histogram applies the minimum image")
    if not cutoff > 0 or n_bins < 1 or n_species < 1:
        raise ValueError(
            f"need cutoff > 0, n_bins >= 1, n_species >= 1; got {cutoff}, "
            f"{n_bins}, {n_species}"
        )
    if n_bins / cutoff >= 2**40:
        raise ValueError(
            f"n_bins / cutoff = {n_bins / cutoff}: the kernel bins squared "
            "distances below 2^-100 as 0, which needs n_bins / cutoff < 2^40"
        )
    if TILE * (positions.shape[1] + TILE) >= 2**32:
        raise ValueError(
            f"{positions.shape[1]} atoms: one block's count ({TILE} * (N + {TILE})) "
            "would overflow the kernel's uint32 shared-memory bins"
        )


def rdf_histogram(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    n_bins: int,
    n_species: int,
    rows=None,
) -> torch.Tensor:
    """Per-species-pair distance histograms, ``(n_pairs, n_bins)`` int64.

    ``positions`` ``(F, N, 3)`` float32 contiguous, species concatenated;
    ``species_id`` ``(N,)`` int32 with -1 for padding; ``box`` 3 edge lengths.
    Each pair j > i with both species in ``[0, n_species)`` (anything else
    counts as padding) and minimum-image distance below
    ``cutoff`` counts once, in bin ``min(floor(d * n_bins / cutoff),
    n_bins - 1)`` of pair ``(min(s_i, s_j), max(s_i, s_j))``.

    ``rows=(i0, i1)`` counts only the pairs whose first atom lies in the
    stripe ``i0 <= i < i1``, against every j > i (the global triangle): the
    i-rows of one rank of ``sharded_rdf_histogram_2d``. Stripes that cover
    ``[0, N)`` add up to the full histogram exactly; the kernel launches only
    the stripe's i-tiles.
    """
    with profiling.annotate("k1"):
        _check(positions, species_id, box, cutoff, n_bins, n_species)
        n_frames, n_atoms, _ = positions.shape
        r0, r1 = (0, n_atoms) if rows is None else (int(rows[0]), int(rows[1]))
        if not 0 <= r0 <= r1 <= n_atoms:
            raise ValueError(f"rows must satisfy 0 <= i0 <= i1 <= {n_atoms}, got {rows}")
        if positions.device.type == "cpu":
            return rdf_histogram_reference(
                positions, species_id, box, cutoff, n_bins, n_species, rows=(r0, r1)
            )
        if positions.device.type != "cuda":
            raise ValueError(f"no kernel for device {positions.device}")
        (bx, by, bz), (ibx, iby, ibz), cut, inv_bin = rdf_scalars(box, cutoff, n_bins)
        threshold = squared_cutoff(cut)
        n_pairs = n_species * (n_species + 1) // 2
        out = torch.zeros((n_pairs, n_bins), dtype=torch.int64, device=positions.device)
        if n_frames == 0 or r0 == r1:
            return out
        lib = _library()
        with torch.cuda.device(positions.device):
            copies = lib.rdf_histogram_layout(n_pairs * n_bins, None)
            if copies < 0:
                raise RuntimeError("rdf_histogram: could not query the device's occupancy")
            words = _sweep_words_of(positions.device)
            err = lib.rdf_histogram_launch(
                positions.data_ptr(), species_id.data_ptr(), out.data_ptr(),
                words[0].data_ptr(), words[1].data_ptr(),
                n_frames, n_atoms, n_species, n_bins, r0, r1,
                bx, by, bz, ibx, iby, ibz, threshold, inv_bin,
                int(folds((bx, by, bz), cut, n_bins)),
                torch.cuda.current_stream(positions.device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(
                f"rdf_histogram kernel launch failed: CUDA error {err} "
                f"({lib.rdf_cuda_error_string(err).decode()})"
            )
        profiling.count("k1.launches")
        profiling.count(f"k1.layout.{LAYOUTS[copies][1]}")
        profiling.count("k1.pair_rows", n_pairs)
        return out


def histogram_layout(n_species: int, n_bins: int) -> Layout:
    """Where the kernel keeps this histogram on the current CUDA device (CUDA
    only): of the shared-memory copies a block (8, 4, 2, 1) that fit its
    opt-in, the one that leaves the most warps resident on an SM, by the
    runtime's occupancy calculator, ties to more copies; global atomics when
    not even one copy fits."""
    n_total = n_species * (n_species + 1) // 2 * n_bins
    blocks = ctypes.c_int(0)
    copies = _library().rdf_histogram_layout(n_total, ctypes.byref(blocks))
    if copies < 0:
        raise RuntimeError("could not query the device's occupancy")
    return Layout(LAYOUTS[copies][0], copies, blocks.value)


def histogram_mode(n_species: int, n_bins: int) -> str:
    """The name of ``histogram_layout``: ``"warp"`` (one shared-memory
    histogram per warp), ``"shared4"``, ``"shared2"`` (one per 2 or 4 warps),
    ``"block"`` (one per block) or ``"global"`` (atomics into device
    memory)."""
    return histogram_layout(n_species, n_bins).mode
