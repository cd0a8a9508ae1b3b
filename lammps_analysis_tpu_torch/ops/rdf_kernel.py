"""Wrapper of the CUDA pair-distance histogram kernel (``csrc/rdf_histogram.cu``).

Counterpart of ``lammps_analysis_tpu/ops/pallas_rdf.py::rdf_histogram_pallas``.
``rdf_histogram`` checks its inputs, then runs the kernel on a CUDA tensor or
the plain torch version (``ops/rdf.py::rdf_histogram_reference``) on a CPU
tensor; a CUDA tensor never falls back to the plain version. The kernel
library builds from the checkout's sources at first use (``_build.py``).

Each call runs in the span ``k1``; the counter ``k1.launches``
(``utils/profiling.py``) counts the kernel launches, so a run can show that
it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..utils import profiling
from .geometry import squared_cutoff
from .rdf import rdf_histogram_reference, rdf_scalars

#: i-atoms per tile; must equal ``kTile`` in ``csrc/rdf_histogram.cu``
TILE = 128

#: where the kernel keeps its counts, by ``rdf_histogram_mode``'s code
HISTOGRAM_MODES = ("warp", "block", "global")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library()
    lib.rdf_histogram_launch.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int64] * 6
        + [ctypes.c_float] * 8
        + [ctypes.c_void_p]
    )
    lib.rdf_histogram_launch.restype = ctypes.c_int
    lib.rdf_histogram_mode.argtypes = [ctypes.c_int64]
    lib.rdf_histogram_mode.restype = ctypes.c_int
    lib.rdf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rdf_cuda_error_string.restype = ctypes.c_char_p
    return lib


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
            err = lib.rdf_histogram_launch(
                positions.data_ptr(), species_id.data_ptr(), out.data_ptr(),
                n_frames, n_atoms, n_species, n_bins, r0, r1,
                bx, by, bz, ibx, iby, ibz, threshold, inv_bin,
                torch.cuda.current_stream(positions.device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(
                f"rdf_histogram kernel launch failed: CUDA error {err} "
                f"({lib.rdf_cuda_error_string(err).decode()})"
            )
        profiling.count("k1.launches")
        return out


def histogram_mode(n_species: int, n_bins: int) -> str:
    """Where the kernel keeps this histogram (CUDA only): ``"warp"`` (one
    shared-memory histogram per warp), ``"block"`` (one per block) or
    ``"global"`` (atomics into device memory), by what fits a block's
    shared-memory opt-in."""
    n_total = n_species * (n_species + 1) // 2 * n_bins
    code = _library().rdf_histogram_mode(n_total)
    if code < 0:
        raise RuntimeError("could not query the device's shared-memory limit")
    return HISTOGRAM_MODES[code]
