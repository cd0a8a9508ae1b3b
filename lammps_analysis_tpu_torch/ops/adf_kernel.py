"""Wrappers of the two CUDA ADF kernels.

``neighbor_extract`` wraps ``csrc/adf_neighbor_extract.cu`` (counterpart of
``lammps_analysis_tpu/ops/pallas_adf.py::_neighbor_extract_pallas``) and
``adf_pairs_histogram`` wraps ``csrc/adf_pairs_histogram.cu`` (counterpart of
``adf_pairs_histogram_pallas`` with ``fold=True``). Each checks its inputs,
then launches its kernel on CUDA tensors or runs its plain torch version
(``ops/adf.py``) on CPU tensors; a CUDA tensor never falls back. The kernel
library builds from the checkout's sources at first use (``_build.py``).

``neighbor_extract.launches`` and ``adf_pairs_histogram.launches`` count the
kernel launches made through each wrapper.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .adf import (
    adf_pairs_histogram_reference,
    bin_scale,
    n_triples_for,
    neighbor_extract_reference,
)
from .geometry import box_scalars

#: widest neighbor list the angle kernel stages (8 warps x 5 x K x 4 bytes
#: of shared memory must fit a block's opt-in)
MAX_K = 1024


def _library() -> ctypes.CDLL:
    lib = _build.load_library()
    lib.adf_neighbor_extract_launch.argtypes = (
        [ctypes.c_void_p] * 8
        + [ctypes.c_int64] * 4
        + [ctypes.c_float] * 7
        + [ctypes.c_void_p]
    )
    lib.adf_neighbor_extract_launch.restype = ctypes.c_int
    lib.adf_pairs_histogram_launch.argtypes = (
        [ctypes.c_void_p] * 8
        + [ctypes.c_int64] * 6
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.adf_pairs_histogram_launch.restype = ctypes.c_int
    lib.adf_pairs_histogram_uses_shared.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.adf_pairs_histogram_uses_shared.restype = ctypes.c_int
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


def neighbor_extract(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    k_n: int,
    n_species: int,
):
    """Per-center neighbor lists ``(rx, ry, rz, d, sid, counts)``.

    ``positions`` ``(F, N, 3)`` float32 contiguous, ``species_id`` ``(N,)``
    int32 (outside ``[0, n_species)`` is padding), ``box`` 3 edge lengths.
    The contract is ``ops/adf.py::neighbor_extract_reference``'s: ``(F, N,
    k_n)`` lists in ascending neighbor order, empty slots 0 and sid -1, and
    ``counts`` ``(F, N)`` int32 the true in-cutoff count (above ``k_n`` the
    list is cut: the caller retries with a larger K).
    """
    if not isinstance(positions, torch.Tensor):
        raise TypeError("positions must be a torch tensor")
    if positions.dim() != 3 or positions.shape[2] != 3:
        raise ValueError(f"positions must have shape (F, N, 3), got {tuple(positions.shape)}")
    n_frames, n_atoms, _ = positions.shape
    device = positions.device
    _check_tensor("positions", positions, torch.float32, positions.shape, device)
    _check_tensor("species_id", species_id, torch.int32, (n_atoms,), device)
    if not cutoff > 0 or k_n < 1 or n_species < 1:
        raise ValueError(
            f"need cutoff > 0, k_n >= 1, n_species >= 1; got {cutoff}, {k_n}, {n_species}"
        )
    if n_atoms >= 2**31:
        raise ValueError(f"{n_atoms} atoms: the kernel indexes atoms with int32")
    if device.type == "cpu":
        return neighbor_extract_reference(
            positions, species_id, box, cutoff, k_n, n_species
        )
    _check_device(device)
    (bx, by, bz), (ibx, iby, ibz) = box_scalars(box, "the neighbor extract")
    lists = [
        torch.empty((n_frames, n_atoms, k_n), dtype=torch.float32, device=device)
        for _ in range(4)
    ]
    sid_n = torch.empty((n_frames, n_atoms, k_n), dtype=torch.int32, device=device)
    counts = torch.empty((n_frames, n_atoms), dtype=torch.int32, device=device)
    if n_frames == 0 or n_atoms == 0:
        return (*lists, sid_n, counts)
    lib = _library()
    with torch.cuda.device(device):
        err = lib.adf_neighbor_extract_launch(
            positions.data_ptr(), species_id.data_ptr(),
            *(t.data_ptr() for t in lists), sid_n.data_ptr(), counts.data_ptr(),
            n_frames, n_atoms, n_species, k_n,
            bx, by, bz, ibx, iby, ibz, float(np.float32(cutoff)),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(err, lib, "adf_neighbor_extract")
    neighbor_extract.launches += 1
    return (*lists, sid_n, counts)


neighbor_extract.launches = 0


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
    ``ops/adf.py::adf_pairs_histogram_reference``'s; the kernel adds its
    float32 weights with atomics, so sums agree up to their order.
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
    if k_n > MAX_K:
        raise ValueError(
            f"neighbor lists of width {k_n}: the angle kernel stages at most "
            f"{MAX_K} neighbors per center in shared memory"
        )
    n_triples = n_triples_for(n_species)
    out = torch.zeros((n_frames, n_triples, n_bins), dtype=torch.float32, device=device)
    if n_frames == 0 or n_atoms == 0 or k_n < 2:
        return out
    lib = _library()
    with torch.cuda.device(device):
        err = lib.adf_pairs_histogram_launch(
            rx.data_ptr(), ry.data_ptr(), rz.data_ptr(), d.data_ptr(),
            sid_n.data_ptr(), counts.data_ptr(), sid_c.data_ptr(), out.data_ptr(),
            n_frames, n_atoms, k_n, n_species, n_bins, int(norm_power),
            bin_scale(n_bins), torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(err, lib, "adf_pairs_histogram")
    adf_pairs_histogram.launches += 1
    return out


adf_pairs_histogram.launches = 0


def pairs_histogram_uses_shared(n_species: int, n_bins: int, k_n: int) -> bool:
    """Whether the angle kernel keeps this histogram in shared memory (CUDA only)."""
    n_total = n_triples_for(n_species) * n_bins
    flag = _library().adf_pairs_histogram_uses_shared(n_total, k_n)
    if flag < 0:
        raise RuntimeError(
            f"could not size the angle kernel's shared memory (code {flag})"
        )
    return bool(flag)
