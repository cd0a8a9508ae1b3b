"""The neighbor extract's output layout, on the CPU.

The sweep kernel (``csrc/adf_neighbor_extract.cu``) writes each center's
slots a whole 128-byte line at a time, with line boundaries at multiples of
32 elements of each output; ``ops/adf_kernel.py::_empty_lists`` makes that
true by starting every list, the counts and every scratch on a 128-byte
boundary of its allocation. Here the layout is checked on CPU tensors: each
view's offset, shape and contiguity, and that no two views share an element.
"""

import pytest
import torch

from lammps_analysis_tpu_torch.ops import adf_kernel


def _span(t):
    return t.storage_offset(), t.storage_offset() + t.numel()


@pytest.mark.parametrize(
    "n_frames, n_rows, k_n, extra_floats, extra_ints",
    [
        (1, 10240, 88, 0, 1),  # the one-frame sweep with its overflow int
        (16, 10240, 88, 0, 16 * 10240 * 88 + 1),  # idx after the counts
        (2, 726, 33, 0, 2 * 726 * 33 + 1),  # rows of an odd K: lists not a multiple of 32
        (3, 5, 1, 0, 1),  # K = 1
        (2, 1000, 72, 4 * 2 * 1000, 2 * 1000 * 72 + 2 * 5000),  # binned: float4 atoms, idx, per frame
        (0, 100, 16, 0, 1),  # no frame
    ],
    ids=["one-frame", "idx", "odd-k", "k1", "binned-scratch", "empty"],
)
def test_every_list_starts_on_a_128_byte_line(n_frames, n_rows, k_n, extra_floats, extra_ints):
    (rx, ry, rz, d, sid_n, counts), floats, ints = adf_kernel._empty_lists(
        n_frames, n_rows, k_n, torch.device("cpu"), extra_floats, extra_ints
    )
    for t, dtype in ((rx, torch.float32), (ry, torch.float32), (rz, torch.float32),
                     (d, torch.float32), (sid_n, torch.int32)):
        assert t.dtype == dtype and t.shape == (n_frames, n_rows, k_n) and t.is_contiguous()
        assert t.storage_offset() % 32 == 0
    assert counts.shape == (n_frames, n_rows) and counts.storage_offset() % 32 == 0
    assert floats.numel() == extra_floats and floats.storage_offset() % 32 == 0
    assert ints.numel() == extra_ints and ints.storage_offset() % 32 == 0
    spans = sorted(_span(t) for t in (rx, ry, rz, d, floats))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    spans = sorted(_span(t) for t in (sid_n, counts, ints))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
