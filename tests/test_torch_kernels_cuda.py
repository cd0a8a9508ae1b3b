"""The CUDA pair-histogram kernel against its plain torch version, on a GPU.

Small versions of the kernel phase of ``chip_smoke.py``: the kernel
(``csrc/rdf_histogram.cu`` through ``ops/rdf_kernel.py``) must equal
``rdf_histogram_reference`` bin for bin on the same tensors on the card.
Marked ``cuda``; without a CUDA device every test skips. On a machine with a
card: ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from lammps_analysis_tpu_torch.ops import rdf_kernel
from lammps_analysis_tpu_torch.ops.rdf import build_species_layout, rdf_histogram_reference

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(counts, n_frames, box, seed, device):
    sid, n_pad, _, _, _ = build_species_layout(counts, pad_to=8)
    rng = np.random.default_rng(seed)
    pos = np.zeros((n_frames, n_pad, 3), np.float32)
    pos[:, : sum(counts)] = rng.uniform(0, 1, (n_frames, sum(counts), 3)) * np.asarray(box)
    return torch.from_numpy(pos).to(device), torch.from_numpy(sid).to(device)


@pytest.mark.parametrize(
    "counts, n_frames, box, cutoff, n_bins, shared",
    [
        ([640, 640], 2, (20.0, 20.0, 20.0), 9.9, 500, True),
        ([400, 350, 245], 3, (30.0, 33.0, 36.0), 9.9, 75, True),  # ragged, padded
        ([200, 200, 200, 200], 2, (16.0, 16.0, 16.0), 7.9, 6000, False),  # global path
        ([5], 1, (3.0, 3.0, 3.0), 1.45, 10, True),  # fewer atoms than one tile
    ],
    ids=["bench-like", "ragged", "global-atomics", "tiny"],
)
def test_kernel_matches_plain_bin_for_bin(cuda, counts, n_frames, box, cutoff, n_bins, shared):
    pos, sid = _case(counts, n_frames, box, seed=len(counts), device=cuda)
    args = (pos, sid, box, cutoff, n_bins, len(counts))
    assert rdf_kernel.uses_shared_histogram(len(counts), n_bins) == shared
    launches = rdf_kernel.launches
    h_kernel = rdf_kernel.rdf_histogram(*args)
    torch.cuda.synchronize()
    assert rdf_kernel.launches == launches + 1
    h_plain = rdf_histogram_reference(*args)
    assert h_kernel.dtype == torch.int64 and h_kernel.shape == h_plain.shape
    assert int(h_kernel.sum()) > 0
    assert torch.equal(h_kernel, h_plain)


def test_kernel_treats_out_of_range_species_as_padding(cuda):
    pos, sid = _case([100, 60], 2, (8.0, 8.0, 8.0), seed=3, device=cuda)
    sid[10:20] = 5  # not a species of a 2-species layout
    args = (pos, sid, (8.0, 8.0, 8.0), 3.9, 40, 2)
    assert torch.equal(rdf_kernel.rdf_histogram(*args), rdf_histogram_reference(*args))


def test_kernel_rejects_cpu_species_with_cuda_positions(cuda):
    pos, sid = _case([64], 1, (6.0, 6.0, 6.0), seed=1, device=cuda)
    with pytest.raises(ValueError, match="species_id on cpu"):
        rdf_kernel.rdf_histogram(pos, sid.cpu(), (6.0, 6.0, 6.0), 2.9, 10, 1)
