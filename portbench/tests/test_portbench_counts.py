"""The frozen work counts against hand-worked cases."""

import pytest
import torch

from portbench import peaks, spec

k1 = spec.load_module("counts", "k1")
k2 = spec.load_module("counts", "k2")
k3 = spec.load_module("counts", "k3")


def test_bound_takes_the_larger_of_the_two_peaks():
    assert peaks.bound_ms(67e12, 0) == (1e3, "operations")
    assert peaks.bound_ms(0, 3.35e12) == (1e3, "bytes")


def test_k1_counts_every_pair_of_every_frame():
    # 2 frames of 4 atoms: 12 pairs, 5 kept; 2 species, 10 bins
    work = dict(n_atoms=4, frames=2, kept=5, n_species=2, n_bins=10)
    ms, by = k1.bound(work)
    assert by == "bytes"
    assert ms == pytest.approx((2 * 4 * 12 + 4 * 4 + 3 * 10 * 8) / 3.35e12 * 1e3)
    work = dict(n_atoms=10**5, frames=10, kept=10**10, n_species=1, n_bins=10)
    ms, by = k1.bound(work)
    assert by == "operations"
    assert ms == pytest.approx((22 * 10 * 10**5 * (10**5 - 1) / 2 + 2e10) / 67e12 * 1e3)


def test_k2_tests_the_27_cell_neighborhoods():
    # box 12, cutoff 3: 4 cells a side; two atoms in cell (0,0,0), one in (2,2,2),
    # which is not a neighbor of it: 2 x 2 + 1 x 1 tests
    pos = torch.tensor([[[0.5, 0.5, 0.5], [1.0, 2.0, 0.2], [7.0, 7.0, 7.0]]])
    assert k2.needed_tests(pos, 12.0, 3.0) == 5
    # across the periodic seam: cell (3,0,0) neighbors (0,0,0)
    pos = torch.tensor([[[0.5, 0.5, 0.5], [11.5, 0.5, 0.5]]])
    assert k2.needed_tests(pos, 12.0, 3.0) == 4
    # fewer than 3 cells a side: every atom against every atom
    assert k2.needed_tests(torch.zeros((2, 5, 3)), 5.0, 3.0) == 2 * 5 * 5


def test_k2_bound_counts_lists_at_the_needed_width():
    pos = torch.tensor([[[0.5, 0.5, 0.5], [1.0, 2.0, 0.2], [7.0, 7.0, 7.0]]])
    work = dict(frames=[0], n_atoms=3, cutoff=3.0, kept=2, max_count=1)
    ms, by = k2.bound(work, pos, 12.0)
    assert by == "bytes"
    assert ms == pytest.approx((3 * 12 + 3 * 4 + 3 * (20 + 4)) / 3.35e12 * 1e3)


def test_k3_counts_binned_angles_and_species_tests():
    # one frame, 3 atoms of one species, each with 2 neighbors: 3 angles
    work = dict(frames=[0], n_atoms=3, n_species=1, n_bins=4, kept=6, angles=3.0,
                listed_pairs=3.0)
    ms, by = k3.bound(work)
    assert by == "bytes"
    assert ms == pytest.approx((6 * 20 + 3 * 4 + 3 * 4 + 4 * 4) / 3.35e12 * 1e3)
    work.update(angles=1e12, listed_pairs=1.5e12)
    ms, by = k3.bound(work)
    assert by == "operations"
    assert ms == pytest.approx((30 * 1e12 + 2 * 0.5e12) / 67e12 * 1e3)
