"""PyTorch port: K1's i-row range and K2's center stripe on the CPU.

The plain versions (and the wrappers' CPU route) of the two modes that the
2-D mesh runs: ``rdf_histogram(..., rows=(i0, i1))`` counts the pairs (i,
j > i) with ``i0 <= i < i1``, so stripes that cover ``[0, N)`` add up to the
full histogram exactly; ``neighbor_extract(..., centers=(c0, c1))`` lists
centers ``c0 .. c1 - 1`` against every atom, row ``i - c0`` equal to row
``i`` of the full extract, and the stripes' angle histograms add up to the
full one. Hypothesis draws the atom count and the cut points (empty stripes
included). The stripe is also held to the TPU kernel's own ``centers=``
mode (``pallas_adf.py::_neighbor_extract_pallas``, interpret mode): the same
neighbor set and count per center.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lammps_analysis_tpu.ops.pallas_adf import _neighbor_extract_pallas
from lammps_analysis_tpu_torch.ops import adf_kernel, rdf_kernel
from lammps_analysis_tpu_torch.ops.adf import (
    adf_pairs_histogram_reference,
    neighbor_extract_reference,
)
from lammps_analysis_tpu_torch.ops.rdf import rdf_histogram_reference

torch.set_num_threads(1)
BOX = (6.0, 6.0, 6.0)


def _system(n, seed, n_frames=2):
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.uniform(0, 6.0, (n_frames, n, 3)).astype(np.float32))
    sid = rng.choice(np.array([-1, 0, 1], np.int32), p=[0.1, 0.5, 0.4], size=n)
    return pos, torch.from_numpy(sid)


@st.composite
def stripes(draw, max_atoms=70):
    """``(n, [(lo, hi), ...])``: 1-6 stripes covering ``[0, n)``, some empty."""
    n = draw(st.integers(1, max_atoms))
    inner = sorted(draw(st.lists(st.integers(0, n), min_size=0, max_size=5)))
    edges = [0, *inner, n]
    return n, list(zip(edges[:-1], edges[1:]))


@settings(max_examples=30, deadline=None)
@given(case=stripes(), seed=st.integers(0, 2**16))
def test_row_stripes_add_up_to_the_full_histogram(case, seed):
    n, parts = case
    pos, sid = _system(n, seed)
    full = rdf_histogram_reference(pos, sid, BOX, 2.9, 30, 2, i_block=16)
    total = torch.zeros_like(full)
    for lo, hi in parts:
        stripe = rdf_kernel.rdf_histogram(pos, sid, BOX, 2.9, 30, 2, rows=(lo, hi))
        np.testing.assert_array_equal(
            stripe.numpy(),
            rdf_histogram_reference(pos, sid, BOX, 2.9, 30, 2, i_block=16, rows=(lo, hi)).numpy(),
        )
        total += stripe
    np.testing.assert_array_equal(total.numpy(), full.numpy())


@settings(max_examples=30, deadline=None)
@given(case=stripes(), seed=st.integers(0, 2**16), k_n=st.integers(1, 40))
def test_center_stripes_are_rows_of_the_full_extract(case, seed, k_n):
    n, parts = case
    pos, sid = _system(n, seed)
    full = neighbor_extract_reference(pos, sid, BOX, 2.5, k_n, 2)
    for lo, hi in parts:
        stripe = adf_kernel.neighbor_extract(pos, sid, BOX, 2.5, k_n, 2, centers=(lo, hi))
        for name, a, b in zip(("rx", "ry", "rz", "d", "sid", "counts"), stripe, full):
            assert a.shape == (2, hi - lo) + b.shape[2:], name
            np.testing.assert_array_equal(a.numpy(), b[:, lo:hi].numpy(), err_msg=name)


@settings(max_examples=15, deadline=None)
@given(case=stripes(max_atoms=60), seed=st.integers(0, 2**16))
def test_angle_histograms_of_the_stripes_add_up(case, seed):
    """A center's whole fan of angles lives in its stripe, with the stripe's
    center species ``sid[lo:hi]``: the sum over stripes is the full
    histogram (float64 sums in another order)."""
    n, parts = case
    pos, sid = _system(n, seed)
    *lists, counts = neighbor_extract_reference(pos, sid, BOX, 2.5, 48, 2)
    full = adf_pairs_histogram_reference(*lists, counts, sid, 20, 2).sum(0).double()
    total = torch.zeros_like(full)
    for lo, hi in parts:
        *lists, counts = neighbor_extract_reference(pos, sid, BOX, 2.5, 48, 2, centers=(lo, hi))
        total += adf_pairs_histogram_reference(*lists, counts, sid[lo:hi], 20, 2).sum(0).double()
    np.testing.assert_allclose(total.numpy(), full.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lo, hi", [(0, 128), (128, 300), (37, 161)])
def test_center_stripe_matches_the_pallas_centers_mode(lo, hi):
    """The TPU kernel's stripe (``centers=(pos_c, sid_c, i_offset)``, slots
    in arbitrary order) lists the same neighbors of each center, with the
    self pair left out by global index."""
    pos, sid = _system(300, seed=5)
    sid = torch.where(sid < 0, 0, sid)
    cutoff, k_n = 1.6, 64
    _, _, _, _, d_x, s_x, c_x = _neighbor_extract_pallas(
        jnp.asarray(pos.numpy()), jnp.asarray(sid.numpy()), jnp.asarray(BOX, jnp.float32),
        cutoff, k_n=k_n, interpret=True,
        centers=(jnp.asarray(pos[:, lo:hi].numpy()), jnp.asarray(sid[lo:hi].numpy()), lo),
    )
    d_x, s_x, c_x = (np.asarray(a)[:, : hi - lo] for a in (d_x, s_x, c_x))
    _, _, _, d_p, s_p, counts = (
        t.numpy() for t in neighbor_extract_reference(pos, sid, BOX, cutoff, k_n, 2, centers=(lo, hi))
    )
    assert counts.max() < k_n
    np.testing.assert_array_equal(counts, c_x.astype(np.int32))
    for f in range(pos.shape[0]):
        for c in range(hi - lo):
            listed = s_p[f, c] >= 0
            np.testing.assert_allclose(np.sort(d_p[f, c][listed]),
                                       np.sort(d_x[f, c][s_x[f, c] >= 0]), atol=1e-6)
            assert sorted(s_p[f, c][listed]) == sorted(s_x[f, c][s_x[f, c] >= 0])


def test_the_wrappers_check_the_stripe():
    pos, sid = _system(20, seed=1)
    with pytest.raises(ValueError, match="rows must satisfy"):
        rdf_kernel.rdf_histogram(pos, sid, BOX, 2.9, 30, 2, rows=(5, 3))
    for route in (adf_kernel.neighbor_extract, adf_kernel.neighbor_extract_binned,
                  adf_kernel.neighbor_extract_sweep):
        with pytest.raises(ValueError, match="centers must satisfy"):
            route(pos, sid, BOX, 2.5, 8, 2, centers=(-1, 4))
        with pytest.raises(ValueError, match="centers must satisfy"):
            route(pos, sid, BOX, 2.5, 8, 2, centers=(0, 21))
