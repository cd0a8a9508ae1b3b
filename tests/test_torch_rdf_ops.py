"""PyTorch port: the plain torch pair histogram and the RDF host helpers,
held against the JAX package on the same seeded numpy inputs.

The plain version (``rdf_histogram_reference``) uses the same float32
operation sequence as the TPU kernel ``rdf_histogram_pallas`` (run here in
interpret mode, as ``tests/test_pallas_rdf.py`` runs it), so the two agree
bin for bin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_analysis_tpu.ops import rdf as jax_rdf
from lammps_analysis_tpu.ops.pallas_rdf import rdf_histogram_pallas
from lammps_analysis_tpu_torch.ops import rdf as torch_rdf
from lammps_analysis_tpu_torch.ops import rdf_kernel
from lammps_analysis_tpu_torch.utils import profiling
from lammps_analysis_tpu_torch.utils.config import config

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def _layout(counts, n_frames, box, seed, pad_to=8):
    rng = np.random.default_rng(seed)
    sid, n_pad, ptab, n_pairs, _ = jax_rdf.build_species_layout(counts, pad_to)
    n_total = sum(counts)
    pos = np.zeros((n_frames, n_pad, 3), np.float32)
    pos[:, :n_total] = rng.uniform(0, 1, size=(n_frames, n_total, 3)) * np.asarray(
        box, np.float64
    )
    return pos, sid, ptab, n_pairs


def _torch_hist(pos, sid, box, cutoff, n_bins, n_species, **kw):
    return torch_rdf.rdf_histogram_reference(
        torch.from_numpy(pos), torch.from_numpy(sid), box, cutoff, n_bins,
        n_species, **kw,
    ).numpy()


def _pallas_hist(pos, sid, box, cutoff, n_bins, n_species):
    h = rdf_histogram_pallas(
        jnp.asarray(pos), jnp.asarray(sid), cutoff, n_bins, n_species,
        tuple(box), interpret=True,
    )
    return np.asarray(h).astype(np.int64)


@pytest.mark.parametrize(
    "counts, box, pad_to, cutoff, n_bins",
    [
        ([40, 24], (6.0, 6.0, 6.0), 8, 2.9, 50),
        ([64], (6.0, 6.0, 6.0), 8, 2.9, 50),
        ([16, 16, 16], (6.0, 6.0, 6.0), 8, 2.9, 50),
        # ragged: 181 atoms padded to 184 with species -1, not a multiple of 128
        ([70, 61, 50], (9.0, 9.0, 9.0), 8, 4.4, 40),
        # non-cubic box
        ([50, 30], (5.0, 6.5, 8.0), 8, 2.4, 30),
    ],
    ids=["40-24", "64", "16-16-16", "ragged", "noncubic"],
)
def test_plain_histogram_matches_pallas_bin_for_bin(counts, box, pad_to, cutoff, n_bins):
    pos, sid, _, _ = _layout(counts, 2, box, seed=42)
    h_pal = _pallas_hist(pos, sid, box, cutoff, n_bins, len(counts))
    h_t = _torch_hist(pos, sid, box, cutoff, n_bins, len(counts))
    assert h_t.dtype == np.int64
    assert h_t.sum() > 0
    np.testing.assert_array_equal(h_t, h_pal)


@pytest.mark.parametrize("i_block", [8, 128])
def test_plain_histogram_matches_xla(i_block):
    """Against the XLA ``rdf_histogram``: equal totals always (same pairs
    pass the same cutoff test), and equal bins at this seed. The XLA
    function's minimum image divides by the box and bins by
    ``d / cutoff * n_bins``; the plain version multiplies by float32
    reciprocals. The two differ only for a distance within about one float32
    ulp of a bin edge (or a displacement at exactly half a box), which none
    of this seed's pairs is."""
    counts, box, cutoff, n_bins = [40, 24], (6.0, 6.0, 6.0), 2.9, 50
    pos, sid, ptab, n_pairs = _layout(counts, 2, box, seed=7)
    h_xla = np.asarray(
        jax_rdf.rdf_histogram(
            jnp.asarray(pos), jnp.asarray(sid), jnp.asarray(ptab),
            jnp.asarray(np.array(box, np.float32)), cutoff, n_bins, n_pairs,
            i_block=8,
        )
    ).astype(np.int64)
    h_t = _torch_hist(pos, sid, box, cutoff, n_bins, len(counts), i_block=i_block)
    assert h_t.sum() == h_xla.sum()
    np.testing.assert_array_equal(h_t, h_xla)


def test_species_layout_matches_jax():
    for counts in ([4], [3, 5], [7, 1, 9], [2, 2, 2, 2]):
        for pad_to in (1, 8):
            ours = torch_rdf.build_species_layout(counts, pad_to)
            ref = jax_rdf.build_species_layout(counts, pad_to)
            np.testing.assert_array_equal(ours[0], ref[0])
            assert ours[1] == ref[1]
            np.testing.assert_array_equal(ours[2], ref[2])
            assert ours[3:] == ref[3:]


@pytest.mark.parametrize("box_l", [10.0, 7.3])
def test_ideal_gas_and_prefactors_match_jax(box_l):
    # edges beyond L/2 and beyond sqrt(2) L / 2 exercise all three branches
    edges = np.linspace(0.0, 0.9 * box_l, 97)
    np.testing.assert_allclose(
        torch_rdf.ideal_gas_correction(edges, box_l),
        jax_rdf.ideal_gas_correction(edges, box_l),
        rtol=1e-12,
    )
    order = [(0, 0), (0, 1), (1, 1)]
    args = (order, [30, 20], box_l**3, 17, edges, box_l)
    np.testing.assert_allclose(
        torch_rdf.rdf_prefactors(*args), jax_rdf.rdf_prefactors(*args), rtol=1e-12
    )


def test_wrapper_runs_plain_version_on_cpu():
    counts, box = [40, 24], (6.0, 6.0, 6.0)
    pos, sid, _, _ = _layout(counts, 2, box, seed=3)
    before = profiling.counters.copy()
    h = rdf_kernel.rdf_histogram(
        torch.from_numpy(pos), torch.from_numpy(sid), box, 2.9, 50, 2
    )
    delta = profiling.counters - before
    assert delta["k1.plain"] == 1
    assert delta["k1.launches"] == 0
    np.testing.assert_array_equal(h.numpy(), _pallas_hist(pos, sid, box, 2.9, 50, 2))


def test_out_of_range_species_counts_as_padding():
    """An id of n_species or more is skipped like -1 (the kernel would
    otherwise add outside its histogram)."""
    counts, box = [40, 24], (6.0, 6.0, 6.0)
    pos, sid, _, _ = _layout(counts, 2, box, seed=9)
    bad = sid.copy()
    bad[5:9] = 2
    padded = sid.copy()
    padded[5:9] = -1
    np.testing.assert_array_equal(
        _torch_hist(pos, bad, box, 2.9, 50, 2), _pallas_hist(pos, padded, box, 2.9, 50, 2)
    )


def test_wrapper_rejects_bad_inputs():
    pos = torch.zeros((2, 16, 3), dtype=torch.float32)
    sid = torch.zeros((16,), dtype=torch.int32)
    box = (5.0, 5.0, 5.0)
    with pytest.raises(TypeError, match="float32"):
        rdf_kernel.rdf_histogram(pos.double(), sid, box, 2.0, 10, 1)
    with pytest.raises(TypeError, match="int32"):
        rdf_kernel.rdf_histogram(pos, sid.long(), box, 2.0, 10, 1)
    with pytest.raises(ValueError, match=r"\(F, N, 3\)"):
        rdf_kernel.rdf_histogram(pos[0], sid, box, 2.0, 10, 1)
    with pytest.raises(ValueError, match="species_id must have shape"):
        rdf_kernel.rdf_histogram(pos, sid[:8], box, 2.0, 10, 1)
    with pytest.raises(ValueError, match="contiguous"):
        rdf_kernel.rdf_histogram(pos.transpose(0, 1), sid[:2], box, 2.0, 10, 1)
    with pytest.raises(ValueError, match="box"):
        rdf_kernel.rdf_histogram(pos, sid, None, 2.0, 10, 1)
    with pytest.raises(ValueError, match="3 edge lengths"):
        rdf_kernel.rdf_histogram(pos, sid, (5.0, 5.0), 2.0, 10, 1)
    with pytest.raises(ValueError, match=r"n_bins / cutoff < 2\^40"):
        rdf_kernel.rdf_histogram(pos, sid, box, 1e-12, 10, 1)
