"""The port's ADF ops held against the JAX package, on the CPU.

Plain versions of the two CUDA kernels (``ops/adf.py``): the neighbor
extract (K2) against ``adf_neighbor_lists`` (top_k) and the Pallas extract in
interpret mode; the angle histogram (K3), fed the JAX package's own lists,
against ``adf_pairs_histogram_xla`` and the Pallas kernel with ``fold=True``
in interpret mode; the whole plain ADF against ``ops/adf.py::adf_histogram``.
Inputs are numpy-seeded and handed to both packages.

Tolerances. K2: the same neighbor set per center (sorted distances at atol
1e-6, the same species multiset) and the same counts; the port's minimum
image multiplies by float32 reciprocals where the JAX one divides. K3 and
the whole ADF: totals within rtol 1e-5 and at most max(2, size // 64) bins
outside rtol 1e-4 (the JAX package's own allowance, ``tests/
test_pallas_adf.py:62-66``): angles within an ulp of a bin edge may bin
differently, and float32 sums run in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lammps_analysis_tpu.ops import adf as jax_adf
from lammps_analysis_tpu.ops.pallas_adf import (
    adf_neighbor_lists,
    adf_pairs_histogram_pallas,
    pallas_neighbor_lists,
)
from lammps_analysis_tpu_torch.ops import adf as port_adf
from lammps_analysis_tpu_torch.ops import adf_kernel
from lammps_analysis_tpu_torch.parallel import make_data_mesh, sharded_ops
from lammps_analysis_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _system(seed, n_per_species, n_frames=2, box_l=8.0):
    rng = np.random.default_rng(seed)
    n = sum(n_per_species)
    pos = rng.uniform(0, box_l, (n_frames, n, 3)).astype(np.float32)
    sid = np.repeat(np.arange(len(n_per_species)), n_per_species).astype(np.int32)
    return pos, sid, [box_l] * 3


def _assert_hist_close(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    assert ref.sum() > 0
    np.testing.assert_allclose(ours.sum(), ref.sum(), rtol=1e-5)
    bad = ~np.isclose(ours, ref, rtol=1e-4, atol=1e-6)
    assert bad.sum() <= max(2, ref.size // 64), f"{bad.sum()} bins differ"


def _port_extract(pos, sid, box, cutoff, k_n, n_species):
    return [
        t.numpy()
        for t in port_adf.neighbor_extract_reference(
            torch.from_numpy(pos), torch.from_numpy(sid), box, cutoff, k_n, n_species
        )
    ]


def _brute_force(pos, sid, box, cutoff, n_species):
    """Per (frame, center): in-cutoff j in ascending order, float64."""
    valid = (sid >= 0) & (sid < n_species)
    r = pos[:, None, :, :].astype(np.float64) - pos[:, :, None, :]
    r -= np.asarray(box) * np.round(r / np.asarray(box))
    d = np.sqrt((r * r).sum(-1))
    n = pos.shape[1]
    return (d < cutoff) & valid[None, None, :] & valid[None, :, None] & ~np.eye(n, dtype=bool)


# ------------------------------------------------------------------------ K2
@pytest.mark.parametrize("reference", ["top_k", "pallas_interpret"])
def test_plain_extract_matches_jax_lists(reference):
    """Same neighbor set and count per center as the JAX lists, with
    padding (-1) and an id >= S, which the port treats as padding and the
    JAX package is handed as -1."""
    pos, _, box = _system(3, [140, 150], box_l=8.0)
    pos = np.concatenate([pos, pos[:, :10] + 0.5], axis=1)  # 10 more atoms
    sid = np.r_[np.zeros(140), np.ones(150), -np.ones(5), np.full(5, 2)].astype(np.int32)
    sid_jax = np.where(sid < 2, sid, -1).astype(np.int32)
    cutoff, k_n = 2.5, 128
    fn = adf_neighbor_lists if reference == "top_k" else pallas_neighbor_lists
    kw = {} if reference == "top_k" else {"interpret": True}
    _, d_x, s_x, _, mc_x = fn(
        jnp.asarray(pos), jnp.asarray(sid_jax), jnp.asarray(box, jnp.float32),
        cutoff, k_n=k_n, **kw,
    )
    d_x, s_x = np.asarray(d_x), np.asarray(s_x)
    rx, ry, rz, d_p, s_p, counts = _port_extract(pos, sid, box, cutoff, k_n, 2)
    n = pos.shape[1]
    assert counts.max() < k_n and int(mc_x) == counts.max()
    assert (counts[:, 290:] == 0).all() and (s_p[:, 290:] == -1).all()
    for fr in range(pos.shape[0]):
        for c in range(n):
            listed = s_p[fr, c] >= 0
            assert listed.sum() == counts[fr, c] == (s_x[fr, c] >= 0).sum(), (fr, c)
            np.testing.assert_allclose(
                np.sort(d_p[fr, c][listed]), np.sort(d_x[fr, c][s_x[fr, c] >= 0]), atol=1e-6
            )
            assert sorted(s_p[fr, c][listed]) == sorted(s_x[fr, c][s_x[fr, c] >= 0])
            # empty slots hold zeros; d is the length of (rx, ry, rz)
            assert not rx[fr, c][~listed].any() and not d_p[fr, c][~listed].any()
            r2 = rx[fr, c] ** 2 + ry[fr, c] ** 2 + rz[fr, c] ** 2
            np.testing.assert_allclose(np.sqrt(r2), d_p[fr, c], rtol=1e-6)


def test_plain_extract_slots_follow_ascending_j():
    """Slots hold exactly the in-cutoff atoms in ascending j, with
    r = pos_j - pos_i under the minimum image."""
    pos, sid, box = _system(5, [60, 40], n_frames=2, box_l=6.0)
    cutoff = 2.2
    rx, ry, rz, d, s, counts = _port_extract(pos, sid, box, cutoff, 64, 2)
    inside = _brute_force(pos, sid, box, cutoff, 2)
    np.testing.assert_array_equal(counts, inside.sum(-1))
    for fr in range(2):
        for c in range(100):
            js = np.flatnonzero(inside[fr, c])
            m = len(js)
            np.testing.assert_array_equal(s[fr, c, :m], sid[js])
            r = pos[fr, js] - pos[fr, c]
            r -= 6.0 * np.round(r / 6.0)
            np.testing.assert_allclose(np.stack([rx, ry, rz], -1)[fr, c, :m], r, atol=1e-5)
            assert (s[fr, c, m:] == -1).all()


def test_plain_extract_saturated_cluster_reports_true_counts():
    """A dense cluster: the JAX lists clamp at K (max_count == K, the retry
    signal); the port keeps the first K neighbors in ascending j and
    reports the true count."""
    rng = np.random.default_rng(7)
    pos = rng.uniform(0, 3.0, (1, 256, 3)).astype(np.float32)
    sid = np.zeros(256, np.int32)
    box, cutoff, k_n = [3.0] * 3, 2.9, 128
    *_, mc = pallas_neighbor_lists(
        jnp.asarray(pos), jnp.asarray(sid), jnp.asarray(box, jnp.float32), cutoff,
        k_n=k_n, interpret=True,
    )
    assert int(mc) == k_n
    _, _, _, _, s, counts = _port_extract(pos, sid, box, cutoff, k_n, 1)
    inside = _brute_force(pos, sid, box, cutoff, 1)
    np.testing.assert_array_equal(counts[0], inside[0].sum(-1))
    assert counts.max() > k_n
    assert ((s[0] >= 0).sum(-1) == np.minimum(counts[0], k_n)).all()


# ------------------------------------------------------------------------ K3
def _jax_lists(n_species, n_each, seed, cutoff=2.6, box_l=8.0, k_n=128):
    pos, sid, box = _system(seed, [n_each] * n_species, box_l=box_l)
    r_n, d_n, s_n, sid_pad, mc = adf_neighbor_lists(
        jnp.asarray(pos), jnp.asarray(sid), jnp.asarray(box, jnp.float32), cutoff, k_n=k_n
    )
    assert int(mc) < k_n
    return r_n, d_n, s_n, sid_pad


def _port_hist(r_n, d_n, s_n, sid_pad, n_bins, n_species, p):
    r = np.array(r_n)
    s = np.array(s_n)
    lists = [torch.from_numpy(np.ascontiguousarray(r[..., i])) for i in range(3)]
    lists += [torch.from_numpy(np.array(d_n)), torch.from_numpy(s)]
    counts = torch.from_numpy((s >= 0).sum(-1).astype(np.int32))
    sid_c = torch.from_numpy(np.array(sid_pad, np.int32))
    h = port_adf.adf_pairs_histogram_reference(*lists, counts, sid_c, n_bins, n_species, p)
    assert h.shape[0] == r.shape[0]  # one histogram per frame
    return h.sum(0).numpy()


K3_CASES = [
    (n_sp, n_bins, p) for n_sp in (1, 2, 3) for n_bins in (73, 500) for p in (2, 4)
]


@pytest.mark.parametrize("n_species, n_bins, p", K3_CASES)
def test_plain_pairs_histogram_matches_xla(n_species, n_bins, p):
    lists = _jax_lists(n_species, 150 // n_species, seed=n_species * 10 + p)
    ref = jax_adf.adf_pairs_histogram_xla(*lists, n_bins, n_species, norm_power=p)
    _assert_hist_close(_port_hist(*lists, n_bins, n_species, p), ref)


@pytest.mark.parametrize(
    "n_species, n_bins, p", [(1, 73, 2), (2, 500, 4), (3, 73, 4), (3, 500, 2)]
)
def test_plain_pairs_histogram_matches_pallas_fold(n_species, n_bins, p):
    r_n, d_n, s_n, sid_pad = _jax_lists(n_species, 150 // n_species, seed=n_species + p)
    ref = adf_pairs_histogram_pallas(
        r_n, d_n, s_n, sid_pad, n_bins, n_species, norm_power=p, fold=True,
        interpret=True,
    )
    _assert_hist_close(_port_hist(r_n, d_n, s_n, sid_pad, n_bins, n_species, p), ref)


# ---------------------------------------------------------------- whole ADF
@pytest.mark.parametrize(
    "n_per_species, n_bins, p, cutoff",
    [([48, 48], 73, 4, 2.6), ([50, 50, 50], 500, 4, 2.6), ([150], 107, 2, 3.1), ([70, 30], 90, 0, 2.9)],
)
def test_plain_adf_matches_jax_adf_histogram(n_per_species, n_bins, p, cutoff):
    pos, sid, box = _system(sum(n_per_species), n_per_species, n_frames=3)
    s = len(n_per_species)
    ttab, order = jax_adf.build_triple_table(s)
    ref = jax_adf.adf_histogram(
        jnp.asarray(pos), jnp.asarray(sid), jnp.asarray(ttab),
        jnp.asarray(box, jnp.float32), cutoff, n_bins, len(order), norm_power=p,
    )
    ours = port_adf.adf_histogram_reference(
        torch.from_numpy(pos), torch.from_numpy(sid), box, cutoff, n_bins, s, p
    )
    _assert_hist_close(ours.numpy(), ref)
    # the same batch through the device dispatch, with K from the density
    sharded = sharded_ops.sharded_adf_histogram(
        torch.from_numpy(pos), torch.from_numpy(sid), box, cutoff, n_bins, s, p
    )
    _assert_hist_close(sharded.numpy(), ref)


def test_triple_index_matches_table():
    for s in range(1, 6):
        table, order = port_adf.build_triple_table(s)
        jax_table, jax_order = jax_adf.build_triple_table(s)
        np.testing.assert_array_equal(table, jax_table)
        assert order == jax_order
        for idx, (a, b, c) in enumerate(order):
            assert port_adf.triple_index(a, b, c, s) == idx


# ------------------------------------------------- wrappers, plan, dispatch
def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    pos, sid, box = _system(2, [30, 30], n_frames=2, box_l=5.0)
    pos_t, sid_t = torch.from_numpy(pos), torch.from_numpy(sid)
    before = profiling.counters.copy()
    *lists, counts = adf_kernel.neighbor_extract(pos_t, sid_t, box, 2.0, 32, 2)
    h = adf_kernel.adf_pairs_histogram(*lists, counts, sid_t, 40, 2, 4)
    assert h.shape == (2, 4, 40) and h.dtype == torch.float32 and float(h.sum()) > 0
    for extract in (adf_kernel.neighbor_extract_sweep, adf_kernel.neighbor_extract_binned):
        assert all(torch.equal(a, b) for a, b in zip(extract(pos_t, sid_t, box, 2.0, 32, 2), (*lists, counts)))
    delta = profiling.counters - before
    assert (delta["k2.plain"], delta["k3.plain"]) == (3, 1)
    assert not any(name.endswith("launches") or ".launches." in name for name in delta)


def test_wrappers_check_their_inputs():
    pos, sid, box = _system(2, [20], n_frames=1, box_l=5.0)
    pos_t, sid_t = torch.from_numpy(pos), torch.from_numpy(sid)
    with pytest.raises(TypeError, match="float32"):
        adf_kernel.neighbor_extract(pos_t.double(), sid_t, box, 2.0, 8, 1)
    with pytest.raises(TypeError, match="int32"):
        adf_kernel.neighbor_extract(pos_t, sid_t.long(), box, 2.0, 8, 1)
    with pytest.raises(ValueError, match="contiguous"):
        adf_kernel.neighbor_extract(pos_t[:, ::2], sid_t[:10], box, 2.0, 8, 1)
    with pytest.raises(ValueError, match="3 edge lengths"):
        adf_kernel.neighbor_extract(pos_t, sid_t, [5.0, 5.0], 2.0, 8, 1)
    # box=None is open boundaries (the sweep), not an error
    assert adf_kernel.neighbor_extract(pos_t, sid_t, None, 2.0, 8, 1)[5].shape == (1, 20)
    *lists, counts = adf_kernel.neighbor_extract(pos_t, sid_t, box, 2.0, 8, 1)
    with pytest.raises(ValueError, match="counts must have shape"):
        adf_kernel.adf_pairs_histogram(*lists, counts[:, :5], sid_t, 10, 1)
    with pytest.raises(ValueError, match="norm_power"):
        adf_kernel.adf_pairs_histogram(*lists, counts, sid_t, 10, 1, norm_power=-1)


def test_plan_sizes_k_from_density_and_escalates_once():
    plan = sharded_ops.AdfPlan(10240, [40.0] * 3, 3.6)
    assert plan.k_n == 88  # expected 31.3 + 6 sqrt + 16 = 80.8, rounded up to 8
    assert not plan.escalate(88)
    assert plan.escalate(300) and plan.k_n == 304
    assert not plan.escalate(300)
    small = sharded_ops.AdfPlan(20, [5.0] * 3, 4.0)
    assert small.k_n == 20 and not small.escalate(19)


def test_runner_refuses_a_mesh():
    """The runner takes the port's meshes (``parallel/mesh.py``) and refuses
    anything else; a mesh of more ranks than the process group has is
    refused where it is made."""
    with pytest.raises(TypeError, match="make_data_mesh"):
        sharded_ops.AdfBatchRunner(8, torch.zeros(8, dtype=torch.int32), [5.0] * 3, 2.0, 10, 1, mesh=object())
    with pytest.raises(ValueError, match="a mesh spans every rank"):
        make_data_mesh(4)
