"""The neighbor extract's modes in the port, held against the JAX package.

Three modes of ``lammps_analysis_tpu/ops/pallas_adf.py::_neighbor_extract_pallas``
that the port's K2 (``csrc/adf_neighbor_extract.cu``, ``csrc/adf_neighbor_cells.cu``)
now has, run here through their wrappers on CPU tensors, i.e. the plain
versions (``ops/adf.py``), against the JAX functions in interpret mode:

* the ``idx`` output (``neighbor_indices_pallas``, ``pallas_neighbor_lists``,
  ``pallas_neighbor_components``), periodic and with open boundaries;
* the sorted route (``sorted_neighbor_extract``, z and brick sorts), its
  ``sid_sorted`` and its overflow flag under a bound that is too narrow;
* the open-boundary ADF (``adf_histogram_pallas(box=None)``).

The windows (``ops/sorting.py``) are checked to cover every chunk that holds
a neighbor of a block, with hypothesis, a center at the periodic seam among
the cases. Inputs are numpy-seeded and handed to both packages.

Tolerances: neighbor sets per center equal, ``max_count`` equal, distances
within 1e-6 (the port's minimum image multiplies by float32 reciprocals where
the JAX one divides); the port's sorted lists equal its unsorted lists bit for
bit once the centers are permuted back. Angle histograms: totals within rtol
1e-5 and at most max(2, size // 64) bins outside rtol 1e-4 (the JAX package's
ADF allowance).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from lammps_analysis_tpu.ops.pallas_adf import (
    _brick_sort,
    _spatial_sort,
    adf_histogram_pallas,
    neighbor_indices_pallas,
    pallas_neighbor_components,
    pallas_neighbor_lists,
    sorted_neighbor_extract,
)
from lammps_analysis_tpu_torch.ops import adf as port_adf
from lammps_analysis_tpu_torch.ops import adf_kernel, sorting
from lammps_analysis_tpu_torch.parallel import sharded_ops

torch.set_num_threads(1)


def _system(seed, n_per_species, n_frames=2, box=(8.0, 8.0, 8.0)):
    rng = np.random.default_rng(seed)
    n = sum(n_per_species)
    pos = (rng.uniform(0, 1, (n_frames, n, 3)) * np.asarray(box)).astype(np.float32)
    sid = np.repeat(np.arange(len(n_per_species)), n_per_species).astype(np.int32)
    return pos, sid, list(box)


def _assert_hist_close(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    assert ref.sum() > 0
    np.testing.assert_allclose(ours.sum(), ref.sum(), rtol=1e-5)
    bad = ~np.isclose(ours, ref, rtol=1e-4, atol=1e-6)
    assert bad.sum() <= max(2, ref.size // 64), f"{bad.sum()} bins differ"


def _jax_box(box):
    return None if box is None else jnp.asarray(box, jnp.float32)


# ------------------------------------------------------------------- idx
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "open"])
def test_idx_lists_and_components_match_pallas(periodic):
    """``neighbor_indices`` / ``neighbor_lists`` / ``neighbor_components``
    against the Pallas functions: the same index set per center, the same
    ``max_count``, distances within 1e-6; the port's idx in ascending order
    and consistent with its own lists."""
    pos, sid, box = _system(11, [140, 150])
    sid[[3, 200]] = -1  # padding
    box = box if periodic else None
    cutoff, k_n = 2.5, 128
    args = (torch.from_numpy(pos), torch.from_numpy(sid), box, cutoff, k_n, 2)
    j_args = (jnp.asarray(pos), jnp.asarray(sid), _jax_box(box), cutoff)
    idx_x = np.asarray(neighbor_indices_pallas(*j_args, k_n=k_n, interpret=True))
    idx_p = adf_kernel.neighbor_indices(*args).numpy()
    r_p, d_p, s_p, sid_pad, mc_p = adf_kernel.neighbor_lists(*args)
    (rx, ry, rz), d_c, s_c, _, mc_c = adf_kernel.neighbor_components(*args)
    _, d_x, _, _, mc_x = pallas_neighbor_lists(*j_args, k_n=k_n, interpret=True)
    (_, _, _), d_xc, _, _, mc_xc = pallas_neighbor_components(*j_args, k_n=k_n, interpret=True)
    n = pos.shape[1]
    assert idx_p.shape == (2, n, k_n) and idx_p.dtype == np.int32
    assert int(mc_p) == int(mc_c) == int(mc_x) == int(mc_xc) < k_n
    assert torch.equal(sid_pad, args[1])
    assert torch.equal(r_p, torch.stack([rx, ry, rz], -1)) and torch.equal(d_p, d_c)
    d_x, d_xc = np.asarray(d_x), np.asarray(d_xc)
    d_p = d_p.numpy()
    for fr in range(2):
        for c in range(n):
            mine = idx_p[fr, c][idx_p[fr, c] >= 0]
            theirs = idx_x[fr, c][idx_x[fr, c] >= 0]
            np.testing.assert_array_equal(mine, np.sort(theirs))  # ascending, same set
            assert (idx_p[fr, c, len(mine):] == -1).all()
            for dx in (d_x, d_xc):
                np.testing.assert_allclose(np.sort(d_p[fr, c][: len(mine)]),
                                           np.sort(dx[fr, c][dx[fr, c] > 0]), atol=1e-6)
            r = pos[fr, mine].astype(np.float64) - pos[fr, c]
            if periodic:
                r -= np.asarray(box) * np.round(r / np.asarray(box))
            np.testing.assert_allclose(np.sqrt((r * r).sum(-1)), d_p[fr, c, : len(mine)], atol=1e-5)


def test_idx_slots_are_the_lists_slots():
    """``with_idx`` appends the atom indices of the very slots of the lists,
    on both routes' wrappers and with open boundaries."""
    pos, sid, box = _system(12, [60, 40], box=(6.0, 6.0, 6.0))
    t = (torch.from_numpy(pos), torch.from_numpy(sid))
    for b in (box, None):
        *lists, counts, idx = adf_kernel.neighbor_extract_sweep(*t, b, 2.2, 48, 2, with_idx=True)
        plain = port_adf.neighbor_extract_reference(*t, b, 2.2, 48, 2)
        assert all(torch.equal(a, p) for a, p in zip((*lists, counts), plain))
        listed = idx >= 0
        assert torch.equal(listed.sum(-1), counts.clamp(max=48))
        f, c, _ = listed.nonzero(as_tuple=True)
        assert torch.equal(lists[4][listed], t[1][idx[listed].long()])
        r = t[0][f, idx[listed].long(), 0] - t[0][f, c, 0]
        if b is not None:
            r = r - 6.0 * torch.round(r * np.float32(1 / 6.0))
        torch.testing.assert_close(lists[0][listed], r, rtol=0, atol=1e-6)
    bx = adf_kernel.neighbor_extract_binned(*t, box, 2.0, 48, 2, with_idx=True)
    sw = adf_kernel.neighbor_extract_sweep(*t, box, 2.0, 48, 2, with_idx=True)
    assert all(torch.equal(a, b) for a, b in zip(bx, sw))


def test_open_boundaries_take_the_sweep():
    """``box=None``: the sweep's route, no minimum image (atoms across a face
    are not neighbors), and the binned and sorted wrappers refuse it."""
    pos = np.array([[[0.1, 0.1, 0.1], [9.9, 0.1, 0.1], [0.6, 0.1, 0.1]]], np.float32)
    sid = np.zeros(3, np.int32)
    t = (torch.from_numpy(pos), torch.from_numpy(sid))
    assert adf_kernel.extract_route(None, 1.0, 8, 3) == "sweep"
    idx = adf_kernel.neighbor_indices(*t, None, 1.0, 4, 1)
    assert idx[0, 0].tolist() == [2, -1, -1, -1] and idx[0, 1].tolist() == [-1] * 4
    periodic = adf_kernel.neighbor_indices(*t, [10.0] * 3, 1.0, 4, 1)
    assert periodic[0, 0].tolist() == [1, 2, -1, -1]
    with pytest.raises(ValueError, match="periodic box"):
        adf_kernel.neighbor_extract_binned(*t, None, 1.0, 4, 1)
    with pytest.raises(ValueError, match="periodic box"):
        adf_kernel.sorted_neighbor_extract(*t, None, 1.0, 4, 1)


# ------------------------------------------------------------- sorted route
def _sets_by_atom(lists, order, n):
    """Per (frame, original atom): sorted (sid, d) pairs of its list."""
    *_, d, s, counts = lists
    d, s, counts, order = (np.asarray(x) for x in (d, s, counts, order))
    out = {}
    for fr in range(d.shape[0]):
        for row in range(n):
            m = min(int(counts[fr, row]), d.shape[2])
            out[fr, int(order[fr, row])] = (int(counts[fr, row]),
                                             sorted(zip(s[fr, row, :m].tolist(), d[fr, row, :m].tolist())))
    return out


def _jax_order(pos, pos_sorted):
    """The original atom of each sorted row, matched by its coordinates."""
    where = {tuple(p): i for i, p in enumerate(pos.tolist())}
    return np.array([where[tuple(p)] for p in pos_sorted.tolist()])


@pytest.mark.parametrize("sort", ["z", "brick"])
def test_sorted_extract_matches_pallas_sorted_extract(sort):
    """The sorted route against ``sorted_neighbor_extract`` in interpret mode:
    each atom's neighbor set, count and distances equal once both
    permutations are undone; ``sid_sorted`` is the sorted frame's ids;
    ``overflow`` 0 under the sort's bound and 1 under a bound of one chunk,
    as the JAX function flags ``w_chunks=1``."""
    pos, sid, box = _system(13, [150, 150], box=(7.0, 7.0, 30.0))
    sid[7] = -1
    cutoff, k_n = 2.4, 128
    t = (torch.from_numpy(pos), torch.from_numpy(sid))
    n_arcs = 6 if sort == "brick" else 1
    bound = sorting.window_bound(sort, pos.shape[1], box, cutoff)
    *lists, sid_s, ovf = adf_kernel.sorted_neighbor_extract(*t, box, cutoff, k_n, 2, sort, bound)
    j = sorted_neighbor_extract(jnp.asarray(pos), jnp.asarray(sid), _jax_box(box), cutoff,
                                k_n=k_n, interpret=True, sort=sort, n_arcs=n_arcs)
    assert int(ovf) == 0 and int(j[7]) == 0
    _, _, order = (sorting.spatial_sort(*t, 2) if sort == "z"
                   else sorting.brick_sort(*t, 2, box, cutoff))
    assert torch.equal(sid_s, torch.gather(t[1].expand(2, -1), 1, order))
    assert (sid_s[:, -1] == -1).all()  # invalid atoms sort last
    n = pos.shape[1]
    ours = _sets_by_atom(lists, order, n)
    # the JAX rows' atoms: its own sort of its padded frames, matched by coordinates
    pad = 384 - n
    pos_j = jnp.asarray(np.pad(pos, ((0, 0), (0, pad), (0, 0))))
    sid_j = jnp.asarray(np.pad(sid, (0, pad), constant_values=-1))
    pos_js, sid_js = (_spatial_sort(pos_j, sid_j, _jax_box(box)) if sort == "z"
                      else _brick_sort(pos_j, sid_j, _jax_box(box), cutoff))
    np.testing.assert_array_equal(np.asarray(sid_js), np.asarray(j[6]))
    j_lists = [np.asarray(x) for x in j[:6]]
    by_atom_j = {}
    for fr in range(2):
        rows = np.flatnonzero(np.asarray(sid_js)[fr] >= 0)
        atoms = _jax_order(pos[fr], np.asarray(pos_js)[fr, rows])
        for row, atom in zip(rows, atoms):
            m = int(j_lists[5][fr, row])
            by_atom_j[fr, int(atom)] = sorted(zip(j_lists[4][fr, row, :m].tolist(),
                                                  j_lists[3][fr, row, :m].tolist()))
    for (fr, atom), (count, pairs) in ours.items():
        if sid[atom] < 0:
            assert count == 0
            continue
        theirs = by_atom_j[fr, atom]
        assert count == len(theirs) == len(pairs), (fr, atom)
        assert [s for s, _ in pairs] == [s for s, _ in theirs]
        np.testing.assert_allclose([d for _, d in pairs], [d for _, d in theirs], atol=1e-6)
    *_, narrow = adf_kernel.sorted_neighbor_extract(*t, box, cutoff, k_n, 2, sort, 1)
    j_narrow = sorted_neighbor_extract(jnp.asarray(pos), jnp.asarray(sid), _jax_box(box), cutoff,
                                       k_n=k_n, interpret=True, sort=sort, n_arcs=n_arcs,
                                       w_chunks=1)
    assert int(narrow) == 1 and int(j_narrow[7]) == 1


@pytest.mark.parametrize("sort", ["z", "brick"])
def test_sorted_lists_are_the_unsorted_lists_bit_for_bit(sort):
    """Permuted back, the sorted route's lists equal the unsorted extract's:
    the same slots' values exactly, once each center's slots are put in
    ascending original index."""
    pos, sid, box = _system(14, [200, 100], box=(10.0, 10.0, 24.0))
    sid[[5, 150]] = 5  # out of range: padding
    cutoff, k_n = 2.8, 96
    t = (torch.from_numpy(pos), torch.from_numpy(sid))
    sort_fn = sorting.spatial_sort if sort == "z" else (
        lambda p, s, n: sorting.brick_sort(p, s, n, box, cutoff))
    pos_s, sid_s, order = sort_fn(*t, 2)
    *lists, counts, idx = port_adf.neighbor_extract_reference(pos_s, sid_s, box, cutoff, k_n, 2,
                                                            with_idx=True)
    ref = port_adf.neighbor_extract_reference(*t, box, cutoff, k_n, 2, with_idx=True)
    via = adf_kernel.sorted_neighbor_extract(*t, box, cutoff, k_n, 2, sort)
    assert all(torch.equal(a, b) for a, b in zip(via[:6], (*lists, counts)))
    for fr in range(2):
        inv = torch.empty_like(order[fr])
        inv[order[fr]] = torch.arange(order.shape[1])
        assert torch.equal(counts[fr][inv], ref[5][fr])
        listed = idx[fr] >= 0
        orig_j = torch.where(listed, order[fr][idx[fr].clamp(min=0).long()], -1)
        key = torch.where(listed, orig_j, 1 << 30)
        slots = torch.argsort(key, dim=1, stable=True)
        for a, b in zip((*lists, orig_j), (*ref[:5], ref[6])):
            back = torch.gather(a[fr] if a.dim() == 3 else a, 1, slots)[inv]
            assert torch.equal(back, b[fr]), "differs"


# ----------------------------------------------------------------- windows
def _covered(arcs, n_chunks):
    """(rows, n_chunks) bool of the chunks the arcs of each row cover."""
    arcs = np.asarray(arcs)
    out = np.zeros((arcs.shape[0], n_chunks), bool)
    for r, row in enumerate(arcs):
        for start, count in row.reshape(-1, 2):
            out[r, (start + np.arange(count)) % n_chunks] = True
    return out


@settings(max_examples=25, deadline=None)
@given(
    n=st.integers(33, 180),
    lxy=st.floats(4.0, 12.0),
    lz=st.floats(6.0, 30.0),
    cutoff=st.floats(0.8, 3.0),
    seed=st.integers(0, 2**31 - 1),
)
def test_windows_never_drop_a_flagged_chunk_or_a_pair(n, lxy, lz, cutoff, seed):
    """For both sorts: the arcs cover every flagged chunk (the flags along
    the sorted axes, a superset of the three-axis flags), and every pair in
    the cutoff has its neighbor's chunk inside its center's block window, a
    center at the periodic seam (z near 0, a neighbor near L_z) included.
    The z window is one arc."""
    rng = np.random.default_rng(seed)
    box = [lxy, lxy, lz]
    pos = (rng.uniform(0, 1, (1, n, 3)) * np.asarray(box)).astype(np.float32)
    pos[0, 0] = [lxy / 2, lxy / 2, 0.01]
    pos[0, 1] = [lxy / 2, lxy / 2, lz - 0.01]  # across the seam from atom 0
    sid = rng.choice(np.array([-1, 0, 1], np.int32), p=[0.1, 0.45, 0.45], size=n)  # -1: padding
    sid[:2] = 0
    t = (torch.from_numpy(pos), torch.from_numpy(sid))
    n_chunks = -(-n // sorting.CHUNK_ATOMS)
    for sort in ("z", "brick"):
        pos_s, sid_s, order, arcs, total = sorting.sort_frames(*t, 2, box, cutoff, sort)
        split, axes = (2, (1, 2)) if sort == "brick" else (1, (2,))
        flags = sorting.chunk_skip_bitmap(pos_s, sid_s, 2, box, cutoff, split, axes).numpy()
        every_axis = sorting.chunk_skip_bitmap(pos_s, sid_s, 2, box, cutoff, split).numpy()
        cov = _covered(arcs, n_chunks)
        assert not (flags & ~cov).any() and not (every_axis & ~flags).any()
        np.testing.assert_array_equal(cov.sum(1), np.asarray(total))
        if sort == "z":
            assert arcs.shape[1] == 2
        *_, counts, idx = port_adf.neighbor_extract_reference(pos_s, sid_s, box, cutoff, n, 2,
                                                            with_idx=True)
        rows, slots = np.nonzero(idx[0].numpy() >= 0)
        j = idx[0].numpy()[rows, slots]
        assert cov[rows // sorting.BLOCK_CENTERS, j // sorting.CHUNK_ATOMS].all()
        seam = int(np.flatnonzero(order[0].numpy() == 0)[0])
        other = int(np.flatnonzero(order[0].numpy() == 1)[0])
        assert other in idx[0, seam].tolist()  # the seam pair is listed


def test_arcs_from_flags_examples():
    """One wrapped arc, two arcs kept apart, a full row and an empty one."""
    flags = torch.tensor([
        [1, 1, 0, 0, 0, 1],
        [1, 0, 0, 1, 0, 0],
        [1, 1, 1, 1, 1, 1],
        [0, 0, 0, 0, 0, 0],
    ], dtype=torch.int32)
    arcs, total = sorting.arcs_from_flags(flags, 2)
    assert total.tolist() == [3, 2, 6, 0]
    for row, want in zip(_covered(arcs, 6), flags.bool().numpy()):
        np.testing.assert_array_equal(row, want)
    one, total1 = sorting.arcs_from_flags(flags[1:2], 1)
    assert total1.tolist() == [4]  # one arc must bridge the shorter gap


def test_window_bounds_at_the_chunk_granularity():
    """The bounds of the 32-atom chunks: the JAX formulas with the finer
    chunk count, never above the frame."""
    assert sorting.window_chunk_bound(32768, [64.0] * 3, 10.0) == int(np.ceil(1.5 * 21 / 64 * 1024)) + 3
    assert sorting.window_chunk_bound(1000, [10.0] * 3, 6.0) == 32
    assert sorting.brick_window_bound(32768, [64.0] * 3, 10.0) < 1024
    assert sorting.window_bound("brick", 32768, [64.0] * 3, 10.0) == sorting.brick_window_bound(
        32768, [64.0] * 3, 10.0)
    with pytest.raises(ValueError, match="sort"):
        sorting.window_bound("morton", 10, [1.0] * 3, 0.5)


def test_extract_route_names_the_sorted_route():
    route = adf_kernel.extract_route
    assert route([64.0] * 3, 10.0, 1024, 32768) == "sorted"  # wide lists
    assert route([64.0] * 3, 10.0, 512, 32768) == "binned"
    assert route([7.0, 7.0, 30.0], 2.4, 128, 300) == "sorted"  # two cells across
    assert route([10.0] * 3, 6.0, 2000, 2000) == "sweep"  # the window is the frame
    assert route(None, 3.6, 88, 10240) == "sweep"
    assert adf_kernel.sort_for(32768) == "brick" and adf_kernel.sort_for(10240) == "z"


# --------------------------------------------------------------------- ADF
@pytest.mark.parametrize("box", [None, (7.0, 7.0, 30.0)], ids=["open", "sorted"])
def test_adf_histogram_matches_pallas(box):
    """``adf_histogram`` against ``adf_histogram_pallas`` in interpret mode:
    open boundaries (the sweep) and a tall periodic box (the sorted route)."""
    pos, sid, _ = _system(15, [150, 150], box=(7.0, 7.0, 30.0))
    cutoff, n_bins = 2.5, 60
    t = (torch.from_numpy(pos), torch.from_numpy(sid))
    if box is not None:
        assert adf_kernel.extract_route(box, cutoff, 128, pos.shape[1]) == "sorted"
    ours, mc = adf_kernel.adf_histogram(*t, box, cutoff, n_bins, 2)
    ref, mc_x = adf_histogram_pallas(jnp.asarray(pos), jnp.asarray(sid), _jax_box(box), cutoff,
                                     n_bins, 2, interpret=True)
    assert int(mc) == int(mc_x) < 128
    _assert_hist_close(ours.numpy(), np.asarray(ref))


def test_runner_repeats_an_overflowed_batch_on_the_sweep(monkeypatch):
    """A window bound of 0 chunks: the sorted route's batch overflows,
    ``finalize`` turns the plan to the sweep and asks for the batch again,
    and the repeat equals the run that swept from the start."""
    pos, sid, box = _system(16, [150, 150], box=(7.0, 7.0, 30.0))
    t = (torch.from_numpy(pos), torch.from_numpy(sid))
    runner = sharded_ops.AdfBatchRunner(300, t[1], box, 2.4, 50, 2)
    runner.plan.k_n = 128
    assert adf_kernel.extract_route(box, 2.4, 128, 300) == "sorted"
    monkeypatch.setattr(sorting, "window_bound", lambda *args: 0)
    calls = port_adf.neighbor_extract_reference.calls
    runner.feed(t[0])
    assert runner.finalize() is None and not runner.plan.use_sorted
    runner.feed(t[0])
    hist = runner.finalize()
    assert port_adf.neighbor_extract_reference.calls == calls + 2
    swept = sharded_ops.AdfBatchRunner(300, t[1], box, 2.4, 50, 2)
    swept.plan.k_n, swept.plan.use_sorted = 128, False
    swept.feed(t[0])
    assert torch.equal(hist, swept.finalize())
    sorted_run = sharded_ops.AdfBatchRunner(300, t[1], box, 2.4, 50, 2)
    sorted_run.plan.k_n = 128
    monkeypatch.undo()
    sorted_run.feed(t[0])
    _assert_hist_close(sorted_run.finalize().numpy(), hist.numpy())
    assert sorted_run.plan.use_sorted


def test_plan_escalates_on_overflow_and_saturation():
    plan = sharded_ops.AdfPlan(10240, [40.0] * 3, 3.6)
    assert plan.use_sorted and not plan.escalate(80, False)
    assert plan.escalate(80, True) and not plan.use_sorted and plan.k_n == 88
    assert not plan.escalate(80, True)  # already on the sweep
    assert plan.escalate(300, False) and plan.k_n == 304
