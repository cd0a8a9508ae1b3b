"""The binned neighbor extract's geometry, on the CPU.

* ``ops/geometry.py::squared_cutoff``: ``s <= t`` decides exactly as
  ``sqrt(s) < cutoff`` on every float32 near ``cutoff**2``;
* ``ops/cells.py``: cells per axis with the margin, where cell lists apply,
  and ``ops/adf_kernel.py::extract_route``, the rule that picks the route;
* the port's binning against the JAX package's ``ops/cells.py::
  build_cell_table`` (same occupancy per cell on the same wrapped positions);
* coverage: every in-cutoff pair that ``neighbor_extract_reference`` lists
  lies in the 27-cell neighborhood the port's binning gives, with cell width
  an exact multiple of the cutoff, atoms on cell faces, unwrapped coordinates
  and a non-cubic box.

The binning functions in ``ops/cells.py`` repeat the binning kernel's float64
arithmetic, so these tests hold the cover the CUDA kernel relies on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_analysis_tpu.ops import cells as jax_cells
from lammps_analysis_tpu_torch.ops import adf_kernel, cells
from lammps_analysis_tpu_torch.ops.adf import neighbor_extract_reference
from lammps_analysis_tpu_torch.ops.geometry import box_scalars, minimum_image, squared_cutoff

torch.set_num_threads(1)


# ------------------------------------------------------------ the threshold
@pytest.mark.parametrize("cutoff", [19.9, 3.6, 4.0, 1.45])
def test_squared_cutoff_decides_as_the_square_root(cutoff):
    c = np.float32(cutoff)
    t = np.float32(squared_cutoff(cutoff))
    mid = (c * c).view(np.int32)
    s = (mid + np.arange(-2000, 2001, dtype=np.int32)).view(np.float32)
    np.testing.assert_array_equal(s <= t, np.sqrt(s) < c)
    assert np.sqrt(t) < c <= np.sqrt(np.nextafter(t, np.float32(np.inf)))


def test_squared_cutoff_is_not_the_rounded_square():
    assert np.float32(squared_cutoff(19.9)) == np.float32(396.00992)
    assert np.float32(19.9) ** 2 == np.float32(396.00998)
    with pytest.raises(ValueError, match="positive cutoff"):
        squared_cutoff(0.0)


# ------------------------------------------------------- cells and the route
@pytest.mark.parametrize(
    "box, cutoff, expected",
    [
        ((40.0, 40.0, 40.0), 3.6, (11, 11, 11)),
        ((36.0, 36.0, 36.0), 3.6, (9, 9, 9)),  # L / cutoff = 10 exactly: the margin takes one
        ((30.0, 33.0, 36.0), 5.9, (5, 5, 6)),
        ((10.0, 10.0, 10.0), 6.0, (1, 1, 1)),
        ((12.0, 30.0, 7.0), 3.0, (3, 9, 2)),
    ],
)
def test_cells_per_axis_keep_the_margin(box, cutoff, expected):
    n = cells.cells_per_axis(box, cutoff)
    assert n == expected
    width = np.asarray(box) / np.asarray(n)
    assert (width >= np.float32(cutoff) * (1 + cells.CELL_MARGIN)).all()
    assert cells.cell_lists_applicable(box, cutoff) == (min(expected) >= 3)


def test_extract_route_rule():
    route = adf_kernel.extract_route
    n = 10240
    assert route([40.0] * 3, 3.6, 88, n) == "binned"  # the ADF main path
    assert route([74.27] * 3, 3.6, 88, n) == "binned"
    assert route([40.0] * 3, 3.6, adf_kernel.BINNED_MAX_K, n) == "binned"
    assert route([11.0] * 3, 3.6, 8, n) == "binned"  # three cells per axis
    # too wide for the binned route: the z window (~0.19 of the frame) is sorted
    assert route([40.0] * 3, 3.6, adf_kernel.BINNED_MAX_K + 1, n) == "sorted"
    assert route([10.0] * 3, 3.6, 88, n) == "sweep"  # two cells per axis, the window the frame
    assert route([40.0, 40.0, 10.0], 3.6, 88, n) == "sweep"  # one short axis: z
    assert route([10.0] * 3, 6.0, 2000, n) == "sweep"


# ------------------------------------------------------------------ binning
@pytest.mark.parametrize("box_l, cutoff", [(20.0, 3.6), (36.0, 3.6), (17.5, 4.1)])
def test_binning_occupancy_matches_jax_cell_table(box_l, cutoff):
    rng = np.random.default_rng(int(box_l))
    pos = rng.uniform(0, box_l, (700, 3)).astype(np.float32)
    valid = np.ones(700, bool)
    valid[-13:] = False  # padding goes to the extra cell in both
    sid = np.where(valid, 0, -1).astype(np.int32)
    n = cells.cells_per_axis([box_l] * 3, cutoff)
    assert n[0] == n[1] == n[2] >= 3
    _, jax_counts, jax_cell, _ = jax_cells.build_cell_table(
        jnp.asarray(pos), jnp.asarray([box_l] * 3, jnp.float32), n[0], 64,
        valid=jnp.asarray(valid),
    )
    cell = cells.cell_of_atoms(torch.from_numpy(pos[None]), torch.from_numpy(sid), [box_l] * 3, n, 1)
    np.testing.assert_array_equal(cell[0].numpy(), np.asarray(jax_cell))
    np.testing.assert_array_equal(
        cells.cell_occupancy(cell, int(np.prod(n)))[0].numpy(), np.asarray(jax_counts)
    )


def _face_atoms(rng, n_atoms, box, faces):
    """Atoms, a third of them with one coordinate on a multiple of a face step."""
    box = np.asarray(box, np.float32)
    pos = (rng.uniform(0, 1, (2, n_atoms, 3)) * box).astype(np.float32)
    for step in faces:
        pick = rng.integers(0, n_atoms, n_atoms // (3 * len(faces)))
        axis = rng.integers(0, 3, pick.size)
        k = rng.integers(0, int(box.max() / step) + 1, pick.size)
        pos[:, pick, axis] = np.minimum(np.float32(step) * k, box[axis]).astype(np.float32)
    pos[:, :3] = 0.0  # on the box's own faces: 0 and L
    pos[:, 3:6] = box
    return pos


def _shifted(rng, pos, box):
    """Some atoms moved by -2, -1, +1 or +2 box lengths per axis (unwrapped)."""
    out = pos.copy()
    shift = rng.integers(-2, 3, out.shape[1:]) * (rng.uniform(size=out.shape[1:]) < 0.4)
    out += (shift * np.asarray(box, np.float32)).astype(np.float32)
    return out


COVERAGE_CASES = {
    "integer L/cutoff, face atoms": ((36.0, 36.0, 36.0), 3.6, (3.6, 4.0), False),
    "integer L/cutoff, unwrapped": ((36.0, 36.0, 36.0), 3.6, (3.6,), True),
    "non-cubic, unwrapped": ((14.0, 19.5, 25.0), 4.4, (4.4,), True),
    "three cells per axis": ((12.0, 12.0, 12.0), 3.9, (3.9, 4.0), False),
}


def _listed_pairs(pos, sid, box, cutoff):
    """(F, N, N) mask of the pairs the plain extract lists, by its own test."""
    (bx, by, bz), (ibx, iby, ibz) = box_scalars(box)
    x, y, z = torch.from_numpy(pos).unbind(-1)
    dx = minimum_image(x[:, None, :] - x[:, :, None], bx, ibx)
    dy = minimum_image(y[:, None, :] - y[:, :, None], by, iby)
    dz = minimum_image(z[:, None, :] - z[:, :, None], bz, ibz)
    d = torch.sqrt(dx * dx + dy * dy + dz * dz)
    valid = torch.from_numpy((sid >= 0) & (sid < 2))
    eye = torch.eye(pos.shape[1], dtype=torch.bool)
    return ((d < float(np.float32(cutoff))) & valid[None, None, :] & valid[None, :, None] & ~eye).numpy()


@pytest.mark.parametrize("box, cutoff, faces, unwrapped", COVERAGE_CASES.values(), ids=COVERAGE_CASES)
def test_27_cells_cover_every_listed_pair(box, cutoff, faces, unwrapped):
    rng = np.random.default_rng(17)
    pos = _face_atoms(rng, 900, box, faces)
    if unwrapped:
        pos = _shifted(rng, pos, box)
    sid = (np.arange(900) % 2).astype(np.int32)
    sid[-5:] = -1
    n = cells.cells_per_axis(box, cutoff)
    assert min(n) >= 3
    pos_t, sid_t = torch.from_numpy(pos), torch.from_numpy(sid)
    listed = _listed_pairs(pos, sid, box, cutoff)
    *_, counts = neighbor_extract_reference(pos_t, sid_t, box, cutoff, 1, 2)
    np.testing.assert_array_equal(listed.sum(-1), counts.numpy())  # the same pairs
    assert listed.sum() > 1000
    cell = cells.cell_of_atoms(pos_t, sid_t, box, n, 2).numpy()
    assert (cell[:, -5:] == np.prod(n)).all() and (cell[:, :-5] < np.prod(n)).all()
    hood = cells.neighbor_cells(n)
    f, i, j = np.nonzero(listed)
    in_hood = (hood[cell[f, i]] == cell[f, j][:, None]).any(1)
    assert in_hood.all(), f"{(~in_hood).sum()} listed pairs outside the 27 cells"
