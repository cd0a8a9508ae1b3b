"""The float32 identities K1's in-box sequences rest on (``csrc/rdf_histogram.cu``),
in numpy float32, whose operations round to nearest as the kernel's ``_rn``
intrinsics do.

* ``(q + 1.5 * 2^23) - 1.5 * 2^23`` is ``rint(q)``, ties to even, for
  ``|q| < 2^22``;
* ``dx - float32(b * r)``, the general sequence's two roundings, equals
  ``dx - b * r`` rounded once (the FMA) for ``r`` in ``-2 .. 2``, where
  ``b * r`` is exact;
* ``2^23 + min(x, n_bins - 1)`` rounded down, read as an integer, less
  2^23's bits, is ``min(floor(x), n_bins - 1)`` for ``x >= 0`` and
  ``n_bins <= 2^22``;
* on atoms within one box edge of the origin (the kernel's guard), the
  in-box minimum image gives every pair the general one's squared distance;
* for ``|dx| <= b``, the folded minimum image ``min(|dx|, b - |dx|)``
  squares to the minimum image's square (``ops/geometry.py``) except near
  ``b/2``, where both squares exceed the threshold of a cutoff at the
  margin of ``ops/rdf_kernel.py::folds``; ``folds`` holds on the benchmark's
  RDF cells and not where its proof does not; on wrapped frames (atoms in
  ``[0, b]``, the fold's guard) the folded squared distances are the
  general ones.

Rounding down is emulated from the float64 sum, which is exact wherever it
decides the result (see ``_add_rd``).
"""

import numpy as np
import pytest
import torch

from lammps_analysis_tpu_torch.ops.geometry import minimum_image, squared_cutoff
from lammps_analysis_tpu_torch.ops.rdf_kernel import folds

ROUND_MAGIC = np.float32(1.5 * 2**23)
FLOOR_MAGIC = np.float32(2**23)
FLOOR_BITS = 0x4B000000


def _magic_rint(q: np.ndarray) -> np.ndarray:
    return (q + ROUND_MAGIC) - ROUND_MAGIC


def _fma(a, b, c) -> np.ndarray:
    """``a * b + c`` rounded once to float32, for ``a * b + c`` exact in
    float64 (the caller's case: ``b`` a small integer)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _add_rd(x: np.ndarray, y: np.float32) -> np.ndarray:
    """``x + y`` rounded down to float32 (``__fadd_rd``) for ``y = 2^23`` and
    ``0 <= x < 2^23``: the float64 sum is exact for ``x >= 2^-29``, and below
    it both the sum and the result lie in ``[2^23, 2^23 + 1)``."""
    s = x.astype(np.float64) + np.float64(y)
    f = s.astype(np.float32)
    return np.where(f.astype(np.float64) > s, np.nextafter(f, np.float32(-np.inf)), f)


def _bin_in_box(x: np.ndarray, n_bins: int) -> np.ndarray:
    last = np.float32(n_bins - 1)
    return _add_rd(np.minimum(x, last), FLOOR_MAGIC).view(np.int32).astype(np.int64) - FLOOR_BITS


def _min_image(dx, b, ib):
    return dx - b * np.rint(dx * ib)


def _min_image_in_box(dx, b, ib):
    return _fma(-np.full_like(dx, b), _magic_rint(dx * ib), dx)


@pytest.mark.parametrize("sample", ["half-integers", "uniform", "log-uniform"])
def test_magic_round_is_rint(sample):
    rng = np.random.default_rng(7)
    if sample == "half-integers":
        q = np.arange(-8, 9, dtype=np.float32) / np.float32(2)
        q = np.concatenate([q, np.nextafter(q, np.float32(-np.inf)), np.nextafter(q, np.float32(np.inf))])
    elif sample == "uniform":
        q = rng.uniform(-(2**22), 2**22, 10**6).astype(np.float32)
        q = q[np.abs(q) < 2**22]
    else:
        q = (np.exp2(rng.uniform(-30, 22, 10**6)) * rng.choice([-1, 1], 10**6)).astype(np.float32)
        q = q[np.abs(q) < 2**22]
    assert q.dtype == np.float32 and len(q) > 0
    assert np.array_equal(_magic_rint(q), np.rint(q))
    # ties to even, spelled out
    if sample == "half-integers":
        assert list(_magic_rint(np.float32([-1.5, -0.5, 0.5, 1.5, 2.5]))) == [-2, 0, 0, 2, 2]


@pytest.mark.parametrize("r", [-2, -1, 0, 1, 2])
@pytest.mark.parametrize("b", [114.38, 104.04, 8.0, 3.0, 2.0**-100, 2.0**100])
def test_one_rounding_of_dx_less_b_r_is_the_general_two(b, r):
    """For ``|dx| <= 2b``: ``b * r`` is exact, so rounding ``dx - b * r``
    once (the FMA) equals ``dx - float32(b * r)``."""
    rng = np.random.default_rng(int(r) + 3)
    b = np.float32(b)
    dx = (rng.uniform(-2, 2, 10**5) * b).astype(np.float32)
    dx = np.concatenate([dx, np.float32([0.0, -0.0]) * b, np.float32([-2, -1.5, -0.5, 0.5, 1.5, 2]) * b])
    rs = np.full_like(dx, np.float32(r))
    assert np.array_equal(b * rs, (np.float64(b) * rs).astype(np.float32))  # exact
    general = dx - b * rs
    exact_once = (dx.astype(np.float64) - np.float64(b) * r).astype(np.float32)
    assert np.array_equal(general, exact_once)
    assert np.array_equal(_fma(-np.full_like(dx, b), rs, dx), general)


@pytest.mark.parametrize("n_bins", [1, 2, 10, 5192, 5709, 2**22])
def test_rounded_down_floor_is_the_clamped_bin(n_bins):
    rng = np.random.default_rng(n_bins)
    ints = np.unique(np.concatenate([np.arange(min(n_bins, 4096)), rng.integers(0, n_bins, 4096),
                                     [n_bins - 1, n_bins]])).astype(np.float32)
    x = np.concatenate([
        ints, np.nextafter(ints, np.float32(np.inf)),
        np.nextafter(ints[ints > 0], np.float32(0)),
        rng.uniform(0, n_bins, 10**5).astype(np.float32),
        np.float32([0.0, 2.0**-149, 2.0**-30, 0.5, n_bins - 0.5, n_bins * 1.5, 2.0**30, 1e30]),
    ]).astype(np.float32)
    expected = np.minimum(np.floor(x).astype(np.float64), n_bins - 1).astype(np.int64)
    assert np.array_equal(_bin_in_box(x, n_bins), expected)


@pytest.mark.parametrize("box", [(114.38, 114.38, 114.38), (104.04, 104.04, 104.04),
                                 (8.0, 8.0, 8.0), (3.0, 7.3, 11.9)])
def test_in_box_minimum_image_gives_the_general_squared_distance(box):
    """Atoms within ``[-b, b]`` in each component, the edges and ties among
    them: the in-box sequences give every pair the general squared distance,
    bit for bit (the sign of a zero component may differ; its square not)."""
    rng = np.random.default_rng(11)
    b = np.float32(box)
    ib = np.float32(1) / b
    pos = (rng.uniform(-1, 1, (600, 3)) * b).astype(np.float32)
    grid = np.stack(np.meshgrid(*[np.float32([-1, -0.5, 0, 0.5, 1])] * 3, indexing="ij"), -1)
    pos = np.concatenate([pos, (grid.reshape(-1, 3) * b).astype(np.float32)])
    d = pos[:, None, :] - pos[None, :, :]
    general = [_min_image(d[..., k], b[k], ib[k]) for k in range(3)]
    in_box = [_min_image_in_box(d[..., k], b[k], ib[k]) for k in range(3)]
    for g, f in zip(general, in_box):
        assert np.array_equal(np.abs(g), np.abs(f))
    s_general = general[0] * general[0] + general[1] * general[1] + general[2] * general[2]
    s_in_box = in_box[0] * in_box[0] + in_box[1] * in_box[1] + in_box[2] * in_box[2]
    assert s_general.dtype == np.float32
    assert np.array_equal(s_general, s_in_box)


def _folded(dx, b):
    a = np.abs(dx)
    return np.minimum(a, b - a)


def _general(dx, b, ib):
    return minimum_image(torch.from_numpy(dx), float(b), float(ib)).numpy()


def _margin_cutoff(b) -> np.float32:
    """The largest float32 cutoff that ``folds`` admits on edges of ``b``."""
    limit = (1 - 2.0**-16) * float(b) / 2
    c = np.float32(limit)
    return np.nextafter(c, np.float32(0)) if float(c) > limit else c


def _ulps_around(x: np.float32, k: int) -> np.ndarray:
    """Every float32 within ``k`` ulps of ``x > 0``, both signs."""
    near = (np.int32(np.float32(x).view(np.int32)) + np.arange(-k, k + 1, dtype=np.int32))
    near = near.view(np.float32)
    return np.concatenate([near, -near])


@pytest.mark.parametrize("sample", ["uniform", "half-edge", "edge"])
@pytest.mark.parametrize("b", [114.38, 104.04, 3.0, 8.0, 2.0**-100, 2.0**100])
def test_folded_square_is_the_minimum_images_square(b, sample):
    """``|dx| <= b``: uniform, within 64 ulps of ``b/2`` and of ``b``. Where
    the folded square differs from the minimum image's, both exceed the
    threshold of a cutoff at ``folds``' margin, so the pair is rejected
    either way."""
    b = np.float32(b)
    ib = np.float32(1) / b
    if sample == "uniform":
        dx = (np.random.default_rng(5).uniform(-1, 1, 10**6) * b).astype(np.float32)
    else:
        dx = _ulps_around(b / np.float32(2) if sample == "half-edge" else b, 64)
    dx = dx[np.abs(dx) <= b]
    assert dx.dtype == np.float32 and len(dx) > 0
    general, folded = _general(dx, b, ib), _folded(dx, b)
    with np.errstate(over="ignore"):
        s_general, s_folded = general * general, folded * folded
        t = np.float32(squared_cutoff(float(_margin_cutoff(b))))
    differ = s_general != s_folded
    assert np.all(s_general[differ] > t) and np.all(s_folded[differ] > t)
    if sample == "uniform":  # away from b/2 the magnitudes are the same
        assert np.array_equal(np.abs(general), folded)


@pytest.mark.parametrize(
    "box, cutoff, n_bins, expected",
    [
        ((114.38,) * 3, 114.38 / 2 - 0.1, 5709, True),
        ((104.04,) * 3, 104.04 / 2 - 0.1, 5192, True),
        ((8.0,) * 3, float(_margin_cutoff(8.0)), 10, True),
        ((3.0, 7.3, 11.9), 1.45, 2**22, True),
        ((2.0**-60,) * 3, 2.0**-62, 10, True),
        ((2.0**100,) * 3, 2.0**98, 10, True),
        ((114.38,) * 3, 114.38 / 2, 5709, False),
        ((8.0,) * 3, float(np.nextafter(_margin_cutoff(8.0), np.float32(8))), 10, False),
        ((40.0, 30.0, 50.0), 40.0 / 2 - 0.1, 500, False),
        ((114.38,) * 3, 114.38 / 2 - 0.1, 2**22 + 1, False),
        ((2.0**-101,) * 3, 2.0**-103, 10, False),
        ((2.0**-61,) * 3, 2.0**-63, 10, False),
        ((2.0**101,) * 3, 2.0**99, 10, False),
    ],
    ids=["lj_melt_32k", "nacl_melt_32k", "at-the-margin", "non-cubic", "edge-2^-60",
         "edge-2^100", "cutoff-half-edge", "past-the-margin", "non-cubic-past-half",
         "past-2^22-bins", "edge-2^-101", "edge-2^-61", "edge-2^101"],
)
def test_fold_predicate(box, cutoff, n_bins, expected):
    """On for both RDF cells' boxes and MDSuite's default cutoff ``box/2 -
    0.1``; off for a cutoff at or past the margin below half the smallest
    edge (a non-cubic box whose ``box[0]/2 - 0.1`` passes another edge's
    half), past 2^22 bins, and for an edge outside ``[2^-60, 2^100]``."""
    assert folds(box, cutoff, n_bins) is expected


@pytest.mark.parametrize("box", [(114.38, 114.38, 114.38), (104.04, 104.04, 104.04),
                                 (8.0, 8.0, 8.0), (3.0, 7.3, 11.9)])
def test_folded_squared_distances_are_the_general_ones_on_wrapped_frames(box):
    """Atoms in ``[0, b]`` in each component, with a grid of quarter edges
    among them: every pair's folded squared distance is the general one, bit
    for bit."""
    rng = np.random.default_rng(13)
    b = np.float32(box)
    ib = np.float32(1) / b
    pos = (rng.uniform(0, 1, (600, 3)) * b).astype(np.float32)
    grid = np.stack(np.meshgrid(*[np.float32([0, 0.25, 0.5, 0.75, 1])] * 3, indexing="ij"), -1)
    pos = np.concatenate([pos, (grid.reshape(-1, 3) * b).astype(np.float32)])
    assert pos.min() >= 0 and np.all(pos <= b)
    d = pos[:, None, :] - pos[None, :, :]
    general = [_general(d[..., k], b[k], ib[k]) for k in range(3)]
    folded = [_folded(d[..., k], b[k]) for k in range(3)]
    s_general = general[0] * general[0] + general[1] * general[1] + general[2] * general[2]
    s_folded = folded[0] * folded[0] + folded[1] * folded[1] + folded[2] * folded[2]
    assert s_folded.dtype == np.float32
    assert np.array_equal(s_general, s_folded)
