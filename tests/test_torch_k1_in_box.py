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
  in-box minimum image gives every pair the general one's squared distance.

Rounding down is emulated from the float64 sum, which is exact wherever it
decides the result (see ``_add_rd``).
"""

import numpy as np
import pytest

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
