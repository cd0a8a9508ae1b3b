"""The angle kernel's work split (``csrc/adf_pairs_histogram.cu``), on the CPU.

The kernel runs only on a card, so these tests hold a Python mirror of its
pair enumeration and of its host plan:

* a center's unordered pairs are the fold rows laid end to end (row d pairs
  column j with (j + d) mod m; at even m the last row d = m/2 stops after
  m/2 columns), cut into chunks of ``chunk_pairs`` flat pairs; each of the
  32 lanes of a warp places its first pair with one division and then steps
  by 32 flat pairs with adds and a compare. The mirror follows those steps
  and must cover every pair {j, k} of the first m slots exactly once, unsplit
  and cut into chunks of every size the design uses (and smaller ones);
* ``ops/adf_kernel.py::pairs_split`` (pure) sizes the chunks and the grid;
* the whole split, with the stage's compaction (a staged center keeps only
  the entries of species at least its own), summed in float64, gives the
  plain version's histogram (``ops/adf.py::adf_pairs_histogram_reference``)
  up to the order of the float64 adds; the plain version is held against
  the JAX package in ``tests/test_torch_adf_ops.py``.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from lammps_analysis_tpu_torch.ops import adf as port_adf
from lammps_analysis_tpu_torch.ops.adf_kernel import PAIRS_CHUNK, pairs_split

torch.set_num_threads(1)


def chunk_pairs(m, q0, n):
    """``(j, k, d)`` of the flat pairs ``[q0, q0 + n)`` of ``m`` entries, as
    the 32 lanes of ``add_chunk`` step through them (lanes as a vector)."""
    lanes = np.arange(min(n, 32))
    d = q0 // m
    j = q0 - d * m + lanes
    d = np.full_like(lanes, d + 1)
    if m > 32:
        step, rem = 0, 32
        wrap = j >= m
        j, d = np.where(wrap, j - m, j), d + wrap
    else:
        step, rem = 32 // m, 32 - (32 // m) * m
        rows = j // m
        j, d = j - rows * m, d + rows
    out = []
    for r0 in range(0, n, 32):
        on = r0 + lanes < n
        k = j + d
        k = np.where(k < m, k, k - m)
        out.append(np.stack([j[on], k[on], d[on]], axis=1))
        j, d = j + rem, d + step
        wrap = j >= m
        j, d = np.where(wrap, j - m, j), d + wrap
    return np.concatenate(out) if out else np.zeros((0, 3), np.int64)


def center_pairs(m, chunk, chunks):
    """Every unit's pairs of a center with ``m`` entries, ``chunks`` units of
    ``chunk`` flat pairs (units beyond its pairs are empty)."""
    parts = []
    for c in range(chunks):
        left = m * (m - 1) // 2 - c * chunk
        if left > 0:
            parts.append(chunk_pairs(m, c * chunk, min(left, chunk)))
    return np.concatenate(parts) if parts else np.zeros((0, 3), np.int64)


def _assert_every_pair_once(m, chunk):
    n_pairs = m * (m - 1) // 2
    chunks = max(1, -(-n_pairs // chunk))
    got = center_pairs(m, chunk, chunks)
    assert len(got) == n_pairs
    unordered = np.sort(got[:, :2], axis=1)
    expect = np.array(list(itertools.combinations(range(m), 2)), np.int64).reshape(-1, 2)
    np.testing.assert_array_equal(np.unique(unordered, axis=0), expect)
    # fold rows: each row d < m/2 whole, the half row d = m/2 at even m
    rows, per_row = np.unique(got[:, 2], return_counts=True)
    whole = max(0, (m - 1) // 2)
    np.testing.assert_array_equal(rows[:whole], np.arange(1, whole + 1))
    assert (per_row[:whole] == m).all()
    if m % 2 == 0 and m > 0:
        assert rows[-1] == m // 2 and per_row[-1] == m // 2
    assert len(rows) == whole + (m % 2 == 0 and m > 0)


# PAIRS_CHUNK is the design's; 10**9 is unsplit; the rest cut finer
@pytest.mark.parametrize("chunk", [7, 31, 32, 33, 100, 256, PAIRS_CHUNK, 10**9])
def test_enumeration_covers_every_pair_once_up_to_200(chunk):
    for m in range(0, 201):
        _assert_every_pair_once(m, chunk)


@pytest.mark.parametrize("chunk", [PAIRS_CHUNK, 10**9])
def test_enumeration_covers_every_pair_once_at_k_1076(chunk):
    _assert_every_pair_once(1076, chunk)


# ------------------------------------------------------------- pairs_split
@pytest.mark.parametrize(
    "n_frames, n_atoms, k_n, resident, warps, expected",
    [
        (1, 10240, 88, 396, 16, (5, 396)),  # the main path: 4 chunks raised to 5, prime to 6336
        (16, 10240, 88, 396, 16, (5, 24)),  # frames share one wave of blocks
        (64, 10240, 88, 396, 16, (5, 6)),
        (1000, 10240, 88, 396, 16, (5, 1)),  # more frames than resident blocks
        (1, 5, 8, 396, 16, (1, 1)),  # no more blocks than units
        (1, 1304, 1076, 396, 16, (565, 396)),  # K = 1076: 565 chunks, prime to 6336
        (1, 2000, 1648, 396, 16, (1327, 396)),  # K = 1648: 1326 raised to 1327
        (3, 100, 1, 396, 16, (1, 7)),  # K = 1: no pairs, one empty unit a center
    ],
)
def test_pairs_split_plans(n_frames, n_atoms, k_n, resident, warps, expected):
    assert pairs_split(n_frames, n_atoms, k_n, resident, warps, 1024) == expected


def test_pairs_split_invariants():
    rng = np.random.default_rng(0)
    for _ in range(500):
        n_frames, n_atoms = int(rng.integers(1, 200)), int(rng.integers(1, 70000))
        k_n, resident = int(rng.integers(1, 3000)), int(rng.integers(1, 1000))
        warps, chunk = int(rng.choice([8, 16, 32])), int(rng.choice([64, 1024, 4096]))
        chunks, blocks = pairs_split(n_frames, n_atoms, k_n, resident, warps, chunk)
        assert chunks * chunk >= k_n * (k_n - 1) // 2
        assert math.gcd(chunks, blocks * warps) == 1
        assert 1 <= blocks <= max(1, resident // n_frames)
        assert (blocks - 1) * warps < n_atoms * chunks


# ------------------------------------------- the split's histogram, mirrored
def mirror_histogram(rx, ry, rz, d, sid_n, counts, sid_c, n_bins, n_species, p, stage, chunk):
    """The kernel's pairs, unit by unit: staged centers (at most ``stage``
    entries) keep the entries of species >= their own, in slot order, and
    enumerate all their pairs; wider ones enumerate every pair of their m
    slots and drop by species. Weights as the plain version computes them,
    summed in float64."""
    f, n, k = rx.shape
    n_triples = port_adf.n_triples_for(n_species)
    out = torch.zeros(f * n_triples * n_bins, dtype=torch.float64)
    chunks = max(1, -(-(k * (k - 1) // 2) // chunk))
    sn = port_adf._valid_species(sid_n, n_species)
    sc = port_adf._valid_species(sid_c, n_species)
    inv_bw = port_adf.bin_scale(n_bins)
    for fr, c in itertools.product(range(f), range(n)):
        sa, m = int(sc[c]), min(int(counts[fr, c]), k)
        if sa < 0 or m < 2:
            continue
        slots = np.arange(m)
        if m <= stage:
            slots = slots[sn[fr, c, :m].numpy() >= sa]
        pairs = center_pairs(len(slots), chunk, chunks)
        if len(pairs) == 0:
            continue
        j = torch.from_numpy(slots[pairs[:, 0]])
        kk = torch.from_numpy(slots[pairs[:, 1]])
        s_j, s_k = sn[fr, c, j], sn[fr, c, kk]
        b, cc = torch.minimum(s_j, s_k), torch.maximum(s_j, s_k)
        keep = (b >= 0) & (b >= sa)
        j, kk, s_j, s_k, b, cc = (t[keep] for t in (j, kk, s_j, s_k, b, cc))
        g = rx[fr, c, j] * rx[fr, c, kk] + ry[fr, c, j] * ry[fr, c, kk] + rz[fr, c, j] * rz[fr, c, kk]
        denom = d[fr, c, j] * d[fr, c, kk]
        denom = torch.where(denom > 0, denom, 1.0)
        theta = torch.acos(torch.clamp(g / denom, -1.0, 1.0))
        bins = torch.clamp(torch.floor(theta * inv_bw), max=n_bins - 1).to(torch.int64)
        w = port_adf.int_power(torch.reciprocal(denom), p)
        w = torch.where(s_j == s_k, w + w, w)
        t = port_adf.triple_index(sa, b, cc, n_species)
        out.index_add_(0, (fr * n_triples + t) * n_bins + bins, w.to(torch.float64))
    return out.view(f, n_triples, n_bins)


def _edge_lists(seed, n_frames=2, n_atoms=60, k_n=40, n_species=2):
    """Seeded lists with counts 0, 1, 2, 32, 33, K and above K, padding ids
    (-1 and S) among the neighbors and the centers, some zero vectors."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(3, n_frames, n_atoms, k_n)).astype(np.float32)
    r[:, rng.random((n_frames, n_atoms, k_n)) < 0.02] = 0.0
    dist = np.sqrt((r * r).sum(0), dtype=np.float32)
    ids = np.arange(-1, n_species + 1, dtype=np.int32)
    sid_n = rng.choice(ids, size=(n_frames, n_atoms, k_n))
    counts = rng.choice(np.array([0, 1, 2, 32, 33, k_n, k_n + 3], np.int32), size=(n_frames, n_atoms))
    sid_c = rng.choice(ids, size=n_atoms).astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (*r, dist, sid_n)] + [
        torch.from_numpy(counts), torch.from_numpy(sid_c)
    ]


@pytest.mark.parametrize(
    "n_species, p, stage, chunk",
    [
        (2, 4, 128, PAIRS_CHUNK),  # every center staged
        (2, 4, 8, PAIRS_CHUNK),  # wide centers from the lists, narrow ones staged
        (3, 2, 128, 50),  # centers cut into chunks
        (3, 0, 8, 7),
        (1, 4, 33, 100),
    ],
)
def test_split_sums_to_the_plain_histogram(n_species, p, stage, chunk):
    lists = _edge_lists(seed=n_species * 10 + p, n_species=n_species)
    args = (*lists, 73, n_species, p)
    ours = mirror_histogram(*args, stage=stage, chunk=chunk)
    plain = port_adf.adf_pairs_histogram_reference(*args)
    assert float(plain.sum()) > 0
    # float64 sums of the same float32 weights in another order
    np.testing.assert_allclose(ours.numpy(), plain.double().numpy(), rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(ours.to(torch.float32).numpy() != 0, plain.numpy() != 0)
