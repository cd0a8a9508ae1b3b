"""The CUDA kernels against their plain torch versions, on a GPU.

Small versions of the kernel phase of ``chip_smoke.py``: the pair histogram
(``csrc/rdf_histogram.cu`` through ``ops/rdf_kernel.py``, in each of its
five histogram layouts, and at the LJ shape in one that leaves at least 32
warps resident on an SM) must equal ``rdf_histogram_reference`` bin for bin,
by its in-box sequences and by its general ones (coordinates beyond a box,
warps split between the two, ties of the rounding and the box's edge, a
bin clamped to ``n_bins - 1``, more than 2^22 bins), each with the count of
sweeps that took the general sequences (``rdf_kernel.general_sweeps``),
and by its folded minimum image in every layout at 1 and 3 species
(wrapped positions fold; a centred box, a span above the box and a cutoff at
half the edge take the in-box sequences, counted by
``rdf_kernel.unfolded_sweeps``; a shape two boxes out the general ones; row
stripes add up to the whole);
both routes of the neighbor extract (the sweep ``csrc/adf_neighbor_extract.cu``
and the cell lists ``csrc/adf_neighbor_cells.cu``) must equal
``neighbor_extract_reference`` exactly (the binned route on every row whose
count fits K, and on ``counts`` everywhere); the angle histogram
(``csrc/adf_pairs_histogram.cu``, any K and histogram size, wide lists cut
into chunks, several frames a launch, edge counts and padding) must agree
with ``adf_pairs_histogram_reference`` within the JAX package's ADF
tolerance (totals rtol 1e-5; at most max(2, size // 64) bins outside rtol
1e-4: its float64 atomics sum in another order), on the same tensors.
The transport slice, which has no hand-written kernel, runs its Einstein and
Green-Kubo calculators from a small dump on the card and on the CPU, which
must agree within the transport tolerance (``tests/torch_dumps.py``); so do
the conductivity path and the molecular path (a small water box from a TRR,
``tests/torch_water.py``). So do the distinct diffusion pair (the distinct
tolerance), the spatial distribution function (counts within the SDF's
tolerance: ``arccos``/``atan2`` may round apart by an ulp) and the fused
unwrap stream (on the card equal to the card's materialised run bit for bit).
The windowed ACF's pack kernel (``csrc/acf_power.cu`` through
``ops/correlation.py::acf_pack``) must equal ``acf_pack_reference`` exactly
(GK self-diffusion's batch with fewer ions, a ragged last batch into a
reused buffer, a lag table, S = 3, 5, 17 and 33), and a buffer's zero tail
must survive a second batch and cuFFT's R2C; its power sum must agree with
``acf_power_sum_reference`` within 1e-12 on every bin and repeat bit for
bit; ``windowed_acf_sum`` on the card takes no plain batch and launches
each kernel once a batch.
The two stripe modes of the multi-device layer, K1's i-row range and K2's
center stripe on both routes, must equal their plain versions and the rows
of the full launch exactly; the sharded ops in a world of four ranks that
share the card (gloo) and the calculators in a world of one on NCCL must
give the one-process result (``tests/torch_worlds.py``).
Marked ``cuda``; without a CUDA device every test skips. On a machine with a
card: ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from lammps_analysis_tpu_torch.ops import adf_kernel, rdf_kernel
from lammps_analysis_tpu_torch.ops.adf import (
    adf_pairs_histogram_reference,
    neighbor_extract_reference,
)
from lammps_analysis_tpu_torch.ops.rdf import build_species_layout, rdf_histogram_reference
from lammps_analysis_tpu_torch.utils.profiling import counters

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


#: the ``k1.layout.*`` counter of each ``histogram_mode`` name
LAYOUT_COUNTER = {name: f"k1.layout.{suffix}" for name, suffix in rdf_kernel.LAYOUTS.values()}


@pytest.mark.parametrize(
    "counts, n_frames, box, cutoff, n_bins, mode",
    [
        ([640, 640], 2, (20.0, 20.0, 20.0), 9.9, 500, "shared4"),  # 1500 words: 4 copies
        ([400, 350, 245], 3, (30.0, 33.0, 36.0), 9.9, 75, "warp"),  # ragged, padded
        ([700, 600], 2, (20.0, 20.0, 20.0), 9.9, 5000, "block"),  # 15000 bins: one per block
        ([200, 200, 200, 200], 2, (16.0, 16.0, 16.0), 7.9, 6000, "global"),
        ([5], 1, (3.0, 3.0, 3.0), 1.45, 10, "warp"),  # fewer atoms than one tile
        ([1500, 1100], 1, (25.0, 25.0, 25.0), 12.4, 200, "warp"),  # odd tile count (21)
        ([2600], 2, (26.0, 26.0, 26.0), 12.9, 3000, "shared2"),  # 3000 words: 2 copies
    ],
    ids=["bench-like", "ragged", "block-histogram", "global-atomics", "tiny", "odd-tiles",
         "two-copies"],
)
def test_kernel_matches_plain_bin_for_bin(cuda, counts, n_frames, box, cutoff, n_bins, mode):
    pos, sid = _case(counts, n_frames, box, seed=len(counts), device=cuda)
    args = (pos, sid, box, cutoff, n_bins, len(counts))
    assert rdf_kernel.histogram_mode(len(counts), n_bins) == mode
    launches, by_layout = counters["k1.launches"], counters[LAYOUT_COUNTER[mode]]
    h_kernel = rdf_kernel.rdf_histogram(*args)
    torch.cuda.synchronize()
    assert counters["k1.launches"] == launches + 1
    assert counters[LAYOUT_COUNTER[mode]] == by_layout + 1
    h_plain = rdf_histogram_reference(*args)
    assert h_kernel.dtype == torch.int64 and h_kernel.shape == h_plain.shape
    assert int(h_kernel.sum()) > 0
    assert torch.equal(h_kernel, h_plain)


def test_lj_shape_takes_a_layout_of_at_least_32_resident_warps(cuda):
    """One species at MDSuite's defaults (0.01 A bins, cutoff box/2 - 0.1) at
    LAMMPS' in.lj density: 5709 bins, whose per-warp copies would leave one
    8-warp block an SM."""
    box_l, n_atoms = 57.2, 4096
    box = (box_l, box_l, box_l)
    pos, sid = _case([n_atoms], 2, box, seed=18, device=cuda)
    args = (pos, sid, box, box_l / 2 - 0.1, 5709, 1)
    layout = rdf_kernel.histogram_layout(1, 5709)
    assert layout.blocks_per_sm * 8 >= 32
    before = counters.copy()
    h_kernel = rdf_kernel.rdf_histogram(*args)
    torch.cuda.synchronize()
    moved = {name: n for name, n in (counters - before).items() if name.startswith("k1.")}
    assert moved == {"k1.launches": 1, LAYOUT_COUNTER[layout.mode]: 1, "k1.pair_rows": 1}
    assert torch.equal(h_kernel, rdf_histogram_reference(*args))


@pytest.mark.parametrize("n_species, n_bins, blocks", [(1, 5709, 6), (2, 5192, 3)],
                         ids=["lj_melt_32k", "nacl_melt_32k"])
def test_benchmark_shapes_keep_their_resident_blocks(cuda, n_species, n_bins, blocks):
    """The RDF cells' histograms (MDSuite's default bins) keep one copy a
    block and the blocks an SM that 40 registers a thread leave them."""
    assert rdf_kernel.histogram_layout(n_species, n_bins) == ("block", 1, blocks)


def test_kernel_treats_out_of_range_species_as_padding(cuda):
    pos, sid = _case([100, 60], 2, (8.0, 8.0, 8.0), seed=3, device=cuda)
    sid[10:20] = 5  # not a species of a 2-species layout
    args = (pos, sid, (8.0, 8.0, 8.0), 3.9, 40, 2)
    assert torch.equal(rdf_kernel.rdf_histogram(*args), rdf_histogram_reference(*args))


def test_kernel_rejects_cpu_species_with_cuda_positions(cuda):
    pos, sid = _case([64], 1, (6.0, 6.0, 6.0), seed=1, device=cuda)
    with pytest.raises(ValueError, match="species_id on cpu"):
        rdf_kernel.rdf_histogram(pos, sid.cpu(), (6.0, 6.0, 6.0), 2.9, 10, 1)


def _general_sweeps_of(*args, rows=None):
    """K1's histogram of ``args`` and the j-chunk sweeps that took the
    general sequences in its launch."""
    before = rdf_kernel.general_sweeps()
    h = rdf_kernel.rdf_histogram(*args, rows=rows)
    return h, rdf_kernel.general_sweeps() - before


@pytest.mark.parametrize(
    "counts, box, cutoff, n_bins, mode",
    [
        ([300, 260], (12.0, 13.0, 14.0), 5.9, 500, "shared4"),
        ([200, 200, 200, 200], (16.0, 16.0, 16.0), 7.9, 6000, "global"),
    ],
    ids=["shared", "global-atomics"],
)
def test_kernel_far_outside_the_box_takes_the_general_sequences(cuda, counts, box, cutoff,
                                                                 n_bins, mode):
    """Coordinates up to four boxes out on either side, negative too: every
    sweep takes today's sequences, and the counts stay the plain version's."""
    pos, sid = _case(counts, 2, box, seed=41, device=cuda)
    rng = np.random.default_rng(41)
    images = rng.integers(-4, 5, size=pos.shape).astype(np.float32) * np.asarray(box, np.float32)
    pos += torch.from_numpy(images).to(cuda)
    args = (pos, sid, box, cutoff, n_bins, len(counts))
    assert rdf_kernel.histogram_mode(len(counts), n_bins) == mode
    h_kernel, general = _general_sweeps_of(*args)
    assert general > 0
    assert int(h_kernel.sum()) > 0
    assert torch.equal(h_kernel, rdf_histogram_reference(*args))


def test_kernel_splits_warps_between_the_sequences(cuda):
    """Frame 0 lies in ``[0, box)``; in frame 1 a few atoms lie outside
    ``[-box, box]``, so only the warps whose tile or chunk holds one take the
    general sequences. Row stripes split them too."""
    counts, box = [700, 600], (20.0, 21.0, 22.0)
    pos, sid = _case(counts, 2, box, seed=42, device=cuda)
    pos[1, 100:140, 0] += 3 * box[0]
    pos[1, 900:905, 1] -= 1.5 * box[1]
    args = (pos, sid, box, 9.9, 500, len(counts))
    h_first, general = _general_sweeps_of(pos[:1].contiguous(), *args[1:])
    assert general == 0
    assert torch.equal(h_first, rdf_histogram_reference(pos[:1].contiguous(), *args[1:]))
    h_kernel, general = _general_sweeps_of(*args)
    assert general > 0
    assert torch.equal(h_kernel, rdf_histogram_reference(*args))
    for rows in ((0, 384), (384, pos.shape[1])):
        stripe, _ = _general_sweeps_of(*args, rows=rows)
        assert torch.equal(stripe, rdf_histogram_reference(*args, rows=rows))


def test_kernel_rounds_ties_and_the_box_edge_as_the_general_sequences(cuda):
    """A power-of-two box (``1/box`` exact) with atoms on a grid of half
    boxes from ``-box`` to ``box``: ``dx / box`` lands on 0, +-0.5, +-1,
    +-1.5 and +-2 exactly, so the in-box rounding meets its ties (to even)
    and the guard's edge ``|c| = box``; the rest are random within
    ``[-box, box]``. No sweep leaves the in-box sequences."""
    box = (8.0, 8.0, 8.0)
    grid = np.stack(np.meshgrid(*[np.arange(-8.0, 8.5, 4.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(43)
    counts = [len(grid) + 75, 200]
    sid, n_pad, _, _, _ = build_species_layout(counts, pad_to=8)
    pos = np.zeros((2, n_pad, 3), np.float32)
    pos[:, : len(grid)] = grid
    pos[:, len(grid): sum(counts)] = rng.uniform(-8.0, 8.0, (2, sum(counts) - len(grid), 3))
    pos = torch.from_numpy(pos).to(cuda)
    args = (pos, torch.from_numpy(sid).to(cuda), box, 3.95, 79, len(counts))
    h_kernel, general = _general_sweeps_of(*args)
    assert general == 0
    assert torch.equal(h_kernel, rdf_histogram_reference(*args))


def test_kernel_clamps_a_bin_rounded_up_to_n_bins(cuda):
    """A pair just inside the cutoff whose ``d * n_bins / cutoff`` rounds up
    to ``n_bins``: the in-box bin clamps it into the last bin, as the plain
    version's ``min`` does."""
    n_bins = 100
    for cut in np.linspace(6.0, 7.0, 4001, dtype=np.float32):
        inv = np.float32(n_bins) / cut
        d = np.nextafter(cut, np.float32(0))
        root = np.float32(np.sqrt(np.float64(d * d)))
        if root < cut and np.float32(root * inv) >= n_bins:
            break
    else:
        raise AssertionError("no cutoff in [6, 7] rounds a kept pair up to n_bins")
    box = (16.0, 16.0, 16.0)
    pos, sid = _case([300, 100], 1, box, seed=44, device=cuda)
    pos[0, 0] = torch.tensor([0.0, 0.0, 0.0])
    pos[0, 1] = torch.tensor([float(d), 0.0, 0.0])
    args = (pos, sid, box, float(cut), n_bins, 2)
    h_kernel, general = _general_sweeps_of(*args)
    assert general == 0
    h_plain = rdf_histogram_reference(*args)
    assert int(h_plain[0, -1]) > 0
    assert torch.equal(h_kernel, h_plain)


@pytest.mark.parametrize("n_bins, general", [(2**22, False), (2**22 + 1, True)],
                         ids=["2^22-bins", "past-2^22-bins"])
def test_kernel_past_2_22_bins_takes_the_general_sequences(cuda, n_bins, general):
    """The in-box bin holds up to 2^22 bins; past them the host sends every
    sweep to the general sequences, on the same wrapped positions."""
    box = (10.0, 10.0, 10.0)
    pos, sid = _case([300], 2, box, seed=45, device=cuda)
    args = (pos, sid, box, 4.9, n_bins, 1)
    h_kernel, sweeps = _general_sweeps_of(*args)
    assert (sweeps > 0) == general
    assert torch.equal(h_kernel, rdf_histogram_reference(*args))


def _sweeps_of(*args, rows=None):
    """K1's histogram of ``args`` and the j-chunk sweeps of its launch that
    took the general sequences and the in-box ones unfolded."""
    general, unfolded = rdf_kernel.general_sweeps(), rdf_kernel.unfolded_sweeps()
    h = rdf_kernel.rdf_histogram(*args, rows=rows)
    return h, rdf_kernel.general_sweeps() - general, rdf_kernel.unfolded_sweeps() - unfolded


#: histogram words (species-pair rows x bins) that take each layout
ROUTE_WORDS = {"warp": 450, "shared4": 1500, "shared2": 3000, "block": 15000, "global": 60000}
#: per placement: the box, the cutoff, a shift of the wrapped positions in
#: boxes, and the route every sweep takes
PLACEMENTS = {
    "wrapped": ((12.0, 13.0, 14.0), 5.9, (0.0, 0.0, 0.0), "fold"),
    "centred": ((12.0, 13.0, 14.0), 5.9, (-0.5, -0.5, -0.5), "in-box"),
    "span-above-box": ((12.0, 13.0, 14.0), 5.9, None, "in-box"),
    "two-boxes-out": ((114.38, 114.38, 114.38), 57.09, (2.0, 0.0, 0.0), "general"),
    "cutoff-half-edge": ((12.0, 13.0, 14.0), 6.0, (0.0, 0.0, 0.0), "in-box"),
    "stripes": ((12.0, 13.0, 14.0), 5.9, (0.0, 0.0, 0.0), "fold"),
}


@pytest.mark.parametrize("placement", list(PLACEMENTS))
@pytest.mark.parametrize("n_species", [1, 3])
@pytest.mark.parametrize("mode", list(ROUTE_WORDS))
def test_kernel_routes_match_plain_in_every_layout(cuda, mode, n_species, placement):
    """Wrapped positions fold every sweep; a centred box, positions in
    ``[-b, b]`` (a span above ``b``) and a cutoff at half the smallest edge
    take the in-box sequences; LJ's box moved two boxes out the general
    ones. The counters say which; the counts are the plain version's bin for
    bin, and row stripes add up to the whole."""
    box, cutoff, shift, route = PLACEMENTS[placement]
    counts = [1300] if n_species == 1 else [500, 450, 350]
    n_bins = ROUTE_WORDS[mode] // (n_species * (n_species + 1) // 2)
    pos, sid = _case(counts, 2, box, seed=46 + n_species, device=cuda)
    n = sum(counts)
    edges = torch.tensor(box, dtype=torch.float32, device=cuda)
    if shift is None:
        pos[:, :n] = pos[:, :n] * 2 - edges
    else:
        pos[:, :n] += torch.tensor(shift, dtype=torch.float32, device=cuda) * edges
    args = (pos, sid, box, cutoff, n_bins, n_species)
    assert rdf_kernel.folds(box, cutoff, n_bins) == (placement != "cutoff-half-edge")
    assert rdf_kernel.histogram_mode(n_species, n_bins) == mode
    h_kernel, general, unfolded = _sweeps_of(*args)
    assert (general > 0, unfolded > 0) == {"fold": (False, False), "in-box": (False, True),
                                           "general": (True, False)}[route]
    h_plain = rdf_histogram_reference(*args)
    assert int(h_plain.sum()) > 0
    assert torch.equal(h_kernel, h_plain)
    if placement == "stripes":
        total = torch.zeros_like(h_plain)
        for rows in ((0, 300), (300, 900), (900, pos.shape[1])):
            stripe, general, unfolded = _sweeps_of(*args, rows=rows)
            assert (general, unfolded) == (0, 0)
            assert torch.equal(stripe, rdf_histogram_reference(*args, rows=rows))
            total += stripe
        assert torch.equal(total, h_plain)


# ---------------------------------------------------------------- ADF, K2 and K3
def _adf_lists(counts, n_frames, box, cutoff, k_n, seed, device):
    pos, sid = _case(counts, n_frames, box, seed=seed, device=device)
    return pos, sid, (pos, sid, box, cutoff, k_n, len(counts))


@pytest.mark.parametrize(
    "counts, n_frames, box, cutoff, k_n",
    [
        ([640, 640], 2, (20.0, 20.0, 20.0), 3.6, 48),  # first shell
        ([400, 350, 245], 3, (30.0, 33.0, 36.0), 5.9, 88),  # ragged, padded
        ([300], 1, (5.0, 5.0, 5.0), 2.4, 16),  # dense: counts exceed K
        ([5], 1, (3.0, 3.0, 3.0), 2.9, 8),  # fewer atoms than one block
    ],
    ids=["first-shell", "ragged", "saturated", "tiny"],
)
def test_neighbor_extract_matches_plain_exactly(cuda, counts, n_frames, box, cutoff, k_n):
    """The sweep on every case, and the routed extract through its route."""
    pos, sid, args = _adf_lists(counts, n_frames, box, cutoff, k_n, len(counts), cuda)
    sid[1:3] = len(counts)  # out of range: padding
    plain = neighbor_extract_reference(*args)
    assert int(plain[5].sum()) > 0
    launches = counters["k2.launches.sweep"]
    ours = adf_kernel.neighbor_extract_sweep(*args)
    torch.cuda.synchronize()
    assert counters["k2.launches.sweep"] == launches + 1
    for a, b in zip(ours, plain):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    route = adf_kernel.extract_route(box, cutoff, k_n, pos.shape[1])
    launches = counters[f"k2.launches.{route}"]
    ours = adf_kernel.neighbor_extract(*args)
    torch.cuda.synchronize()
    assert counters[f"k2.launches.{route}"] == launches + 1
    _assert_lists_equal_where_unsaturated(ours, plain, k_n)


def _assert_lists_equal_where_unsaturated(ours, plain, k_n):
    """Exact on every row whose count fits K; ``counts`` exact everywhere."""
    assert torch.equal(ours[5], plain[5])
    fits = plain[5] <= k_n
    for a, b in zip(ours[:5], plain[:5]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a[fits], b[fits])


BINNED_CASES = {
    "first-shell": ([1200, 1200], 2, (26.0, 26.0, 26.0), 3.6, 48, None),
    "ragged-noncubic": ([1400, 1350, 1245], 2, (30.0, 33.0, 36.0), 5.9, 96, None),
    "integer-L-over-cutoff": ([2500, 2500], 1, (36.0, 36.0, 36.0), 3.6, 64, "faces"),
    "unwrapped": ([2500, 2500], 2, (36.0, 36.0, 36.0), 3.6, 64, "unwrapped"),
    "saturated": ([6000], 1, (20.0, 20.0, 20.0), 3.4, 128, None),
}


@pytest.mark.parametrize(
    "counts, n_frames, box, cutoff, k_n, layout", BINNED_CASES.values(), ids=BINNED_CASES
)
def test_binned_extract_matches_plain(cuda, counts, n_frames, box, cutoff, k_n, layout):
    pos, sid = _case(counts, n_frames, box, seed=5, device=cuda)
    sid[7:9] = len(counts)  # out of range: padding, in no cell
    edges = torch.tensor(box, device=cuda)
    if layout == "faces":  # a third of the atoms with x on a multiple of the cutoff
        pos[:, ::3, 0] = torch.floor(pos[:, ::3, 0] / 3.6) * np.float32(3.6)
        pos[:, :2] = edges  # exactly L: wraps to 0
    if layout == "unwrapped":  # a third of the atoms one or two boxes away
        pos[:, ::3] += torch.tensor([1.0, -2.0, 2.0], device=cuda) * edges
        pos[:, 1::5] -= edges
    args = (pos, sid, box, cutoff, k_n, len(counts))
    launches = counters["k2.launches.binned"]
    ours = adf_kernel.neighbor_extract_binned(*args)
    torch.cuda.synchronize()
    assert counters["k2.launches.binned"] == launches + 1
    plain = neighbor_extract_reference(*args)
    _assert_lists_equal_where_unsaturated(ours, plain, k_n)
    assert int(plain[5].sum()) > 0
    if layout is None and counts == [6000]:
        assert int(plain[5].max()) > k_n


@pytest.mark.parametrize(
    "counts, n_bins, p, hist",
    [
        ([640, 640], 500, 4, "shared"),
        ([640, 640], 500, 0, "shared"),
        ([400, 350, 245], 500, 2, "shared"),  # 10 triples
        ([300, 300, 300, 300], 3000, 4, "global"),  # 20 triples x 3000 bins: global atomics
    ],
    ids=["2sp-p4", "2sp-p0", "3sp", "global-atomics"],
)
def test_pairs_histogram_matches_plain(cuda, counts, n_bins, p, hist):
    box = (20.0, 21.0, 22.0)
    pos, sid, args = _adf_lists(counts, 2, box, 3.9, 96, 11, cuda)
    *lists, n_in = adf_kernel.neighbor_extract(*args)
    assert int(n_in.max()) <= 96
    s = len(counts)
    route = adf_kernel.pairs_histogram_route(s, n_bins, 96, pos.shape[1], 2)
    assert route.histogram == hist and route.chunks_per_center >= 5  # 4560 pairs at K = 96
    launches = counters["k3.launches"]
    ours = adf_kernel.adf_pairs_histogram(*lists, n_in, sid, n_bins, s, p)
    torch.cuda.synchronize()
    assert counters["k3.launches"] == launches + 1
    _assert_adf_close(ours, adf_pairs_histogram_reference(*lists, n_in, sid, n_bins, s, p))


def _assert_adf_close(ours, plain):
    """The ADF allowance: totals rtol 1e-5, at most max(2, size // 64) bins
    outside rtol 1e-4 (float64 atomics add in another order)."""
    ours, plain = ours.double().cpu().numpy(), plain.double().cpu().numpy()
    assert ours.shape == plain.shape and plain.sum() > 0
    np.testing.assert_allclose(ours.sum(), plain.sum(), rtol=1e-5)
    bad = ~np.isclose(ours, plain, rtol=1e-4, atol=1e-6)
    assert bad.sum() <= max(2, plain.size // 64), f"{bad.sum()} bins differ"
    print(f"max |diff| {np.abs(ours - plain).max()}")


@pytest.mark.parametrize(
    "n_atoms, n_bins, hist",
    [
        (1300, 500, "shared"),
        (2000, 500, "shared"),
        (1300, 30000, "global"),  # 240 KB of float64 bins: no shared histogram
    ],
    ids=["K-1100-staged", "K-1800-from-global", "K-1100-global-histogram"],
)
def test_pairs_histogram_takes_lists_wider_than_1024(cuda, n_atoms, n_bins, hist):
    """10 A box, 6 A cutoff: about 1100 and 1800 neighbors per center, each
    cut into hundreds of chunks over every SM."""
    box = (10.0, 10.0, 10.0)
    pos, sid, args = _adf_lists([n_atoms], 1, box, 6.0, n_atoms, 23, cuda)
    *_, n_in = neighbor_extract_reference(*args[:4], 1, 1)
    k_n = int(n_in.max())
    assert k_n > 1024
    *lists, n_in = adf_kernel.neighbor_extract(*args[:4], k_n, 1)
    route = adf_kernel.pairs_histogram_route(1, n_bins, k_n, pos.shape[1])
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert route.histogram == hist and route.chunks_per_center > 100
    assert route.blocks_per_frame >= n_sms
    ours = adf_kernel.adf_pairs_histogram(*lists, n_in, sid, n_bins, 1, 4)
    _assert_adf_close(ours, adf_pairs_histogram_reference(*lists, n_in, sid, n_bins, 1, 4))


def test_pairs_histogram_main_path_frame_fills_the_card(cuda):
    """One frame of the ADF main path (10240 atoms, 40 A, 3.6 A, K = 88):
    one wave of blocks on every SM."""
    box = (40.0, 40.0, 40.0)
    pos, sid, args = _adf_lists([5120, 5120], 1, box, 3.6, 88, 31, cuda)
    *lists, n_in = adf_kernel.neighbor_extract(*args)
    assert int(n_in.max()) <= 88
    route = adf_kernel.pairs_histogram_route(2, 500, 88, pos.shape[1])
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert route.histogram == "shared" and route.blocks_per_frame % n_sms == 0
    ours = adf_kernel.adf_pairs_histogram(*lists, n_in, sid, 500, 2, 4)
    _assert_adf_close(ours, adf_pairs_histogram_reference(*lists, n_in, sid, 500, 2, 4))


def test_pairs_histogram_many_frames_in_one_launch(cuda):
    """Eight main-path frames in one launch: each its own histogram."""
    box = (40.0, 40.0, 40.0)
    pos, sid, args = _adf_lists([5120, 5120], 8, box, 3.6, 88, 32, cuda)
    *lists, n_in = adf_kernel.neighbor_extract(*args)
    ours = adf_kernel.adf_pairs_histogram(*lists, n_in, sid, 500, 2, 4)
    plain = adf_pairs_histogram_reference(*lists, n_in, sid, 500, 2, 4)
    for f in range(8):
        _assert_adf_close(ours[f], plain[f])


def test_pairs_histogram_mixed_widths(cuda):
    """First shells and a dense cluster of a few hundred neighbors in one
    frame: staged narrow lists and wide lists cut into chunks, one launch."""
    box = (40.0, 40.0, 40.0)
    pos, sid = _case([5120, 5120], 1, box, seed=33, device=cuda)
    rng = np.random.default_rng(34)
    pos[0, :400] = torch.from_numpy(rng.uniform(20.0, 23.0, (400, 3)).astype(np.float32)).to(cuda)
    *_, n_in = neighbor_extract_reference(pos, sid, box, 3.6, 1, 2)
    k_n = -(-int(n_in.max()) // 8) * 8
    assert k_n > 200
    *lists, n_in = adf_kernel.neighbor_extract(pos, sid, box, 3.6, k_n, 2)
    assert adf_kernel.pairs_histogram_route(2, 500, k_n, pos.shape[1]).chunks_per_center > 1
    ours = adf_kernel.adf_pairs_histogram(*lists, n_in, sid, 500, 2, 4)
    _assert_adf_close(ours, adf_pairs_histogram_reference(*lists, n_in, sid, 500, 2, 4))


@pytest.mark.parametrize("k_n", [40, 200])  # every list staged; the wide ones from global memory
def test_pairs_histogram_edge_counts(cuda, k_n):
    """Centers with 0, 1, 2, 32, 33, K and more than K entries, padding ids
    (-1 and S) among neighbors and centers, zero-length entries."""
    rng = np.random.default_rng(k_n)
    n_frames, n_atoms = 2, 3000
    r = rng.normal(size=(3, n_frames, n_atoms, k_n)).astype(np.float32)
    r[:, rng.random((n_frames, n_atoms, k_n)) < 0.01] = 0.0
    dist = np.sqrt((r * r).sum(0), dtype=np.float32)
    ids = np.array([-1, 0, 1, 2], np.int32)
    sid_n = rng.choice(ids, size=(n_frames, n_atoms, k_n))
    counts = rng.choice(np.array([0, 1, 2, 32, 33, k_n, k_n + 5], np.int32), size=(n_frames, n_atoms))
    sid_c = rng.choice(ids, size=n_atoms)
    lists = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (*r, dist, sid_n)]
    args = (*lists, torch.from_numpy(counts).to(cuda), torch.from_numpy(sid_c).to(cuda), 500, 2, 4)
    _assert_adf_close(adf_kernel.adf_pairs_histogram(*args), adf_pairs_histogram_reference(*args))


def test_transport_on_the_card_matches_the_cpu(cuda, tmp_path):
    from lammps_analysis_tpu_torch import Project
    from lammps_analysis_tpu_torch.utils.config import config
    from torch_dumps import (
        assert_einstein_close,
        assert_gk_close,
        random_walk,
        walk_columns,
        write_dump,
    )

    wrapped, _, vel, names = random_walk((30, 20), 60, 10.0, 0.3, 0.02, seed=4)
    path = tmp_path / "t.lammpstrj"
    write_dump(path, 10.0, walk_columns(wrapped, vel, names), every=10, shuffle_seed=4)
    results = {}
    old = config.device
    try:
        for device in ("cuda", "cpu"):
            config.device = device
            exp = Project(name=device, storage_path=tmp_path).add_experiment(
                "e", timestep=0.002, units="metal", simulation_data=str(path)
            )
            results[device] = [
                exp.run.EinsteinDiffusionCoefficients(data_range=15, plot=False).data_dict,
                exp.run.GreenKuboDiffusionCoefficients(data_range=15, plot=False).data_dict,
            ]
    finally:
        config.device = old
    assert_einstein_close(results["cuda"][0], results["cpu"][0])
    assert_gk_close(results["cuda"][1], results["cpu"][1])


def test_conductivity_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The flux transformations and the six system calculators that read
    them, from one dump, on the card and on the CPU: series within 1e-5 x
    max|J|, results within the transport tolerance."""
    from lammps_analysis_tpu_torch import Project
    from lammps_analysis_tpu_torch.utils.config import config
    from torch_dumps import (
        FLUX_SERIES,
        assert_system_close,
        flux_columns,
        random_walk,
        walk_columns,
        write_dump,
    )

    wrapped, _, vel, names = random_walk((30, 20), 40, 10.0, 0.3, 0.02, seed=5)
    cols = walk_columns(wrapped, vel, names)
    cols.update(flux_columns(40, 50, seed=6))
    path = tmp_path / "t.lammpstrj"
    write_dump(path, 10.0, cols, every=10, shuffle_seed=7)
    calculators = ("GreenKuboIonicConductivity", "EinsteinHelfandIonicConductivity",
                   "GreenKuboThermalConductivity", "EinsteinHelfandThermalConductivity",
                   "EinsteinHelfandThermalKinaci", "GreenKuboViscosity")
    results = {}
    old = config.device
    try:
        for device in ("cuda", "cpu"):
            config.device = device
            exp = Project(name=device, storage_path=tmp_path).add_experiment(
                "e", timestep=0.002, temperature=1200.0, units="metal", simulation_data=str(path)
            )
            exp.set_charge("Na", 1.0)
            exp.set_charge("Cl", -1.0)
            values = {c: getattr(exp.run, c)(data_range=12, plot=False).data_dict["System"] for c in calculators}
            series = {p: exp.store.load([f"Observables/{p}"])[f"Observables/{p}"] for p in FLUX_SERIES}
            results[device] = values, series
    finally:
        config.device = old
    for prop, ref in results["cpu"][1].items():
        ref = ref.astype(np.float64)
        np.testing.assert_allclose(results["cuda"][1][prop], ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    for name, ref in results["cpu"][0].items():
        assert_system_close(results["cuda"][0][name], ref)


def test_molecular_path_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A small water box from a TRR through ``MolecularMap`` (adjacency and
    COM on the device), the molecular Einstein and RDF and the atomistic
    ADF, on the card and on the CPU: stored atoms and the molecule record
    identical, COM within 1e-5 A, D within the transport tolerance, g(r)
    equal, ADF within the angle-histogram tolerance."""
    import lammps_analysis_tpu_torch as lt
    from lammps_analysis_tpu_torch.file_io import TRRFile
    from lammps_analysis_tpu_torch.memory.planner import BatchPlanner
    from lammps_analysis_tpu_torch.transformations import map_molecules
    from lammps_analysis_tpu_torch.utils.config import config
    from torch_dumps import assert_einstein_close
    import torch_water as tw

    box = 4 * 3.1067
    w = tw.water_box(4, 40, box, 0.1, seed=21)
    path = tmp_path / "w.trr"
    tw.write_trr(path, box, x=w["wrapped"], v=w["velocities"] / 0.02)
    com_devices = set()
    original = map_molecules.com_batch

    def spy(pos, *args):
        com_devices.add(pos.device.type)
        return original(pos, *args)

    results = {}
    old = config.device
    try:
        map_molecules.com_batch = spy
        for device in ("cuda", "cpu"):
            config.device = device
            exp = lt.Project(name=device, storage_path=tmp_path).add_experiment(
                "w", timestep=0.002, units="metal",
                simulation_data=TRRFile(path, species=tw.species_rows(64)),
            )
            exp.planner = BatchPlanner(memory_budget_bytes=2**33)
            exp.run.MolecularMap(molecules=[lt.Molecule("water", smiles="[H]O[H]", amount=64, cutoff=1.7)])
            stored = exp.store.load(["O/Positions", "H/Positions", "water/Unwrapped_Positions"])
            results[device] = dict(
                stored=stored,
                molecules=exp.molecules,
                d=exp.run.EinsteinDiffusionCoefficients(molecules=True, data_range=20, plot=False).data_dict,
                rdf=exp.run.RadialDistributionFunction(molecules=True, number_of_configurations=10,
                                                       plot=False).data_dict,
                adf=exp.run.AngularDistributionFunction(number_of_configurations=4, cutoff=1.2,
                                                        number_of_bins=200, plot=False).data_dict,
            )
    finally:
        config.device = old
        map_molecules.com_batch = original
    card, cpu = results["cuda"], results["cpu"]
    assert com_devices == {"cuda", "cpu"}
    for key in ("O/Positions", "H/Positions"):
        np.testing.assert_array_equal(card["stored"][key], cpu["stored"][key])
    np.testing.assert_allclose(card["stored"]["water/Unwrapped_Positions"],
                               cpu["stored"]["water/Unwrapped_Positions"], rtol=0, atol=1e-5)
    assert card["molecules"] == cpu["molecules"] and card["molecules"]["water"]["n_particles"] == 64
    assert_einstein_close(card["d"], cpu["d"])
    assert card["rdf"] == cpu["rdf"]
    for key, value in cpu["adf"].items():
        ours, plain = torch.as_tensor(card["adf"][key]["adf"]), torch.as_tensor(value["adf"])
        if plain.sum() == 0:  # a triple with no pair of neighbors inside 1.2 A
            assert ours.sum() == 0, key
            continue
        _assert_adf_close(ours, plain)
    assert card["adf"]["O_H_H"]["max_peak"] == cpu["adf"]["O_H_H"]["max_peak"]


def _dump_experiment(tmp_path, name, path):
    from lammps_analysis_tpu_torch import Project

    return Project(name=name, storage_path=tmp_path).add_experiment(
        "e", timestep=0.002, units="metal", temperature=1200.0, simulation_data=str(path)
    )


def test_distinct_pair_on_the_card_matches_the_cpu(cuda, tmp_path):
    from lammps_analysis_tpu_torch.utils.config import config
    from torch_dumps import assert_distinct_close, random_walk, walk_columns, write_dump

    wrapped, _, vel, names = random_walk((30, 20), 60, 10.0, 0.3, 0.02, seed=6)
    path = tmp_path / "t.lammpstrj"
    write_dump(path, 10.0, walk_columns(wrapped, vel, names), every=10, shuffle_seed=6)
    results = {}
    old = config.device
    try:
        for device in ("cuda", "cpu"):
            config.device = device
            exp = _dump_experiment(tmp_path, device, path)
            exp.set_charge("Na", 1.0)
            exp.set_charge("Cl", -1.0)
            results[device] = [
                exp.run.EinsteinDistinctDiffusionCoefficients(data_range=15, plot=False).data_dict,
                exp.run.GreenKuboDistinctDiffusionCoefficients(data_range=15, plot=False).data_dict,
                exp.run.NernstEinsteinIonicConductivity(corrected=True, data_range=15,
                                                        plot=False)["System"],
            ]
    finally:
        config.device = old
    assert_distinct_close(results["cuda"][0], results["cpu"][0], "msd")
    assert_distinct_close(results["cuda"][1], results["cpu"][1], "vacf")
    for key, value in results["cpu"][2].items():
        np.testing.assert_allclose(results["cuda"][2][key], value, rtol=1e-5, err_msg=key)


def test_sdf_on_the_card_matches_the_cpu(cuda, tmp_path):
    import lammps_analysis_tpu_torch as lt
    from lammps_analysis_tpu_torch.database import (
        PropertyInfo, SpeciesInfo, TrajectoryChunkData, TrajectoryMetadata,
    )
    from lammps_analysis_tpu_torch.file_io import ScriptInput
    from lammps_analysis_tpu_torch.utils.config import config
    from torch_dumps import assert_counts_close

    rng = np.random.default_rng(8)
    counts, box = (400, 300), 15.0
    pos = rng.uniform(0, box, (12, sum(counts), 3)).astype(np.float32)
    prop = PropertyInfo("Positions", 3)
    species = [SpeciesInfo(n, c, [prop]) for n, c in zip(("Na", "Cl"), counts)]
    results = {}
    old = config.device
    try:
        for device in ("cuda", "cpu"):
            config.device = device
            meta = TrajectoryMetadata(n_configurations=12, species_list=species, box_l=[box] * 3,
                                      sample_rate=1)
            chunk = TrajectoryChunkData(species, 12)
            chunk.add_data(pos[:, : counts[0]], 0, "Na", "Positions")
            chunk.add_data(pos[:, counts[0]:], 0, "Cl", "Positions")
            exp = lt.Project(name=device, storage_path=tmp_path).add_experiment(
                "e", timestep=0.002, units="metal", simulation_data=ScriptInput(chunk, meta, "d")
            )
            results[device] = [
                exp.run.SpatialDistributionFunction(species=sp, r_min=2.0, r_max=4.5, n_bins=40,
                                                    plot=False)["System"]
                for sp in (["Na", "Cl"], ["Na"])
            ]
    finally:
        config.device = old
    for card, cpu in zip(results["cuda"], results["cpu"]):
        assert_counts_close(card["sdf"], cpu["sdf"])
        assert card["sphere"] == cpu["sphere"]


def test_fused_einstein_on_the_card_equals_the_materialised_run(cuda, tmp_path, monkeypatch):
    from lammps_analysis_tpu_torch.utils.config import config
    from torch_dumps import assert_einstein_close, random_walk, walk_columns, write_dump

    wrapped, _, vel, names = random_walk((30, 20), 80, 4.0, 0.3, 0.02, seed=7)
    path = tmp_path / "t.lammpstrj"
    write_dump(path, 4.0, walk_columns(wrapped, vel, names), every=10, shuffle_seed=7)
    kw = dict(data_range=20, correlation_time=3, plot=False)
    monkeypatch.setattr(config, "device", "cuda")
    materialised = _dump_experiment(tmp_path, "mat", path).run.EinsteinDiffusionCoefficients(**kw)
    results = {}
    monkeypatch.setattr(config, "fuse_streaming", True)
    for device in ("cuda", "cpu"):
        monkeypatch.setattr(config, "device", device)
        exp = _dump_experiment(tmp_path, f"fused-{device}", path)
        results[device] = exp.run.EinsteinDiffusionCoefficients(**kw).data_dict
        assert not exp.store.check_existence("Na/Unwrapped_Positions")
    assert results["cuda"] == materialised.data_dict
    assert_einstein_close(results["cuda"], results["cpu"])


# ------------------------------------------------------ the multi-device layer
@pytest.mark.parametrize(
    "counts, box, cutoff, n_bins, edges, mode",
    [
        ([640, 640], (20.0, 20.0, 20.0), 9.9, 500, (0, 640, 1280), "shared4"),
        ([400, 350, 245], (30.0, 33.0, 36.0), 9.9, 75, (0, 1, 130, 500, 500, 997, 1000), "warp"),
        ([1500, 1100], (25.0, 25.0, 25.0), 12.4, 200, (0, 867, 1734, 2600), "warp"),
        ([2600], (26.0, 26.0, 26.0), 12.9, 3000, (0, 700, 1900, 2600), "shared2"),
    ],
    ids=["halves", "ragged-and-empty", "thirds", "two-copies"],
)
def test_rdf_row_range_matches_plain_and_adds_up(cuda, counts, box, cutoff, n_bins, edges, mode):
    pos, sid = _case(counts, 2, box, seed=7, device=cuda)
    args = (pos, sid, box, cutoff, n_bins, len(counts))
    assert rdf_kernel.histogram_mode(len(counts), n_bins) == mode
    total = torch.zeros_like(rdf_histogram_reference(*args))
    for lo, hi in zip(edges[:-1], edges[1:]):
        launches = counters["k1.launches"]
        stripe = rdf_kernel.rdf_histogram(*args, rows=(lo, hi))
        torch.cuda.synchronize()
        assert counters["k1.launches"] == launches + (hi > lo)
        assert torch.equal(stripe, rdf_histogram_reference(*args, rows=(lo, hi)))
        total += stripe
    assert torch.equal(total, rdf_kernel.rdf_histogram(*args))


@pytest.mark.parametrize("route", ["binned", "sweep"])
@pytest.mark.parametrize("parts", [1, 2, 4])
def test_center_stripe_matches_plain_and_the_full_launch(cuda, route, parts):
    counts, box, cutoff, k_n = [640, 640], (20.0, 20.0, 20.0), 3.6, 96  # no center saturates
    pos, sid, args = _adf_lists(counts, 2, box, cutoff, k_n, 9, cuda)
    extract = getattr(adf_kernel, f"neighbor_extract_{route}")
    full = extract(*args)
    assert int(full[5].max()) <= k_n
    edges = np.linspace(0, pos.shape[1], parts + 1).astype(int)
    for lo, hi in zip(edges[:-1], edges[1:]):
        launches = counters[f"k2.launches.{route}"]
        stripe = extract(*args, centers=(int(lo), int(hi)))
        torch.cuda.synchronize()
        assert counters[f"k2.launches.{route}"] == launches + 1
        plain = neighbor_extract_reference(*args, centers=(int(lo), int(hi)))
        for a, b, c in zip(stripe, plain, full):
            assert torch.equal(a, b) and torch.equal(a, c[:, lo:hi])


def test_sharded_ops_in_a_world_sharing_the_card(cuda, monkeypatch):
    """Four ranks on the one card (gloo staging through the host): every
    sharded op, the 2-D ones on a (2, 2) mesh through K1's rows and K2's
    stripes, equals the one-process run on the card; the kernels ran on
    every rank and no plain version did."""
    import torch_worlds
    from lammps_analysis_tpu_torch.parallel import multihost
    from lammps_analysis_tpu_torch.utils.config import config

    monkeypatch.setattr(config, "device", "cuda")
    world = multihost.launch_local(4, torch_worlds.op_world, backend="gloo", device="cuda",
                                   timeout=600)
    ref = torch_worlds.one_device_ops()
    for rank in world:
        assert (rank["plain calls"] == 0).all() and (rank["launches"][[0, 3]] > 0).all()
        for key in ("rdf all", "rdf remainder", "rdf few frames", "rdf 2d", "rdf 2d routed"):
            np.testing.assert_array_equal(rank[key], ref["rdf all" if "2d" in key else key])
        for key in ("adf all", "adf remainder", "adf few frames", "adf saturated",
                    "adf stripes", "adf stripes routed"):
            _assert_adf_close(torch.from_numpy(rank[key]), torch.from_numpy(ref[key.replace(" routed", "")]))
        for key in ("msd", "msd remainder", "msd empty rank", "acf", "acf empty rank"):
            np.testing.assert_allclose(rank[key], ref[key], rtol=1e-5, atol=1e-5 * np.abs(ref[key]).max())


def test_a_world_of_one_on_nccl_gives_the_no_group_result(cuda, tmp_path, monkeypatch):
    """The calculators through the mesh code in a world of one rank on NCCL
    (the collectives run) against the same calls without a group."""
    import torch_worlds
    from lammps_analysis_tpu_torch.parallel import multihost
    from lammps_analysis_tpu_torch.utils.config import config
    from torch_dumps import assert_einstein_close, assert_gk_close

    monkeypatch.setattr(config, "device", "cuda")
    (world,) = multihost.launch_local(1, torch_worlds.calculators, tmp_path / "world",
                                      backend="nccl", device="cuda", timeout=600)
    ref = torch_worlds.calculators(tmp_path / "alone")
    assert world["RadialDistributionFunction"] == ref["RadialDistributionFunction"]
    for key, value in ref["AngularDistributionFunction"].items():
        _assert_adf_close(torch.tensor(world["AngularDistributionFunction"][key]["adf"]),
                          torch.tensor(value["adf"]))
    for name in ("EinsteinDiffusionCoefficients", "walk Einstein"):
        assert_einstein_close(world[name], ref[name])
    assert_gk_close(world["GreenKuboDiffusionCoefficients"], ref["GreenKuboDiffusionCoefficients"])


# ------------------------------------------------ K2 modes: idx, open, sorted
@pytest.mark.parametrize("route", ["binned", "sweep"])
def test_idx_output_matches_plain(cuda, route):
    """``with_idx`` on both routes: all seven outputs equal the plain version
    bit for bit, and each route counts an idx launch."""
    pos, sid = _case([1200, 1200], 2, (26.0, 26.0, 26.0), seed=21, device=cuda)
    sid[4:6] = 2
    args = (pos, sid, (26.0, 26.0, 26.0), 3.6, 48, 2)
    wrapper = getattr(adf_kernel, f"neighbor_extract_{route}")
    launches = counters[f"k2.launches.idx.{route}"]
    ours = wrapper(*args, with_idx=True)
    torch.cuda.synchronize()
    assert counters[f"k2.launches.idx.{route}"] == launches + 1
    plain = neighbor_extract_reference(*args, with_idx=True)
    for a, b in zip(ours, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(adf_kernel.neighbor_indices(*args), plain[6])


def test_open_boundaries_match_plain(cuda):
    """``box=None`` on the sweep (a droplet in no box), with idx."""
    pos, sid = _case([800, 700], 2, (18.0, 18.0, 18.0), seed=22, device=cuda)
    args = (pos, sid, None, 3.6, 64, 2)
    launches = counters["k2.launches.open"]
    ours = adf_kernel.neighbor_extract(*args, with_idx=True)
    torch.cuda.synchronize()
    assert counters["k2.launches.open"] == launches + 1
    plain = neighbor_extract_reference(*args, with_idx=True)
    assert all(torch.equal(a, b) for a, b in zip(ours, plain))
    hist, max_count = adf_kernel.adf_histogram(pos, sid, None, 3.6, 100, 2, k_n=64)
    h_plain = adf_pairs_histogram_reference(*plain[:6], sid, 100, 2).sum(0)
    assert int(max_count) == int(plain[5].max())
    _assert_adf_close(hist, h_plain)


@pytest.mark.parametrize("sort", ["z", "brick"])
def test_sorted_route_matches_plain_and_the_sweep(cuda, sort):
    """The window mode on sorted frames: equal to the plain sorted extract bit
    for bit, ``sid_sorted`` and no overflow under the sort's bound, the flag
    under a bound of one chunk (the lists exact all the same), and each
    center's set equal to the sweep's once the permutation is undone."""
    from lammps_analysis_tpu_torch.ops import sorting
    from lammps_analysis_tpu_torch.ops.adf import sorted_neighbor_extract_reference

    box = (24.0, 24.0, 48.0)
    pos, sid = _case([3000, 3000], 2, box, seed=23, device=cuda)
    args = (pos, sid, box, 4.0, 96, 2)
    bound = sorting.window_bound(sort, pos.shape[1], box, 4.0)
    launches = counters[f"k2.launches.{sort}"]
    *lists, sid_s, overflow = adf_kernel.sorted_neighbor_extract(*args, sort, bound)
    torch.cuda.synchronize()
    assert counters[f"k2.launches.{sort}"] == launches + 1
    plain = sorted_neighbor_extract_reference(*args, sort)
    assert all(torch.equal(a, b) for a, b in zip((*lists, sid_s), plain))
    assert int(overflow) == 0
    *narrow, _, flag = adf_kernel.sorted_neighbor_extract(*args, sort, 1)
    assert int(flag) == 1 and all(torch.equal(a, b) for a, b in zip(narrow, lists))
    _, _, order, _, _ = sorting.sort_frames(pos, sid, 2, box, 4.0, sort)
    sweep = adf_kernel.neighbor_extract_sweep(*args)
    for fr in range(2):
        inv = torch.empty_like(order[fr])
        inv[order[fr]] = torch.arange(order.shape[1], device=cuda)
        assert torch.equal(lists[5][fr][inv], sweep[5][fr])
        d_ours = torch.sort(lists[3][fr][inv], dim=1).values
        assert torch.equal(d_ours, torch.sort(sweep[3][fr], dim=1).values)


# ------------------------------- the sweep's staged writes at their edges
def _clusters(n_frames, seed, wrap, padding=True):
    """Frames of tight clusters of 2, 32-34, 64-66 and 130 atoms (radius 0.45
    A: each atom of a cluster of m has exactly m - 1 neighbors within 1 A)
    and 300 lone atoms, 726 atoms in a 48 A box, in a random order: counts 0,
    1, 31-33, 63-65 and 129 against K's 128-byte lines (32 slots) and the
    64-slot rings, over two tiles of 512 atoms. One cluster sits on the box's
    corner: with ``wrap`` its atoms lie on both sides of every periodic seam.
    Lone atoms carry ids 0, 1 and, with ``padding``, a few 2 (padding of a
    2-species layout, which the sorted route orders last); the second frame orders its atoms anew under the same id row, so some of
    its cluster atoms are padding too."""
    rng = np.random.default_rng(seed)
    sizes = [32, 33, 34, 64, 65, 66, 2, 130]
    grid = np.stack(np.meshgrid(*[np.arange(8.0)] * 3, indexing="ij"), -1).reshape(-1, 3) * 6.0
    ids = np.concatenate([rng.integers(0, 2, sum(sizes)), rng.choice([0, 1, 1, 2 if padding else 0], 300)])
    first = rng.permutation(len(ids))
    frames = []
    for f in range(n_frames):
        sites = grid[rng.permutation(len(grid))[: len(sizes)]]
        sites[0] = 0.0  # the corner cluster
        parts = []
        for site, m in zip(sites, sizes):
            v = rng.normal(size=(m, 3))
            v *= 0.45 * rng.uniform(0, 1, (m, 1)) ** (1 / 3) / np.linalg.norm(v, axis=1, keepdims=True)
            parts.append(site + v)
        lone = grid[rng.permutation(len(grid))[:300]] + 3.0  # >= 4.7 A from every cluster atom
        pos = np.concatenate(parts + [lone])[first if f == 0 else rng.permutation(len(ids))]
        frames.append(pos % 48.0 if wrap else pos)
    ids = ids[first]
    return np.asarray(frames, np.float32), ids.astype(np.int32)


STAGED = (31, 32, 33, 63, 64, 65, 129)


@pytest.mark.parametrize("with_idx", [False, True], ids=["lean", "idx"])
@pytest.mark.parametrize("k_n", [1, 31, 33, 1000])
@pytest.mark.parametrize("box", [(48.0, 48.0, 48.0), None], ids=["periodic", "open"])
def test_sweep_staging_edges_match_plain(cuda, box, k_n, with_idx):
    """Counts on both sides of a line and of a ring, K below, at and above
    them (1, 31, 33 and 1000: row starts at every line offset), centers
    saturated above K, two frames in one launch, 726 atoms (the 4-byte tile
    copies): every output equal to the plain version bit for bit."""
    pos, sid = _clusters(2, 31, wrap=box is not None)
    pos, sid = torch.from_numpy(pos).to(cuda), torch.from_numpy(sid).to(cuda)
    args = (pos, sid, box, 1.0, k_n, 2)
    ours = adf_kernel.neighbor_extract_sweep(*args, with_idx=with_idx)
    torch.cuda.synchronize()
    plain = neighbor_extract_reference(*args, with_idx=with_idx)
    assert set(STAGED) <= set(plain[5].unique().tolist())
    for a, b in zip(ours, plain):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("centers", [(5, 300), (17, 726), (0, 1)])
def test_sweep_stripe_off_the_block_matches_plain(cuda, centers):
    """Stripes whose first center is not a multiple of the block's 16, with
    idx, K = 33: equal to the plain version and to the full launch's rows."""
    pos, sid = _clusters(2, 32, wrap=True)
    pos, sid = torch.from_numpy(pos).to(cuda), torch.from_numpy(sid).to(cuda)
    args = (pos, sid, (48.0, 48.0, 48.0), 1.0, 33, 2)
    full = adf_kernel.neighbor_extract_sweep(*args, with_idx=True)
    lo, hi = centers
    ours = adf_kernel.neighbor_extract_sweep(*args, centers=centers, with_idx=True)
    torch.cuda.synchronize()
    plain = neighbor_extract_reference(*args, centers=centers, with_idx=True)
    for a, b, c in zip(ours, plain, full):
        assert torch.equal(a, b) and torch.equal(a, c[:, lo:hi])


@pytest.mark.parametrize("k_n", [33, 1000])
@pytest.mark.parametrize("sort", ["z", "brick"])
def test_window_staging_across_the_seam_matches_plain(cuda, sort, k_n):
    """The window mode on the cluster frames: the corner cluster puts arcs
    across the end of the sorted order (the periodic seam); lists and
    ``sid_sorted`` equal to the plain sorted extract bit for bit, and the
    overflow flag set exactly where a window covers more chunks than the
    sort's bound (these frames are far from uniform)."""
    from lammps_analysis_tpu_torch.ops import sorting
    from lammps_analysis_tpu_torch.ops.adf import sorted_neighbor_extract_reference

    box = (48.0, 48.0, 48.0)
    pos, sid = _clusters(2, 33, wrap=True, padding=False)  # padding sorted last ends the arcs
    pos, sid = torch.from_numpy(pos).to(cuda), torch.from_numpy(sid).to(cuda)
    n_chunks = -(-pos.shape[1] // sorting.CHUNK_ATOMS)
    _, _, _, arcs, total = sorting.sort_frames(pos, sid, 2, box, 1.0, sort)
    arcs = arcs.view(-1, 2)
    assert bool(((arcs[:, 1] > 0) & (arcs[:, 0] + arcs[:, 1] > n_chunks)).any())
    args = (pos, sid, box, 1.0, k_n, 2)
    bound = sorting.window_bound(sort, pos.shape[1], box, 1.0)
    *lists, sid_s, overflow = adf_kernel.sorted_neighbor_extract(*args, sort, bound)
    torch.cuda.synchronize()
    plain = sorted_neighbor_extract_reference(*args, sort)
    assert set(STAGED) <= set(plain[5].unique().tolist())
    assert all(torch.equal(a, b) for a, b in zip((*lists, sid_s), plain))
    assert int(overflow) == int(total.max() > bound)


#: the windowed ACF's pack cases: (frames, particles, components, window,
#: stride, first window, windows, lag table or None)
ACF_PACKS = {
    # GK self-diffusion's batch with fewer ions: R 500, stride 5, L 1024
    "gk_d": (700, 400, 3, 500, 5, 0, 32, None),
    # the last, ragged batch of 37 windows
    "ragged": (700, 400, 3, 500, 5, 32, 5, None),
    # a lag table (R 71 of a 500-frame window, L 256)
    "tau": (700, 40, 3, 500, 5, 3, 20, list(range(0, 497, 7))),
    # a system series: S = 3, 1501 windows side by side in the tiles
    "s3": (2000, 1, 3, 500, 1, 0, 1501, None),
    # S = 33, 17 and 5: a tile's columns straddle windows or sequences
    "s33": (300, 11, 3, 100, 2, 1, 37, None),
    "s17": (300, 17, 1, 100, 2, 0, 40, None),
    "s5": (300, 5, 1, 37, 3, 0, 50, [0, 1, 5, 36]),
}


def _acf_slab(cuda, frames, particles, dims, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((frames, particles, dims), device=cuda, generator=g)


@pytest.mark.parametrize("case", list(ACF_PACKS))
def test_acf_pack_equals_plain(cuda, case):
    from lammps_analysis_tpu_torch.ops import correlation

    frames, particles, dims, window, stride, c0, n, tau = ACF_PACKS[case]
    x = _acf_slab(cuda, frames, particles, dims)
    lags = None if tau is None else correlation.lag_table(tau, window, cuda)
    r = window if tau is None else len(tau)
    fft_len = correlation._next_fast_len(2 * r)
    out = None
    if case == "ragged":  # the buffer of the call's first, full batch
        out = correlation.acf_pack(x, window, stride, 0, 32, fft_len, lags)
    packed = correlation.acf_pack(x, window, stride, c0, n, fft_len, lags, out=out)
    plain = correlation.acf_pack_reference(x, window, stride, c0, n, fft_len, lags)
    assert packed.shape == plain.shape == (n, particles * dims, fft_len) and packed.is_contiguous()
    assert torch.equal(packed, plain)


def test_acf_pack_zero_tail_survives_reuse_and_the_r2c(cuda):
    """A buffer through two batches and two forward FFTs: its tail stays 0
    (cuFFT's out-of-place R2C leaves its input as it was), and each batch's
    values and spectrum equal the plain version's."""
    from lammps_analysis_tpu_torch.ops import correlation

    x = _acf_slab(cuda, 700, 400, 3, seed=1)
    buf = correlation.acf_pack(x, 500, 5, 0, 32, 1024)
    for c0, n in ((0, 32), (32, 5)):
        packed = correlation.acf_pack(x, 500, 5, c0, n, 1024, out=buf)
        spec = torch.fft.rfft(packed, n=1024, dim=-1)
        plain = correlation.acf_pack_reference(x, 500, 5, c0, n, 1024)
        assert torch.equal(packed, plain)
        assert torch.equal(spec, torch.fft.rfft(plain, n=1024, dim=-1))
    assert not bool(buf[..., 500:].any())


#: (windows, sequences, bins): GK self-diffusion's batch with fewer ions, a
#: system series, ragged chunks and several column tiles
ACF_POWERS = [(8, 4800, 513), (1501, 3, 513), (5, 333, 129), (3, 1000, 2049), (2, 70, 1)]


@pytest.mark.parametrize("shape", ACF_POWERS, ids=lambda s: "x".join(map(str, s)))
def test_acf_power_sum_matches_plain_and_repeats(cuda, shape):
    from lammps_analysis_tpu_torch.ops import correlation

    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    spec = torch.randn(shape, dtype=torch.complex64, device=cuda, generator=g)
    power = correlation.acf_power_sum(spec)
    again = correlation.acf_power_sum(spec)
    plain = correlation.acf_power_sum_reference(spec.clone())
    assert power.dtype == torch.float64 and power.shape == shape[::2]
    assert torch.equal(power, again)
    assert float(((power - plain).abs() / plain).max()) <= 1e-12


def test_windowed_acf_on_the_card_takes_the_kernels(cuda):
    """A call of four batches, and one of two with a lag table: no plain
    batch, one pack and one power-sum launch a batch, and the CPU's result
    within float32 FFTs' rounding (2e-6 of the lag-0 value)."""
    from lammps_analysis_tpu_torch.ops import correlation

    x = _acf_slab(cuda, 300, 50, 3, seed=2)
    budget = 10 * 50 * 3 * 128 * 16  # 10 windows a batch at R 50
    for tau in (None, list(range(0, 50, 3))):
        before = counters.copy()
        s, per_window = correlation.windowed_acf_sum(x, 50, 7, budget, tau=tau)
        delta = counters - before
        batches = delta["acf.batches"]
        assert batches == (4 if tau is None else 2) and delta["acf.plain"] == 0
        assert delta["acf.pack.launches"] == delta["acf.power.launches"] == batches
        s_cpu, per_window_cpu = correlation.windowed_acf_sum(x.cpu(), 50, 7, budget, tau=tau)
        torch.testing.assert_close(s.cpu(), s_cpu, rtol=0, atol=2e-6 * float(s_cpu[0]))
        torch.testing.assert_close(per_window.cpu(), per_window_cpu, rtol=0,
                                   atol=2e-6 * float(per_window_cpu[:, 0].max()))
