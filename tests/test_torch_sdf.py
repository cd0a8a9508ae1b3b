"""PyTorch port, the spatial distribution function: ``ops/histogram.py``, the
spherical geometry of ``ops/geometry.py`` and ``SpatialDistributionFunction``,
held against numpy and the JAX package on the same inputs.

Counts. The port counts in integers, the JAX package in float32 weights
through its XLA route (its native CPU kernel, the default on a CPU backend,
is turned off here). Both compute the angles in float32, with different
``arccos``/``atan2`` implementations, so a pair within an ulp of a bin edge
may land in the next bin: totals must agree within 0.01 % and the summed
per-bin difference stay within max(4, 1e-4 x the total). The shell test
divides by the box in both (``minimum_image_divided``), so the totals
agree exactly on these inputs.
"""

import importlib
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from lammps_analysis_tpu.ops import geometry as jgeometry
from lammps_analysis_tpu.ops import histogram as jhistogram
from lammps_analysis_tpu.utils.config import config as jax_config
from lammps_analysis_tpu_torch.calculators.spatial_distribution_function import (
    SpatialDistributionFunction,
)
from lammps_analysis_tpu_torch.memory.planner import BatchPlanner
from lammps_analysis_tpu_torch.ops import geometry
from lammps_analysis_tpu_torch.ops.histogram import bin_indices, histogram2d_masked
from lammps_analysis_tpu_torch.utils.config import config

import torch_water as tw
from torch_dumps import assert_counts_close

torch.set_num_threads(1)

PORT, JAX = "lammps_analysis_tpu_torch", "lammps_analysis_tpu"


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(jax_config, "native_cpu_kernels", False)


# ---------------------------------------------------------------- histogram
RANGES = [(0.0, math.pi), (-math.pi, math.pi), (4.0, 4.5), (-2.0, 3.0)]


def _bin_inputs(values, lo, hi, n_bins):
    """``values`` plus every float32 bin edge of the range and its two
    neighbouring floats."""
    edges = np.float32(lo) + np.arange(n_bins + 1, dtype=np.float32) * np.float32((hi - lo) / n_bins)
    return np.concatenate([np.asarray(values, np.float32), edges, np.nextafter(edges, np.float32(np.inf)),
                           np.nextafter(edges, np.float32(-np.inf))]).astype(np.float32)


@settings(max_examples=150, deadline=None)
@given(data=st.data(), rng_idx=st.integers(0, len(RANGES) - 1), n_bins=st.integers(1, 300))
def test_bin_indices_match_numpy(data, rng_idx, n_bins):
    """Truncation toward zero then a clip, in float32: values inside and
    outside the range and on (float32) bin edges."""
    lo, hi = RANGES[rng_idx]
    span = hi - lo
    low, high = (float(np.float32(v)) for v in (lo - 2 * span, hi + 2 * span))
    drawn = data.draw(st.lists(st.floats(low, high, width=32), max_size=40))
    values = _bin_inputs(drawn, lo, hi, n_bins)
    ours = bin_indices(torch.from_numpy(values), lo, hi, n_bins)
    expected = np.clip(((values - lo) / span * n_bins).astype(np.int32), 0, n_bins - 1)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), expected)


@pytest.mark.parametrize("lo, hi", RANGES)
@pytest.mark.parametrize("n_bins", [1, 7, 100])
def test_bin_indices_match_jax(lo, hi, n_bins):
    rng = np.random.default_rng(n_bins)
    values = _bin_inputs(rng.uniform(lo - (hi - lo), hi + (hi - lo), 200), lo, hi, n_bins)
    ours = bin_indices(torch.from_numpy(values), lo, hi, n_bins)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jhistogram.bin_indices(jnp.asarray(values), lo, hi, n_bins)))


@settings(max_examples=100, deadline=None)
@given(n_x=st.integers(1, 12), n_y=st.integers(1, 12), size=st.integers(0, 300), seed=st.integers(0, 2**16))
def test_histogram2d_masked_matches_numpy(n_x, n_y, size, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, n_x, size, dtype=np.int32)
    y = rng.integers(0, n_y, size, dtype=np.int32)
    mask = rng.random(size) < 0.6
    ours = histogram2d_masked(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask), n_x, n_y)
    expected = np.zeros((n_x, n_y), np.int64)
    np.add.at(expected, (x[mask], y[mask]), 1)
    assert ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(), expected)


def test_histogram2d_masked_matches_jax_scatter():
    rng = np.random.default_rng(4)
    x, y = rng.integers(0, 30, (2, 3, 500), dtype=np.int32)
    mask = rng.random((3, 500)) < 0.3
    ours = histogram2d_masked(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask), 30, 30)
    ref = jhistogram.histogram2d_masked(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask, jnp.float32),
                                        30, 30, strategy="scatter")
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# ------------------------------------------------------------------ geometry
def test_spherical_geometry_matches_jax():
    rng = np.random.default_rng(3)
    r = rng.normal(scale=6.0, size=(500, 3)).astype(np.float32)
    r[0] = 0.0  # r = 0: theta 0
    box = np.array([7.0, 8.0, 9.0], np.float32)
    wrapped = geometry.minimum_image_divided(torch.from_numpy(r), torch.from_numpy(box))
    np.testing.assert_array_equal(wrapped.numpy(), np.asarray(jgeometry.minimum_image(jnp.asarray(r), jnp.asarray(box))))
    rtp = geometry.cartesian_to_spherical(wrapped)
    jrtp = np.asarray(jgeometry.cartesian_to_spherical(jnp.asarray(wrapped.numpy())))
    np.testing.assert_allclose(rtp.numpy(), jrtp, rtol=2e-6, atol=2e-6)
    assert rtp[0, 1] == 0.0
    back = geometry.spherical_to_cartesian(rtp.double())
    np.testing.assert_allclose(back.numpy(), wrapped.numpy(), atol=1e-4)


# --------------------------------------------------------------- calculator
def _experiment(package, root, pos, counts, box, budget=None, prop="Positions"):
    pkg = importlib.import_module(package)
    db = importlib.import_module(package + ".database")
    props = importlib.import_module(package + ".database.properties")
    file_io = importlib.import_module(package + ".file_io")
    p = props.PropertyInfo(prop, 3)
    names = ("Na", "Cl")[: len(counts)]
    species = [db.SpeciesInfo(n, c, [p]) for n, c in zip(names, counts)]
    meta = db.TrajectoryMetadata(n_configurations=pos.shape[0], species_list=species,
                                 box_l=[box] * 3, sample_rate=1)
    chunk = db.TrajectoryChunkData(species, pos.shape[0])
    start = 0
    for n, c in zip(names, counts):
        chunk.add_data(pos[:, start:start + c], 0, n, prop)
        start += c
    exp = pkg.Project(name="p", storage_path=root).add_experiment(
        "e", timestep=0.002, units="metal", simulation_data=file_io.ScriptInput(chunk, meta, "d")
    )
    if budget is not None:
        planner = importlib.import_module(package + ".memory.planner")
        exp.planner = planner.BatchPlanner(memory_budget_bytes=budget)
    return exp


def _gas(counts, n_frames, box, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, box, (n_frames, sum(counts), 3)).astype(np.float32).astype(np.float64)


@pytest.mark.parametrize(
    "species, kw",
    [
        (["Na", "Cl"], dict(r_min=2.0, r_max=4.0, n_bins=30)),
        (["Na"], dict(r_min=1.0, r_max=3.5, n_bins=24)),  # same species: no self pairs
        (["Cl", "Na"], dict(r_min=0.0, r_max=2.5, n_bins=40, start=0, stop=11,
                            number_of_configurations=12)),
        (None, dict()),  # the defaults: 4.0-4.5 A, frames 1-10 (5 picked), 100 x 100 bins
    ],
    ids=["cross", "same", "cross-rmin-0-all-frames", "defaults"],
)
def test_sdf_matches_jax(tmp_path, species, kw):
    counts, box = (90, 70), 12.0
    pos = _gas(counts, 12, box, seed=11)
    results = {}
    for package in (PORT, JAX):
        exp = _experiment(package, tmp_path / package, pos, counts, box)
        res = exp.run.SpatialDistributionFunction(species=species, plot=False, **kw)
        results[package] = res
    ours, ref = results[PORT], results[JAX]
    assert ours.args == ref.args
    assert list(ours.data_dict) == ["System"]
    assert_counts_close(ours["System"]["sdf"], ref["System"]["sdf"])
    assert np.sum(ours["System"]["sdf"]) == np.sum(ref["System"]["sdf"])
    np.testing.assert_allclose(ours["System"]["sphere"], ref["System"]["sphere"], rtol=1e-12, atol=1e-15)


def test_sdf_tiles_do_not_change_the_counts(tmp_path, monkeypatch):
    """A budget that cuts the a-axis into blocks and the frames into single
    batches (the same-species exclusion then runs on global atom ids) gives
    the one-tile counts exactly; the tiles follow ``PEAK_BYTES_PER_PAIR``."""
    counts, box = (90, 70), 12.0
    pos = _gas(counts, 12, box, seed=12)
    tiles = []
    original = SpatialDistributionFunction.tiles

    def spy(self, n_a, n_b, n_frames):
        tiles.append(original(self, n_a, n_b, n_frames))
        return tiles[-1]

    monkeypatch.setattr(SpatialDistributionFunction, "tiles", spy)
    out = []
    # a fifth of the tiled budget holds 8 rows of 90 pairs at the peak a pair
    peak = SpatialDistributionFunction.PEAK_BYTES_PER_PAIR
    for name, budget in (("one", None), ("tiled", 5 * 8 * 90 * peak)):
        exp = _experiment(PORT, tmp_path / name, pos, counts, box, budget=budget)
        for species in (["Na"], ["Na", "Cl"]):
            out.append(exp.run.SpatialDistributionFunction(species=species, r_min=1.0, r_max=3.0,
                                                           n_bins=20, plot=False).data_dict)
    assert tiles == [(90, 5), (90, 5), (8, 1), (8 * 90 // 70, 1)], tiles
    assert out[0] == out[2] and out[1] == out[3]


def test_sdf_of_water_molecules_matches_jax(tmp_path):
    """``molecules=True`` on mapped waters (``tests/torch_water.py``): the shell
    of molecule centres around each water. No molecule straddles a face at
    the first frame, where the JAX package's COM is off (a divergence pinned
    in ``tests/test_torch_molecules.py``), and the atoms are
    float32-representable, so both packages map the same centres."""
    from test_torch_molecules import _experiment as water_experiment, _map

    w = tw.water_box(3, 12, 3 * 3.1067, 0.1, seed=19, straddle=False)
    assert w["straddling"] == 0
    wrapped = w["wrapped"].astype(np.float32).astype(np.float64)
    results = {}
    for package in (PORT, JAX):
        exp = water_experiment(package, tmp_path / package, wrapped, 3 * 3.1067)
        _map(exp, package, amount=27)
        results[package] = exp.run.SpatialDistributionFunction(
            molecules=True, r_min=2.0, r_max=4.5, n_bins=30, plot=False
        )
    ours, ref = results[PORT], results[JAX]
    assert ours.args["species"] == ref.args["species"] == ["water"]
    assert_counts_close(ours["System"]["sdf"], ref["System"]["sdf"])


def test_sdf_cache_hit(tmp_path, monkeypatch):
    from lammps_analysis_tpu_torch.calculators import spatial_distribution_function as sdf

    counts, box = (30, 30), 8.0
    exp = _experiment(PORT, tmp_path, _gas(counts, 12, box, seed=13), counts, box)
    first = exp.run.SpatialDistributionFunction(n_bins=10, r_min=1.0, r_max=3.0, plot=False)
    calls = []
    original = sdf.sdf_tile
    monkeypatch.setattr(sdf, "sdf_tile", lambda *a: calls.append(1) or original(*a))
    again = exp.run.SpatialDistributionFunction(n_bins=10, r_min=1.0, r_max=3.0, plot=False)
    assert not calls and again.data_dict == first.data_dict
    forced = exp.run.SpatialDistributionFunction(n_bins=10, r_min=1.0, r_max=3.0, plot=False, force=True)
    assert calls and forced.data_dict == first.data_dict
    assert isinstance(BatchPlanner().budget_bytes, int)
