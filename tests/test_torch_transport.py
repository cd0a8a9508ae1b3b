"""PyTorch port, the transport slice: windowed MSD and ACF ops, the window
plan, and ``EinsteinDiffusionCoefficients`` / ``GreenKuboDiffusionCoefficients``
from a LAMMPS dump, held against the JAX package, the numpy oracles of
``tests/reference_oracles.py`` and the analytic random walk.

Tolerances. The port keeps float32 data and float32 differences and FFTs,
summed in float64; the JAX package runs here with x64 on, in float64 from
the same float32 values. Against it: MSD series and D within rtol 1e-5; ACF
series within rtol 1e-5 plus an atol of 1e-5 x acf[0] (float32 FFT rounding
is relative to the largest term); GK integrals and D within rtol 1e-5 plus
an atol of 1e-5 x acf[0] x the lag time; every Einstein output (fit errors
too) within rtol 1e-5. Each package gets its own ``tmp_path`` directory.
"""

import contextlib
import importlib
import sqlite3

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import reference_oracles as oracle
from lammps_analysis_tpu.calculators.base import window_aligned_slabs as jax_slabs
from lammps_analysis_tpu.ops import correlation as jcorr
from lammps_analysis_tpu.ops import msd as jmsd
from lammps_analysis_tpu_torch.calculators.base import window_aligned_slabs
from lammps_analysis_tpu_torch.ops import correlation
from lammps_analysis_tpu_torch.ops.correlation import windowed_acf_sum
from lammps_analysis_tpu_torch.ops.msd import windowed_msd_sum
from lammps_analysis_tpu_torch.utils.config import config

from torch_dumps import (
    acf_sums_direct,
    assert_einstein_close,
    assert_gk_close,
    assert_series_match_direct,
    msd_sums_direct,
    random_walk,
    walk_columns,
    write_dump,
)
from torch_jax_parser import ensure_jax_native_parser

torch.set_num_threads(1)

DT, EVERY = 0.002, 10  # ps, frames written every 10 steps: 0.02 ps a frame


@pytest.fixture(scope="module", autouse=True)
def jax_reads_natively():
    ensure_jax_native_parser()


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


# ---------------------------------------------------------------- window plan
@settings(max_examples=200, deadline=None)
@given(
    n_frames=st.integers(0, 400),
    slab=st.integers(1, 400),
    data_range=st.integers(1, 200),
    correlation_time=st.integers(1, 64),
)
def test_window_aligned_slabs_enumerate_every_window_once(
    n_frames, slab, data_range, correlation_time
):
    """Slab-relative window starts over all slabs == the whole array's window
    starts, each once: the analytic ``n_windows * (n + 1)`` normaliser rests
    on it. The slabs equal the JAX package's."""
    slabs = window_aligned_slabs(n_frames, slab, data_range, correlation_time)
    assert slabs == jax_slabs(n_frames, slab, data_range, correlation_time)
    got = []
    for start, stop in slabs:
        assert 0 <= start < stop <= n_frames
        w = start
        while w + data_range <= stop:
            got.append(w)
            w += correlation_time
    assert got == list(range(0, n_frames - data_range + 1, correlation_time))


# ------------------------------------------------------------------------ ops
def _series(rng, t, n, walk):
    x = rng.normal(size=(t, n, 3))
    return (np.cumsum(x, axis=0) if walk else x).astype(np.float32)


OP_CASES = [
    # (frames, window, stride, tau)
    (50, 10, 1, None),
    (50, 10, 3, None),
    (50, 10, 10, None),  # stride == window
    (50, 10, 13, None),  # stride > window: gaps between windows
    (50, 50, 1, None),  # one window, all frames
    (8, 10, 1, None),  # window longer than the data: no window
    (50, 12, 2, [0, 3, 7, 11]),  # tau subset
    (37, 9, 4, [1, 2, 8]),
]


@pytest.mark.parametrize("t, window, stride, tau", OP_CASES)
def test_windowed_msd_matches_jax(t, window, stride, tau):
    rng = np.random.default_rng(t * window + stride)
    x = _series(rng, t, 6, walk=True)
    tau = np.arange(window) if tau is None else np.asarray(tau)
    ours, n = windowed_msd_sum(torch.from_numpy(x), tau, window, stride)
    ref, ref_n = jmsd.windowed_msd_sum(
        jnp.asarray(x.astype(np.float64)), jnp.asarray(tau), window, stride
    )
    assert n == int(ref_n) == ((t - window) // stride + 1 if t >= window else 0)
    assert ours.dtype == torch.float64 and ours.shape == (len(tau),)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("chunk", [None, 1, 3])
@pytest.mark.parametrize("t, window, stride, tau", OP_CASES)
def test_windowed_acf_matches_jax(t, window, stride, tau, chunk):
    """``chunk`` windows per FFT batch, from a budget of that many windows'
    working sets (None: a budget far above a ``BATCH_BYTES`` batch)."""
    rng = np.random.default_rng(t * window + stride + 1)
    x = _series(rng, t, 5, walk=False)
    r = window if tau is None else len(tau)
    window_bytes = 5 * 3 * correlation._next_fast_len(2 * r) * 16
    budget = 2**30 if chunk is None else chunk * window_bytes
    full = max(32, correlation.BATCH_BYTES // window_bytes)
    assert correlation._auto_chunk(5, 3, r, budget) == (full if chunk is None else chunk)
    ours, per_window = windowed_acf_sum(torch.from_numpy(x), window, stride, budget, tau=tau)
    ref, ref_pw = jcorr.windowed_acf_sum(
        jnp.asarray(x.astype(np.float64)), window, stride,
        tau=None if tau is None else jnp.asarray(tau),
    )
    ref, ref_pw = np.asarray(ref), np.asarray(ref_pw)
    assert per_window.shape == ref_pw.shape
    scale = abs(ref[0]) if ref.size else 0.0
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5 * scale)
    if ref_pw.size:
        np.testing.assert_allclose(
            per_window.numpy(), ref_pw, rtol=1e-5, atol=1e-5 * np.abs(ref_pw[:, 0]).max()
        )


@pytest.mark.parametrize(
    "t, window, stride", [c[:3] for c in OP_CASES if c[3] is None and c[0] >= c[1]]
)
def test_direct_sums_match_jax(t, window, stride):
    """The float64 direct sums ``chip_smoke.py`` checks the full-size series
    with, against the JAX package's windowed ops in float64 (rtol 1e-10)."""
    rng = np.random.default_rng(t + window + stride)
    x = _series(rng, t, 4, walk=True).astype(np.float64)
    ref, _ = jmsd.windowed_msd_sum(jnp.asarray(x), jnp.arange(window), window, stride)
    np.testing.assert_allclose(msd_sums_direct(x, window, stride), np.asarray(ref), rtol=1e-10)
    v = _series(rng, t, 4, walk=False).astype(np.float64)
    ref, _ = jcorr.windowed_acf_sum(jnp.asarray(v), window, stride)
    np.testing.assert_allclose(
        acf_sums_direct(v, window, stride), np.asarray(ref), rtol=1e-10,
        atol=1e-10 * abs(float(ref[0])),
    )


# ---------------------------------------------------------------- calculators
def _dump(path, counts=(12, 8), n_frames=80, sigma=0.3, seed=31):
    wrapped, unwrapped, vel, names = random_walk(counts, n_frames, 10.0, sigma, DT * EVERY, seed)
    write_dump(path, 10.0, walk_columns(wrapped, vel, names), every=EVERY, shuffle_seed=seed)
    return path, unwrapped, vel


def _experiment(package, root, path, budget=None):
    pkg = importlib.import_module(package)
    exp = pkg.Project(name="p", storage_path=root).add_experiment(
        "e", timestep=DT, units="metal"
    )
    if budget is not None:
        planner = importlib.import_module(package + ".memory.planner")
        exp.planner = planner.BatchPlanner(memory_budget_bytes=budget)
    exp.add_data(str(path))
    return exp


@pytest.mark.parametrize(
    "kw",
    [
        dict(data_range=20),
        dict(data_range=15, correlation_time=3),
        dict(data_range=12, correlation_time=25),  # gaps between windows
        dict(data_range=20, tau_values=[0, 2, 5, 9, 14, 19]),
    ],
    ids=["ct1", "ct3", "ct-gt-range", "tau-subset"],
)
def test_transport_from_a_dump_matches_jax(tmp_path, kw):
    """The same dump through both packages: Einstein (auto-unwrap) and GK."""
    path, _, _ = _dump(tmp_path / "t.lammpstrj")
    results = {}
    for package in ("lammps_analysis_tpu_torch", "lammps_analysis_tpu"):
        exp = _experiment(package, tmp_path / package, path)
        results[package] = (
            exp.run.EinsteinDiffusionCoefficients(plot=False, **kw).data_dict,
            exp.run.GreenKuboDiffusionCoefficients(plot=False, **kw).data_dict,
        )
    ours, ref = results["lammps_analysis_tpu_torch"], results["lammps_analysis_tpu"]
    assert set(ours[0]) == set(ref[0]) == {"Na", "Cl"}
    assert_einstein_close(ours[0], ref[0])
    assert_gk_close(ours[1], ref[1])


def test_transport_matches_the_numpy_oracles(tmp_path):
    """Against ``einstein_msd_reference`` and ``gk_self_diffusion_reference``
    on the stored arrays (MDSuite's windowing, counters and units)."""
    import lammps_analysis_tpu_torch as lt

    path, _, _ = _dump(tmp_path / "t.lammpstrj")
    exp = lt.Project(name="p", storage_path=tmp_path).add_experiment(
        "e", timestep=DT, units="metal", simulation_data=str(path)
    )
    einstein = exp.run.EinsteinDiffusionCoefficients(data_range=20, correlation_time=2, plot=False)
    gk = exp.run.GreenKuboDiffusionCoefficients(data_range=20, correlation_time=2, plot=False)
    u = exp.units
    for sp in ("Na", "Cl"):
        x = exp.store.load([f"{sp}/Unwrapped_Positions"])[f"{sp}/Unwrapped_Positions"]
        times, msd = oracle.einstein_msd_reference(
            x.astype(np.float64), 20, 2, DT, EVERY, u.length, u.time
        )
        np.testing.assert_allclose(einstein[sp]["time"], times, rtol=1e-12)
        np.testing.assert_allclose(einstein[sp]["msd"], msd, rtol=1e-5)
        v = exp.store.load([f"{sp}/Velocities"])[f"{sp}/Velocities"]
        _, acf, integral, sem, d = oracle.gk_self_diffusion_reference(
            v.astype(np.float64), 20, 2, DT, EVERY, u.length, u.time, 19
        )
        scale = 1e-5 * acf[0] * times[-1]
        np.testing.assert_allclose(gk[sp]["acf"], acf, rtol=1e-5, atol=1e-5 * acf[0])
        np.testing.assert_allclose(gk[sp]["integral"], integral, rtol=1e-5, atol=scale)
        np.testing.assert_allclose(gk[sp]["integral_uncertainty"], sem, rtol=1e-5, atol=scale)
        np.testing.assert_allclose(gk[sp]["diffusion_coefficient"][0], d, rtol=1e-5, atol=scale)
        assert_series_match_direct(einstein[sp], gk[sp], x, v, 20, 2, u.length, u.time)


def test_random_walk_gives_the_analytic_coefficient(tmp_path):
    """A random walk of per-axis step sigma per frame interval dt: D =
    sigma^2 / (2 dt) by Einstein (the MSD's slope) and by Green-Kubo (white
    velocities: the trapezoid of the delta-like VACF). 300 atoms a species
    over 400 frames put the statistical error near 1 %: within 5 %."""
    import lammps_analysis_tpu_torch as lt

    sigma = 0.3
    path, _, _ = _dump(tmp_path / "t.lammpstrj", counts=(300, 300), n_frames=400, sigma=sigma)
    exp = lt.Project(name="p", storage_path=tmp_path).add_experiment(
        "e", timestep=DT, units="metal", simulation_data=str(path)
    )
    expected = sigma**2 / (2 * DT * EVERY) * 1e-8  # A^2/ps -> m^2/s
    einstein = exp.run.EinsteinDiffusionCoefficients(data_range=40, plot=False)
    gk = exp.run.GreenKuboDiffusionCoefficients(data_range=40, plot=False)
    for sp in ("Na", "Cl"):
        assert abs(einstein[sp]["diffusion_coefficient"] / expected - 1) < 0.05, sp
        assert abs(gk[sp]["diffusion_coefficient"][0] / expected - 1) < 0.05, sp


@pytest.mark.parametrize(
    "calculator, budget",
    [("EinsteinDiffusionCoefficients", 20000), ("GreenKuboDiffusionCoefficients", 200000)],
)
def test_atom_minibatches_equal_one_group(tmp_path, caplog, calculator, budget):
    """A budget too small for one window of all atoms splits the atom axis
    (and the frames) into several groups and slabs; the result equals the
    one-group run within float64 rounding (rtol 1e-9)."""
    path, _, _ = _dump(tmp_path / "t.lammpstrj")
    results = []
    for name, b in (("one", None), ("split", budget)):
        exp = _experiment("lammps_analysis_tpu_torch", tmp_path / name, path, budget=b)
        with caplog.at_level("INFO"):
            results.append(getattr(exp.run, calculator)(data_range=20, plot=False).data_dict)
    assert "splitting the atom axis" in caplog.text
    one, split = results
    for sp in one:
        for key, value in one[sp].items():
            np.testing.assert_allclose(split[sp][key], value, rtol=1e-9, atol=0, err_msg=f"{sp} {key}")


def test_gk_acf_batches_follow_the_experiment_budget(tmp_path, monkeypatch):
    """The ACF sizes its FFT batches from the experiment planner's budget: a
    small budget runs a slab's windows in more batches than the 32-window
    cap of a large one, and gives its result within float64 rounding (rtol
    1e-9)."""
    path, _, _ = _dump(tmp_path / "t.lammpstrj")
    windowed = correlation.windowed_acf_sum
    rfft = torch.fft.rfft
    results, n_batches = [], []
    for name, budget in (("large", 2**30), ("small", 400_000)):
        exp = _experiment("lammps_analysis_tpu_torch", tmp_path / name, path, budget=budget)
        budgets, batches = [], []

        def recording(x, window, stride, budget_bytes, tau=None):
            budgets.append(budget_bytes)
            return windowed(x, window, stride, budget_bytes, tau=tau)

        def counting(*args, **kwargs):
            batches.append(1)
            return rfft(*args, **kwargs)

        with monkeypatch.context() as m:
            m.setattr(correlation, "windowed_acf_sum", recording)
            m.setattr(torch.fft, "rfft", counting)
            results.append(exp.run.GreenKuboDiffusionCoefficients(data_range=20, plot=False).data_dict)
        assert budgets and set(budgets) == {budget}
        n_batches.append(len(batches))
    assert n_batches[1] > n_batches[0] > 0, n_batches
    for sp in results[0]:
        for key, value in results[0][sp].items():
            np.testing.assert_allclose(results[1][sp][key], value, rtol=1e-9, atol=0, err_msg=key)


def test_einstein_on_a_carried_jax_store_skips_the_unwrap(tmp_path, monkeypatch):
    """A JAX ``database.h5`` holding ``Unwrapped_Positions`` (float64),
    carried across with ``store_from_hdf5``: the port's Einstein reads it as
    it is, runs no transformation, and gives the JAX result."""
    import lammps_analysis_tpu as latpu

    import lammps_analysis_tpu_torch as lt
    from lammps_analysis_tpu_torch.database.convert import store_from_hdf5
    from lammps_analysis_tpu_torch.transformations import base as trafo_base

    path, _, _ = _dump(tmp_path / "t.lammpstrj")
    jax_project = latpu.Project(name="p", storage_path=tmp_path / "jax")
    jax_exp = jax_project.add_experiment("e", timestep=DT, units="metal", simulation_data=str(path))
    jax_exp.run.CoordinateUnwrapper()

    port_root = tmp_path / "torch" / "p"
    (port_root / "e").mkdir(parents=True)
    with contextlib.closing(sqlite3.connect(jax_project.path / "project.db")) as src, \
            contextlib.closing(sqlite3.connect(port_root / "project.db")) as dst:
        src.backup(dst)
    store_from_hdf5(jax_exp.store.path, port_root / "e" / "database")

    def refuse(*args, **kwargs):
        raise AssertionError("the unwrap is stored: no transformation may run")

    monkeypatch.setattr(trafo_base.Transformation, "run_transformation", refuse)
    port_exp = lt.Project(name="p", storage_path=tmp_path / "torch").experiments["e"]
    ours = port_exp.run.EinsteinDiffusionCoefficients(data_range=20, plot=False).data_dict
    ref = jax_exp.run.EinsteinDiffusionCoefficients(data_range=20, plot=False).data_dict
    assert_einstein_close(ours, ref)


def test_transport_cache_hit_and_missing_property(tmp_path, monkeypatch):
    import lammps_analysis_tpu_torch as lt
    from lammps_analysis_tpu_torch.ops import msd

    path, _, _ = _dump(tmp_path / "t.lammpstrj")
    exp = lt.Project(name="p", storage_path=tmp_path).add_experiment(
        "e", timestep=DT, units="metal", simulation_data=str(path)
    )
    first = exp.run.EinsteinDiffusionCoefficients(data_range=20, plot=False)
    calls = []
    original = msd.windowed_msd_sum

    def counting(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(msd, "windowed_msd_sum", counting)
    again = exp.run.EinsteinDiffusionCoefficients(data_range=20, plot=False)
    assert not calls and again.data_dict == first.data_dict
    exp.run.EinsteinDiffusionCoefficients(data_range=20, plot=False, force=True)
    assert calls
    exp.store.drop("Na/Velocities")
    with pytest.raises(ValueError, match="no transformation produces it"):
        exp.run.GreenKuboDiffusionCoefficients(data_range=20, plot=False)
    with pytest.raises(ValueError, match="exceeds"):
        exp.run.EinsteinDiffusionCoefficients(data_range=500, plot=False)
