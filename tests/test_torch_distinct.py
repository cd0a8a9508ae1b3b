"""PyTorch port, the distinct diffusion pair: ``EinsteinDistinctDiffusionCoefficients``
and ``GreenKuboDistinctDiffusionCoefficients`` from a LAMMPS dump, held against
the JAX package on the same dump, against the direct O(Na x Nb) numpy
oracles of ``tests/reference_oracles.py``, and against themselves under atom
minibatches; and ``NernstEinsteinIonicConductivity(corrected=True)``, which
now runs the distinct Einstein pair itself.

Tolerances. The port keeps float32 data and float32 self terms summed in
float64, and forms the cross terms from float64 particle sums; the JAX
package runs here with x64 on. For identical species the distinct series is
the cross term less the self term, about -(1 - 1/N) times the self term, so
errors scale with the same-species series: every series within rtol 1e-5
plus an atol of 1e-6 x the largest same-species value of that series, D the
same (its atol 1e-6 x the largest same-species |D|), the GK uncertainty
within rtol 1e-3 (the Einstein one too: both come from noisy per-window
values or fit residuals).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_oracles as oracle
from lammps_analysis_tpu.ops import correlation as jcorr
from lammps_analysis_tpu_torch.ops import correlation
from lammps_analysis_tpu_torch.utils.config import config

from torch_dumps import (
    assert_distinct_close,
    distinct_series_direct,
    random_walk,
    walk_columns,
    write_dump,
)
from torch_jax_parser import ensure_jax_native_parser

torch.set_num_threads(1)

DT, EVERY = 0.002, 10  # ps, frames written every 10 steps
PORT, JAX = "lammps_analysis_tpu_torch", "lammps_analysis_tpu"
SERIES = {"EinsteinDistinctDiffusionCoefficients": "msd",
          "GreenKuboDistinctDiffusionCoefficients": "vacf"}


@pytest.fixture(scope="module", autouse=True)
def jax_reads_natively():
    ensure_jax_native_parser()


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def _dump(path, counts=(12, 8), n_frames=80, sigma=0.3, seed=41):
    wrapped, unwrapped, vel, names = random_walk(counts, n_frames, 10.0, sigma, DT * EVERY, seed)
    write_dump(path, 10.0, walk_columns(wrapped, vel, names), every=EVERY, shuffle_seed=seed)
    return path


def _experiment(package, root, path, budget=None, temperature=None):
    pkg = importlib.import_module(package)
    exp = pkg.Project(name="p", storage_path=root).add_experiment(
        "e", timestep=DT, units="metal", temperature=temperature
    )
    if budget is not None:
        planner = importlib.import_module(package + ".memory.planner")
        exp.planner = planner.BatchPlanner(memory_budget_bytes=budget)
    exp.add_data(str(path))
    return exp


@pytest.mark.parametrize("total, window, stride", [
    (50, 10, 1), (50, 10, 3), (50, 10, 13), (8, 10, 1), (50, 50, 1), (0, 1, 1),
])
def test_window_starts_match_jax(total, window, stride):
    ours = correlation.window_starts(total, window, stride)
    assert ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jcorr.window_starts(total, window, stride)))


@pytest.mark.parametrize("shape, dim", [((20, 3), 0), ((4, 17, 3), 1), ((2, 5, 9), -1), ((7, 1), 0)])
def test_cross_correlation_matches_jax(shape, dim):
    """A batch of windows in the leading dimensions, any correlation axis, in
    the inputs' dtype."""
    rng = np.random.default_rng(len(shape) + shape[0])
    x, y = rng.normal(size=(2, *shape))
    ours = correlation.cross_correlation_biased(torch.from_numpy(x), torch.from_numpy(y), dim=dim)
    ref = jcorr.cross_correlation_biased(jnp.asarray(x), jnp.asarray(y), axis=dim)
    assert ours.dtype == torch.float64 and ours.shape == x.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
    single = correlation.cross_correlation_biased(torch.from_numpy(x).float(), torch.from_numpy(y).float(), dim)
    assert single.dtype == torch.float32


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
@pytest.mark.parametrize("calculator", list(SERIES))
def test_distinct_pair_matches_jax(tmp_path, calculator, kw):
    """The same dump through both packages (the Einstein pair auto-unwraps)."""
    path = _dump(tmp_path / "t.lammpstrj")
    results = {}
    for package in (PORT, JAX):
        exp = _experiment(package, tmp_path / package, path)
        results[package] = getattr(exp.run, calculator)(plot=False, **kw).data_dict
    assert_distinct_close(results[PORT], results[JAX], SERIES[calculator])


def test_distinct_pair_matches_the_numpy_oracles(tmp_path):
    """Against ``distinct_einstein_msd_reference`` and
    ``distinct_gk_vacf_reference`` on the stored arrays: the direct Gram loop
    over every (i, j) pair, the independent check of the bilinear form."""
    import lammps_analysis_tpu_torch as lt

    path = _dump(tmp_path / "t.lammpstrj")
    exp = lt.Project(name="p", storage_path=tmp_path).add_experiment(
        "e", timestep=DT, units="metal", simulation_data=str(path)
    )
    kw = dict(data_range=20, correlation_time=2, plot=False)
    einstein = exp.run.EinsteinDistinctDiffusionCoefficients(**kw)
    gk = exp.run.GreenKuboDistinctDiffusionCoefficients(**kw)
    u = exp.units
    x = {sp: exp.store.load([f"{sp}/Unwrapped_Positions"])[f"{sp}/Unwrapped_Positions"].astype(np.float64)
         for sp in ("Na", "Cl")}
    v = {sp: exp.store.load([f"{sp}/Velocities"])[f"{sp}/Velocities"].astype(np.float64)
         for sp in ("Na", "Cl")}
    ref_e, ref_gk = {}, {}
    for pair in ("Na_Na", "Na_Cl", "Cl_Cl"):
        a, b = pair.split("_")
        msd = oracle.distinct_einstein_msd_reference(x[a], x[b], 20, 2, a == b, u.length)
        vacf, d, sem = oracle.distinct_gk_vacf_reference(
            v[a], v[b], 20, 2, a == b, DT, EVERY, u.length, u.time
        )
        ref_e[pair] = {"msd": msd}
        ref_gk[pair] = {"vacf": vacf, "diffusion_coefficient": d, "uncertainty": sem}
        # the bilinear float64 sums chip_smoke.py checks the full-size series with
        np.testing.assert_allclose(
            distinct_series_direct(x[a], x[b], 20, 2, a == b, "msd", u.length), msd, rtol=1e-10,
            atol=1e-10 * np.abs(msd).max())
        direct_vacf, direct_d = distinct_series_direct(v[a], v[b], 20, 2, a == b, "vacf", u.length,
                                                       u.time, DT * EVERY)
        np.testing.assert_allclose(direct_vacf, vacf, rtol=1e-10, atol=1e-10 * np.abs(vacf).max())
        np.testing.assert_allclose(direct_d, d, rtol=1e-10, atol=1e-10 * abs(d))
    for ours, ref, key in ((einstein, ref_e, "msd"), (gk, ref_gk, "vacf")):
        scale = {name: max(np.abs(ref[p][name]).max() for p in ("Na_Na", "Cl_Cl"))
                 for name in ref["Na_Na"]}
        for pair, values in ref.items():
            for name, value in values.items():
                rtol = 1e-3 if name == "uncertainty" else 1e-5
                np.testing.assert_allclose(ours[pair][name], value, rtol=rtol, atol=1e-6 * scale[name],
                                           err_msg=f"{pair} {name}")


@pytest.mark.parametrize("calculator, budget", [
    ("EinsteinDistinctDiffusionCoefficients", 20000),
    ("GreenKuboDistinctDiffusionCoefficients", 20000),
])
def test_atom_minibatches_equal_one_group(tmp_path, caplog, calculator, budget):
    """A budget too small for one window of both species' atoms splits every
    species' atom axis into the same number of groups; the slab sums add up
    to the one-group series within float64 rounding (rtol 1e-9)."""
    path = _dump(tmp_path / "t.lammpstrj")
    results = []
    for name, b in (("one", None), ("split", budget)):
        exp = _experiment(PORT, tmp_path / name, path, budget=b)
        with caplog.at_level("INFO"):
            results.append(getattr(exp.run, calculator)(
                data_range=24, correlation_time=6, plot=False).data_dict)
    assert "splitting the atom axis" in caplog.text
    one, split = results
    key = SERIES[calculator]
    scale = max(np.abs(one[p][key]).max() for p in ("Na_Na", "Cl_Cl"))
    for pair in one:
        for name, value in one[pair].items():
            np.testing.assert_allclose(split[pair][name], value, rtol=1e-9,
                                       atol=1e-12 * scale if name == key else 0,
                                       err_msg=f"{pair} {name}")


def test_distinct_tau_values_and_too_few_frames(tmp_path):
    """``tau_values`` as a sub-sample count (``tests/test_tau_values.py``), one
    species; a data_range past the frames raises."""
    import lammps_analysis_tpu_torch as lt

    path = _dump(tmp_path / "t.lammpstrj", n_frames=300)
    exp = lt.Project(name="p", storage_path=tmp_path).add_experiment(
        "e", timestep=DT, units="metal", simulation_data=str(path)
    )
    res = exp.run.EinsteinDistinctDiffusionCoefficients(
        data_range=40, correlation_time=20, tau_values=10, species=["Na"], plot=False
    )
    assert list(res.data_dict) == ["Na_Na"]
    assert len(res["Na_Na"]["msd"]) == 10
    assert np.isfinite(res["Na_Na"]["diffusion_coefficient"])
    gk = exp.run.GreenKuboDistinctDiffusionCoefficients(
        data_range=32, correlation_time=16, tau_values=slice(None, None, 2), plot=False
    )
    assert len(gk["Na_Cl"]["vacf"]) == 16
    for name in SERIES:
        with pytest.raises(ValueError, match="exceeds"):
            getattr(exp.run, name)(data_range=500, plot=False)


def test_gk_distinct_ffts_follow_the_experiment_budget(tmp_path, monkeypatch):
    """The same-species self term sizes its FFT batches from the planner's
    budget, as the GK self-diffusion does."""
    path = _dump(tmp_path / "t.lammpstrj")
    exp = _experiment(PORT, tmp_path / "p", path, budget=400_000)
    windowed = correlation.windowed_acf_sum
    budgets = []

    def recording(x, window, stride, budget_bytes, tau=None):
        budgets.append(budget_bytes)
        return windowed(x, window, stride, budget_bytes, tau=tau)

    monkeypatch.setattr(correlation, "windowed_acf_sum", recording)
    exp.run.GreenKuboDistinctDiffusionCoefficients(data_range=20, plot=False)
    assert len(budgets) == 2 and set(budgets) == {400_000}  # Na_Na and Cl_Cl


def test_corrected_nernst_einstein_runs_the_distinct_pair_as_jax_does(tmp_path):
    """``corrected=True`` without ``distinct_diffusion_data``: both packages
    auto-run the Einstein self and distinct pairs over the same dump and give
    the same conductivities."""
    path = _dump(tmp_path / "t.lammpstrj", n_frames=120)
    results = {}
    for package in (PORT, JAX):
        exp = _experiment(package, tmp_path / package, path, temperature=1200.0)
        exp.set_charge("Na", 1.0)
        exp.set_charge("Cl", -1.0)
        res = exp.run.NernstEinsteinIonicConductivity(corrected=True, data_range=30, plot=False)
        assert res.args["distinct_source"] == "EinsteinDistinctDiffusionCoefficients"
        results[package] = res["System"]
    ours, ref = results[PORT], results[JAX]
    assert set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_allclose(ours[key], value, rtol=1e-4, err_msg=key)
    assert np.isfinite(ours["corrected_nernst_einstein_ionic_conductivity"])


def test_run_hub_carries_every_reference_name(tmp_path):
    """Every calculator and transformation name of the reference's run hub
    (``tests/test_calculators_integration.py``) resolves on the port's
    ``exp.run``; the port's calculator registry is the JAX package's, in its
    order."""
    import lammps_analysis_tpu_torch as lt
    from lammps_analysis_tpu.calculators import ALL_CALCULATORS as JAX_CALCULATORS
    from lammps_analysis_tpu_torch.calculators import ALL_CALCULATORS

    reference_names = [
        "AngularDistributionFunction", "CoordinateUnwrapper", "CoordinateWrapper",
        "CoordinationNumbers", "EinsteinDiffusionCoefficients",
        "EinsteinDistinctDiffusionCoefficients", "EinsteinHelfandIonicConductivity",
        "EinsteinHelfandThermalConductivity", "EinsteinHelfandThermalKinaci",
        "GreenKuboDiffusionCoefficients", "GreenKuboDistinctDiffusionCoefficients",
        "GreenKuboIonicConductivity", "GreenKuboThermalConductivity", "GreenKuboViscosity",
        "GreenKuboViscosityFlux", "IntegratedHeatCurrent", "IonicCurrent",
        "KinaciIntegratedHeatCurrent", "KirkwoodBuffIntegral", "MolecularMap", "MomentumFlux",
        "NernstEinsteinIonicConductivity", "PotentialOfMeanForce", "RadialDistributionFunction",
        "ScaleCoordinates", "SpatialDistributionFunction", "StructureFactor", "ThermalFlux",
        "TranslationalDipoleMoment", "UnwrapViaIndices", "VelocityFromPositions",
    ]
    exp = lt.Project(name="parity", storage_path=tmp_path).add_experiment(
        "e", timestep=1.0, temperature=300.0, units="metal"
    )
    missing = [n for n in reference_names if not hasattr(exp.run, n)]
    assert not missing, f"run hub missing reference names: {missing}"
    assert sorted(ALL_CALCULATORS) == sorted(JAX_CALCULATORS)
    jax_order = [n for n in JAX_CALCULATORS]
    assert [n for n in ALL_CALCULATORS if n in ("EinsteinDistinctDiffusionCoefficients",
            "GreenKuboDistinctDiffusionCoefficients", "SpatialDistributionFunction")] == [
        n for n in jax_order if n in ("EinsteinDistinctDiffusionCoefficients",
                                      "GreenKuboDistinctDiffusionCoefficients",
                                      "SpatialDistributionFunction")]
