"""PyTorch port, the seven system calculators (Green-Kubo and
Einstein-Helfand ionic and thermal conductivities, Green-Kubo viscosities)
over ``Observables`` series, held against the JAX package on the same
ingested data, against white-noise analytic values and against the float64
estimators of ``tests/torch_dumps.py``.

Tolerances (the transport tolerance of ``tests/torch_dumps.py``). Inputs
are float32 values; the port stores float32 and sums in float64, the JAX
package runs with x64 on. Einstein-Helfand: every output within rtol 1e-5.
Green-Kubo: the ACF within rtol 1e-5 plus 1e-5 x acf[0]; integrals within
rtol 1e-5 plus 1e-5 x acf[0] x the longest lag time; the coefficient and
its uncertainty the same, times the calculator's prefactor. Each package
gets its own ``tmp_path`` directory (the cache key is the class name).
"""

import importlib

import numpy as np
import pytest
import torch

from lammps_analysis_tpu_torch.ops import correlation
from lammps_analysis_tpu_torch.utils.config import config
from lammps_analysis_tpu_torch.utils.fitting import fit_einstein_curve
from lammps_analysis_tpu_torch.utils.units import METAL, boltzmann_constant, elementary_charge

from torch_dumps import assert_system_close, gk_system_direct, msd_system_direct, write_flux_file
from torch_jax_parser import ensure_jax_native_parser

torch.set_num_threads(1)

PACKAGES = ("lammps_analysis_tpu_torch", "lammps_analysis_tpu")


@pytest.fixture(scope="module", autouse=True)
def jax_reads_natively():
    ensure_jax_native_parser()


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def _f32(x):
    return np.asarray(x, np.float32).astype(np.float64)


def _script_experiment(package, root, species, n_frames, data, dt, units="si", box=10.0,
                       temperature=300.0, charges=None, budget=None):
    """A project under ``root/package`` holding ``data[(species, property)]``
    through ``ScriptInput``."""
    pkg = importlib.import_module(package)
    db = importlib.import_module(package + ".database")
    props = {}
    for (sp, prop), arr in data.items():
        props.setdefault(sp, []).append(db.PropertyInfo(prop, arr.shape[-1]))
    sp_info = [db.SpeciesInfo(sp, species[sp], props[sp]) for sp in species]
    meta = db.TrajectoryMetadata(n_configurations=n_frames, species_list=sp_info, box_l=[box] * 3,
                                 sample_rate=1, temperature=temperature)
    chunk = db.TrajectoryChunkData(sp_info, n_frames)
    for (sp, prop), arr in data.items():
        chunk.add_data(arr, 0, sp, prop)
    script = importlib.import_module(package + ".file_io").ScriptInput(chunk, meta, "data")
    exp = pkg.Project(name="p", storage_path=root / package).add_experiment(
        "e", timestep=dt, temperature=temperature, units=units, simulation_data=script
    )
    if budget is not None:
        exp.planner = importlib.import_module(package + ".memory.planner").BatchPlanner(
            memory_budget_bytes=budget
        )
    for sp, q in (charges or {}).items():
        exp.set_charge(sp, q)
    return exp


def _ionic(package, root, n_frames=1500, n_each=16, sigma_v=1.0, dt=0.05, units="si", box=10.0,
           seed=7, **kw):
    """Two oppositely charged species with white-noise velocities and the
    positions they integrate to."""
    rng = np.random.default_rng(seed)
    data = {}
    for sp in ("Na", "Cl"):
        v = _f32(rng.normal(scale=sigma_v, size=(n_frames, n_each, 3)))
        data[(sp, "Velocities")] = v
        data[(sp, "Unwrapped_Positions")] = _f32(np.cumsum(v * dt, axis=0))
    return _script_experiment(package, root, {"Na": n_each, "Cl": n_each}, n_frames, data, dt,
                              units=units, box=box, charges={"Na": 1.0, "Cl": -1.0}, **kw)


def _observables(package, root, prop, n_frames=4000, sigma=2.0, dt=0.1, seed=42, **kw):
    """A white-noise ``Observables/<prop>`` series of sd ``sigma`` per axis
    (by default the JAX tests' series: 4000 frames of ``default_rng(42)``)."""
    rng = np.random.default_rng(seed)
    series = _f32(rng.normal(scale=sigma, size=(n_frames, 1, 3)))
    return _script_experiment(package, root, {"Observables": 1}, n_frames,
                              {("Observables", prop): series}, dt, **kw)


def _both(make, root, calculator, **kw):
    """``(ours, ref)`` data dicts of ``calculator`` on the experiments that
    ``make(package, root)`` builds in each package."""
    out = []
    for package in PACKAGES:
        exp = make(package, root)
        out.append(getattr(exp.run, calculator)(plot=False, **kw).data_dict["System"])
    return out


def _sigma_expected(n_total, sigma_v, dt, temperature, volume):
    return elementary_charge**2 * n_total * sigma_v**2 * dt / (2 * boltzmann_constant * temperature * volume)


# ------------------------------------------------------------------ ionic
@pytest.mark.parametrize(
    "calculator, kw, bound",
    [
        ("GreenKuboIonicConductivity", dict(data_range=64, correlation_time=32), 0.2),
        ("EinsteinHelfandIonicConductivity", dict(data_range=64, correlation_time=32), 0.4),
        ("GreenKuboIonicConductivity", dict(data_range=64, tau_values=[0, 1, 2, 4, 8, 16, 32, 63]), None),
        ("GreenKuboIonicConductivity", dict(data_range=40, correlation_time=7, integration_range=20), None),
        ("EinsteinHelfandIonicConductivity", dict(data_range=64, correlation_time=5, tau_values=16), None),
        ("EinsteinHelfandIonicConductivity", dict(data_range=48, fit_range=30), None),
    ],
    ids=["gk", "eh", "gk-tau-list", "gk-integration-range", "eh-tau-count", "eh-fit-range"],
)
def test_ionic_conductivity_matches_jax(tmp_path, calculator, kw, bound):
    """The ionic current and dipole moment from velocities and positions
    with charges from the metadata (the flux transformation runs first),
    then the GK or EH estimator; white noise gives sigma = e^2 N s^2 dt /
    (2 kB T V) (within 20 % / 40 %, the JAX tests' bounds at 1500 frames)."""
    ours, ref = _both(_ionic, tmp_path, calculator, **kw)
    assert_system_close(ours, ref)
    if bound is not None:
        value = np.ravel(ours["ionic_conductivity"])[0]
        expected = _sigma_expected(32, 1.0, 0.05, 300.0, 1000.0)
        assert abs(value / expected - 1) < bound


def test_gk_ionic_conductivity_metal_units_matches_jax(tmp_path):
    """Unit plumbing: the analytic value in LAMMPS metal units."""
    sigma_v, dt, box = 3.0, 0.01, 12.0

    def make(package, root):
        return _ionic(package, root, n_frames=2000, sigma_v=sigma_v, dt=dt, units="metal", box=box)

    ours, ref = _both(make, tmp_path, "GreenKuboIonicConductivity", data_range=64, correlation_time=32)
    assert_system_close(ours, ref)
    expected = (elementary_charge**2 * METAL.length**2 * 32 * sigma_v**2 * dt
                / (2 * boltzmann_constant * 300.0 * box**3 * METAL.volume * METAL.time))
    assert abs(ours["ionic_conductivity"][0] / expected - 1) < 0.2


# ------------------------------------------------------- thermal, viscosity
@pytest.mark.parametrize(
    "calculator, prop, analytic",
    [
        ("GreenKuboThermalConductivity", "Thermal_Flux",
         lambda w: 2.0**2 * 0.1 / (2 * boltzmann_constant * 300.0**2 * 1000.0) * w / (w - 1)),
        ("GreenKuboViscosity", "Momentum_Flux",
         lambda w: 2.0**2 * 0.1 / (2 * boltzmann_constant * 300.0 * 1000.0) * w / (w - 1)),
        ("EinsteinHelfandThermalConductivity", "Integrated_Heat_Current", None),
        ("EinsteinHelfandThermalKinaci", "Kinaci_Heat_Current", None),
    ],
    ids=["gk-thermal", "gk-viscosity", "eh-thermal", "eh-kinaci"],
)
def test_observables_series_match_jax(tmp_path, calculator, prop, analytic):
    """A stored white-noise series of sd 2 per axis: the GK thermal
    conductivity and viscosity give sigma^2 dt W / (W - 1) / (2 kB T^a V)
    (SI, within 15 %, the JAX tests' bound)."""
    w = 64

    def make(package, root):
        return _observables(package, root, prop)

    ours, ref = _both(make, tmp_path, calculator, data_range=w, correlation_time=32)
    assert_system_close(ours, ref)
    if analytic is not None:
        value = np.ravel(next(v for k, v in ours.items() if k in ("thermal_conductivity", "viscosity")))[0]
        assert abs(value / analytic(w) - 1) < 0.15


def _flux_file(path, n_steps=3000, seed=12):
    rng = np.random.default_rng(seed)
    stress = rng.normal(scale=1.5, size=(n_steps, 3))
    flux = rng.normal(scale=2.0, size=(n_steps, 3))
    write_flux_file(path, {
        "time": np.arange(n_steps), "temp": 300.0 + rng.normal(size=n_steps),
        "c_flux_thermal[1]": flux[:, 0], "c_flux_thermal[2]": flux[:, 1], "c_flux_thermal[3]": flux[:, 2],
        "pxy": stress[:, 0], "pxz": stress[:, 1], "pyz": stress[:, 2],
    })
    return path


@pytest.mark.parametrize(
    "calculator, analytic",
    [
        ("GreenKuboViscosityFlux",
         lambda w: 1000.0 * 1.5**2 * 0.1 / (2 * boltzmann_constant * 300.0) * w / (w - 1)),
        ("GreenKuboThermalConductivity",
         lambda w: 2.0**2 * 0.1 / (2 * boltzmann_constant * 300.0**2 * 1000.0) * w / (w - 1)),
    ],
    ids=["viscosity-flux", "thermal"],
)
def test_flux_file_feeds_the_calculators_like_jax(tmp_path, calculator, analytic):
    """A LAMMPS flux file (``LAMMPSFluxFile``) feeds ``Stress_Visc`` and
    ``Thermal_Flux`` straight to the calculators, no transformation: the
    white-noise value (the flux-file viscosity has the volume in the
    numerator) within 20 %, the JAX test's bound."""
    path = _flux_file(tmp_path / "flux.dat")

    def make(package, root):
        pkg = importlib.import_module(package)
        reader = importlib.import_module(package + ".file_io").LAMMPSFluxFile(
            path, sample_rate=1, box_l=[10.0] * 3
        )
        return pkg.Project(name="p", storage_path=root / package).add_experiment(
            "visc", timestep=0.1, temperature=300.0, units="si", simulation_data=reader
        )

    ours, ref = _both(make, tmp_path, calculator, data_range=64, correlation_time=32)
    assert_system_close(ours, ref)
    value = np.ravel(next(v for k, v in ours.items() if k in ("thermal_conductivity", "viscosity")))[0]
    assert abs(value / analytic(64) - 1) < 0.2


def _per_atom(package, root, n_frames=600, n_atoms=12, dt=0.1, seed=13):
    rng = np.random.default_rng(seed)
    shape = (n_frames, n_atoms)
    data = {
        ("X", "Stress"): rng.normal(size=shape + (6,)),
        ("X", "Velocities"): rng.normal(size=shape + (3,)),
        ("X", "Kinetic_Energy"): rng.normal(size=shape + (1,)) ** 2,
        ("X", "Potential_Energy"): -rng.normal(size=shape + (1,)) ** 2,
        ("X", "Unwrapped_Positions"): np.cumsum(rng.normal(scale=0.05, size=shape + (3,)), axis=0),
        ("X", "Forces"): rng.normal(size=shape + (3,)),
    }
    return _script_experiment(package, root, {"X": n_atoms}, n_frames,
                              {k: _f32(v) for k, v in data.items()}, dt)


def test_thermal_chain_from_per_atom_data_matches_jax(tmp_path):
    """Per-atom stress, energies, velocities, positions and forces ->
    ThermalFlux, IntegratedHeatCurrent, KinaciIntegratedHeatCurrent and
    MomentumFlux (each run by the calculator's dependency check) -> the four
    calculators, against the JAX package."""
    calcs = ("GreenKuboThermalConductivity", "EinsteinHelfandThermalConductivity",
             "EinsteinHelfandThermalKinaci", "GreenKuboViscosity")
    results = {}
    for package in PACKAGES:
        exp = _per_atom(package, tmp_path)
        results[package] = {c: getattr(exp.run, c)(data_range=64, correlation_time=64, plot=False)
                            .data_dict["System"] for c in calcs}
        for prop in ("Thermal_Flux", "Integrated_Heat_Current", "Kinaci_Heat_Current", "Momentum_Flux"):
            assert exp.store.check_existence(f"Observables/{prop}")
    for c in calcs:
        assert_system_close(results[PACKAGES[0]][c], results[PACKAGES[1]][c])


def test_kinaci_reference_accumulation_through_the_hub_matches_jax(tmp_path):
    """``exp.run.KinaciIntegratedHeatCurrent(reference_accumulation=True)``
    writes the upstream coupled accumulation, as the JAX package does, and
    it differs from the per-species default."""
    rng = np.random.default_rng(14)
    data = {}
    for sp in ("Na", "Cl"):
        shape = (300, 6)
        data[(sp, "Unwrapped_Positions")] = _f32(np.cumsum(rng.normal(scale=0.05, size=shape + (3,)), axis=0))
        data[(sp, "Velocities")] = _f32(rng.normal(size=shape + (3,)))
        data[(sp, "Forces")] = _f32(rng.normal(size=shape + (3,)))
        data[(sp, "Potential_Energy")] = _f32(-rng.normal(size=shape + (1,)) ** 2)
    series = {}
    for package in PACKAGES:
        for mode in (True, False):
            exp = _script_experiment(package, tmp_path / str(mode), {"Na": 6, "Cl": 6}, 300, data, 0.1)
            exp.run.KinaciIntegratedHeatCurrent(reference_accumulation=mode)
            path = "Observables/Kinaci_Heat_Current"
            series[(package, mode)] = np.asarray(exp.store.load([path])[path][:, 0], np.float64)
    for mode in (True, False):
        ref = series[(PACKAGES[1], mode)]
        np.testing.assert_allclose(series[(PACKAGES[0], mode)], ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    assert not np.allclose(series[(PACKAGES[0], True)], series[(PACKAGES[0], False)])


# ------------------------------------------------------- reference estimator
def test_gk_thermal_reference_estimator_matches_jax_and_the_first_window(tmp_path):
    """``reference_estimator=True``: value = prefactor x the trapezoid of the
    FIRST window's data_range-scaled ACF, "uncertainty" the SECOND window's
    (``green_kubo_thermal_conductivity.py:199-233``), held against the JAX
    package and a float64 numpy evaluation on the stored series; a separate
    cache entry from the window average."""
    w, ct = 64, 32

    def make(package, root):
        return _observables(package, root, "Thermal_Flux", n_frames=600)

    ours, ref = _both(make, tmp_path, "GreenKuboThermalConductivity", data_range=w, correlation_time=ct,
                      reference_estimator=True)
    assert_system_close(ours, ref)
    exp = _observables(PACKAGES[0], tmp_path / "again", "Thermal_Flux", n_frames=600)
    x = exp.store.load(["Observables/Thermal_Flux"])["Observables/Thermal_Flux"][:, 0].astype(np.float64)
    times = np.arange(w) * 0.1

    def window_jacf(k):
        seg = x[k * ct: k * ct + w]
        return w * np.array([np.sum(seg[: w - lag] * seg[lag:]) / w for lag in range(w)])

    pref = (exp.units.energy / exp.units.length / exp.units.time) / (
        3 * (w - 1) * 300.0**2 * exp.units.boltzmann * 1000.0
    )
    sig0, sig1 = (pref * np.trapezoid(window_jacf(k), x=times) for k in (0, 1))
    scale = 1e-5 * np.abs(ref["integral"]).max()
    np.testing.assert_allclose(ours["thermal_conductivity"][0], sig0, rtol=1e-5, atol=scale)
    np.testing.assert_allclose(ours["uncertainty"][0], sig1, rtol=1e-5, atol=scale)
    averaged = exp.run.GreenKuboThermalConductivity(data_range=w, correlation_time=ct, plot=False)
    estimated = exp.run.GreenKuboThermalConductivity(data_range=w, correlation_time=ct,
                                                     reference_estimator=True, plot=False)
    assert averaged["System"]["thermal_conductivity"][0] != estimated["System"]["thermal_conductivity"][0]


def test_reference_estimator_only_on_the_gk_thermal_family(tmp_path):
    for calculator in ("GreenKuboViscosity", "GreenKuboViscosityFlux"):
        prop = "Momentum_Flux" if calculator == "GreenKuboViscosity" else "Stress_Visc"
        exp = _observables(PACKAGES[0], tmp_path / calculator, prop, n_frames=400)
        res = getattr(exp.run, calculator)(data_range=64, correlation_time=64, reference_estimator=True,
                                           plot=False)
        assert np.isfinite(res["System"]["viscosity"][0])
    exp = _observables(PACKAGES[0], tmp_path / "ion", "Ionic_Current", n_frames=300)
    with pytest.raises(ValueError, match="reference_estimator"):
        exp.run.GreenKuboIonicConductivity(data_range=64, reference_estimator=True, plot=False)
    with pytest.raises(ValueError, match="two windows"):
        _observables(PACKAGES[0], tmp_path / "one", "Momentum_Flux", n_frames=70).run.GreenKuboViscosity(
            data_range=64, correlation_time=64, reference_estimator=True, plot=False
        )


# ------------------------------------------------------ estimator, plumbing
@pytest.mark.parametrize("calculator, prop, acf_scale", [
    ("GreenKuboIonicConductivity", "Ionic_Current", 1.0),
    ("GreenKuboThermalConductivity", "Thermal_Flux", 40.0),
    ("EinsteinHelfandIonicConductivity", "Translational_Dipole_Moment", None),
])
def test_direct_estimators_match_the_calculators(tmp_path, calculator, prop, acf_scale):
    """``gk_system_direct`` and ``msd_system_direct``, which ``chip_smoke.py``
    holds the card's values to, against the JAX calculators' series on the
    same stored series (rtol 1e-10)."""
    exp = _observables(PACKAGES[1], tmp_path, prop, n_frames=300, seed=15)
    calc = getattr(exp.run, calculator)
    res = calc(data_range=40, correlation_time=3, plot=False)["System"]
    x = exp.store.load([f"Observables/{prop}"])[f"Observables/{prop}"]
    times = np.arange(40) * 0.1
    if acf_scale is None:
        np.testing.assert_allclose(res["msd"], calc._prefactor() * msd_system_direct(x, 40, 3), rtol=1e-10)
        popt, *_ = fit_einstein_curve(times, np.asarray(res["msd"]), fit_max_index=39)
        np.testing.assert_allclose(res["ionic_conductivity"], popt[0] / 6, rtol=1e-10)
        return
    acf, integral = gk_system_direct(x, 40, 3, times, acf_scale)
    np.testing.assert_allclose(res["acf"], acf, rtol=1e-10, atol=1e-10 * abs(acf[0]))
    np.testing.assert_allclose(res["integral"], integral, rtol=1e-10, atol=1e-10 * abs(acf[0]) * times[-1])
    value = calc._prefactor() * integral[res_ir(calc, integral)]
    np.testing.assert_allclose(np.ravel(next(v for k, v in res.items() if k.endswith("conductivity")))[0],
                               value, rtol=1e-10)


def test_direct_acf_of_a_long_series_matches_jax():
    """Above 4096 rows ``acf_sums_direct`` sums lag by lag (no Gram matrix),
    as ``chip_smoke.py`` uses it on a 10^6-row flux log: equal to the JAX
    package's windowed ACF in float64 (rtol 1e-10)."""
    import jax.numpy as jnp
    from lammps_analysis_tpu.ops import correlation as jax_correlation
    from torch_dumps import acf_sums_direct

    x = np.random.default_rng(16).normal(size=(5000, 1, 3))
    ref, _ = jax_correlation.windowed_acf_sum(jnp.asarray(x), 50, 3)
    ref = np.asarray(ref)
    np.testing.assert_allclose(acf_sums_direct(x, 50, 3), ref, rtol=1e-10, atol=1e-10 * abs(ref[0]))


def res_ir(calc, integral):
    """The integral's index a GK value reads: ``integration_range - 1``,
    at most the last."""
    return min(calc.args["integration_range"] - 1, len(integral) - 1)


def test_system_acf_batches_follow_the_experiment_budget(tmp_path, monkeypatch):
    """The system GK passes the experiment planner's budget to the ACF: a
    small budget splits a long series' windows into FFT batches of a few
    windows each, with the result of the 32-window batches within float64
    rounding (rtol 1e-9)."""
    windowed, rfft = correlation.windowed_acf_sum, torch.fft.rfft
    results, n_batches = [], []
    for name, budget in (("large", 2**30), ("small", 30_000)):
        exp = _observables(PACKAGES[0], tmp_path / name, "Thermal_Flux", n_frames=3000, budget=budget)
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
            results.append(exp.run.GreenKuboThermalConductivity(data_range=64, plot=False).data_dict["System"])
        assert budgets and set(budgets) == {budget}
        n_batches.append(len(batches))
    assert n_batches[1] > n_batches[0] > 0, n_batches
    for key, value in results[0].items():
        np.testing.assert_allclose(results[1][key], value, rtol=1e-9, atol=0, err_msg=key)


def test_system_cache_hit_and_missing_series(tmp_path, monkeypatch):
    exp = _ionic(PACKAGES[0], tmp_path, n_frames=300)
    first = exp.run.GreenKuboIonicConductivity(data_range=32, plot=False)
    def refuse(*args, **kwargs):
        raise AssertionError("a cache hit computes no ACF")

    monkeypatch.setattr(correlation, "windowed_acf_sum", refuse)
    again = exp.run.GreenKuboIonicConductivity(data_range=32, plot=False)
    assert again.data_dict == first.data_dict
    with pytest.raises(ValueError, match="no transformation produces it"):
        exp.run.GreenKuboViscosityFlux(data_range=32, plot=False)
    with pytest.raises(ValueError, match="exceeds"):
        exp.run.EinsteinHelfandIonicConductivity(data_range=500, plot=False)
