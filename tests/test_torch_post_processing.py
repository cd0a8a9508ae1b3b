"""PyTorch port, the RDF post-processing (coordination numbers, potential of
mean force, Kirkwood-Buff integrals, structure factor) and Nernst-Einstein,
held against the JAX package on the same g(r) and diffusion Computations
(stored through each package's results DB: the schemas are equal), against
the numpy oracles of ``tests/reference_oracles.py`` and against the goldens
made by running MDSuite.

Tolerance: rtol 1e-10 where both packages read the same arrays (the code is
the same numpy). Each package gets its own ``tmp_path`` directory.
"""

import importlib
import json
import pathlib

import numpy as np
import pytest
import torch
from scipy.integrate import cumulative_trapezoid
from scipy.signal import find_peaks, savgol_filter

import reference_oracles as oracle
from lammps_analysis_tpu_torch.calculators.post_processing import StructureFactor
from lammps_analysis_tpu_torch.data.form_factors import form_factor
from lammps_analysis_tpu_torch.database.results_db import Computation
from lammps_analysis_tpu_torch.utils.config import config
from lammps_analysis_tpu_torch.utils.meta import golden_section_search
from lammps_analysis_tpu_torch.utils.units import boltzmann_constant, elementary_charge

torch.set_num_threads(1)

PACKAGES = ("lammps_analysis_tpu_torch", "lammps_analysis_tpu")
GOLDENS = pathlib.Path(__file__).parent / "goldens"
PAIRS = ("Na_Na", "Na_Cl", "Cl_Cl")


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def _experiment(package, root, counts=(24, 24), n_frames=6, box=12.0, units="metal",
                temperature=1400.0, seed=3, velocities=False, dt=0.002):
    """Na/Cl positions (and white-noise velocities) through ``ScriptInput``."""
    pkg = importlib.import_module(package)
    db = importlib.import_module(package + ".database")
    props = [db.PropertyInfo("Positions", 3)] + ([db.PropertyInfo("Velocities", 3)] if velocities else [])
    species = [db.SpeciesInfo(sp, n, props) for sp, n in zip(("Na", "Cl"), counts)]
    meta = db.TrajectoryMetadata(n_configurations=n_frames, species_list=species, box_l=[box] * 3,
                                 sample_rate=1, temperature=temperature)
    chunk = db.TrajectoryChunkData(species, n_frames)
    rng = np.random.default_rng(seed)
    for sp, n in zip(("Na", "Cl"), counts):
        chunk.add_data(rng.uniform(0, box, (n_frames, n, 3)).astype(np.float32).astype(np.float64),
                       0, sp, "Positions")
        if velocities:
            chunk.add_data(rng.normal(size=(n_frames, n, 3)).astype(np.float32).astype(np.float64),
                           0, sp, "Velocities")
    script = importlib.import_module(package + ".file_io").ScriptInput(chunk, meta, "d")
    exp = pkg.Project(name="p", storage_path=root / package).add_experiment(
        "e", timestep=dt, temperature=temperature, units=units, simulation_data=script
    )
    exp.set_charge("Na", 1.0)
    exp.set_charge("Cl", -1.0)
    return exp


def _liquid_rdf(n_bins=400, r_max_nm=0.6):
    """A clean liquid-like g(r) (nm radii, as the RDF writes them): excluded
    core, first shell at 0.25 nm, second at 0.45 nm."""
    r = np.linspace(0.0, r_max_nm, n_bins)
    data = {}
    for pair, (h1, h2) in zip(PAIRS, ((1.5, 0.4), (2.5, 0.6), (1.2, 0.3))):
        g = (1.0 + h1 * np.exp(-(((r - 0.25) / 0.03) ** 2)) + h2 * np.exp(-(((r - 0.45) / 0.05) ** 2))) / (
            1.0 + np.exp(-(r - 0.2) / 0.01)
        )
        data[pair] = {"x": r.tolist(), "y": g.tolist()}
    args = {"number_of_bins": n_bins, "cutoff": r_max_nm * 10, "number_of_configurations": 8}
    return args, data


def _stored(exp, name, args, data):
    """The Computation ``exp``'s results DB returns for ``data``."""
    return exp.db.store_computation(exp.name, name, args, exp.version, data)


def assert_results_equal(ours, ref, rtol=1e-10):
    assert set(ours) == set(ref)
    for subject in ref:
        assert set(ours[subject]) == set(ref[subject]), subject
        for key, value in ref[subject].items():
            np.testing.assert_allclose(ours[subject][key], value, rtol=rtol, atol=0,
                                       err_msg=f"{subject} {key}")


# ---------------------------------------------------------------- vs the JAX
CASES = [
    ("CoordinationNumbers", {}),
    ("CoordinationNumbers", {"number_of_shells": 2, "savgol_window_length": 21}),
    ("PotentialOfMeanForce", {}),
    ("PotentialOfMeanForce", {"number_of_shells": 2, "savgol_order": 3}),
    ("KirkwoodBuffIntegral", {}),
    ("StructureFactor", {"resolution": 300}),
]


@pytest.mark.parametrize("calculator, kw", CASES, ids=[f"{c}-{i}" for i, (c, _) in enumerate(CASES)])
def test_post_processing_matches_jax(tmp_path, calculator, kw):
    """The same g(r), stored in each package's results DB, through each
    package's calculator: equal subjects, keys and values (rtol 1e-10), the
    shells (``CN_k``, ``POMF_k``) included, and the same shells missing."""
    args, data = _liquid_rdf()
    results = []
    for package in PACKAGES:
        exp = _experiment(package, tmp_path)
        rdf = _stored(exp, "RadialDistributionFunction", args, data)
        results.append(getattr(exp.run, calculator)(rdf_data=rdf, plot=False, **kw).data_dict)
    assert_results_equal(*results)
    if calculator in ("CoordinationNumbers", "PotentialOfMeanForce"):
        # one shell needs two peaks, found on this g(r); two shells need three
        key = "CN_1" if calculator == "CoordinationNumbers" else "POMF_1"
        assert all((key in results[0][pair]) == (kw.get("number_of_shells", 1) == 1) for pair in PAIRS)


def test_post_processing_of_the_port_rdf_matches_jax(tmp_path):
    """The port's RDF (the plain version of the pair-histogram kernel on
    the CPU), stored in both results DBs, through all four calculators; and
    a call without ``rdf_data`` auto-runs the default RDF and keys the
    cache with its arguments."""
    port = _experiment(PACKAGES[0], tmp_path, counts=(60, 60), n_frames=4)
    rdf = port.run.RadialDistributionFunction(number_of_configurations=4, cutoff=5.9, number_of_bins=80,
                                              plot=False)
    jax_exp = _experiment(PACKAGES[1], tmp_path, counts=(60, 60), n_frames=4)
    jax_rdf = _stored(jax_exp, "RadialDistributionFunction", rdf.args, rdf.data_dict)
    for calculator in ("CoordinationNumbers", "PotentialOfMeanForce", "KirkwoodBuffIntegral", "StructureFactor"):
        ours = getattr(port.run, calculator)(rdf_data=rdf, plot=False)
        ref = getattr(jax_exp.run, calculator)(rdf_data=jax_rdf, plot=False)
        assert ours.args == ref.args
        assert_results_equal(ours.data_dict, ref.data_dict)
    auto = port.run.KirkwoodBuffIntegral(plot=False)
    default = port.run.RadialDistributionFunction(plot=False)
    assert auto.args["rdf_args"] == default.args


# ------------------------------------------------- the JAX package's own tests
def _synthetic_rdf(n_bins=200, cutoff_nm=0.5, peak_r=0.25, peak_w=0.02, peak_h=2.0, pair="X_X"):
    r = np.linspace(0, cutoff_nm, n_bins)
    g = np.where(r > 0.15, 1.0, 0.0) + peak_h * np.exp(-((r - peak_r) ** 2) / (2 * peak_w**2))
    return Computation("RadialDistributionFunction",
                       {"number_of_bins": n_bins, "cutoff": cutoff_nm * 10, "number_of_configurations": 100},
                       {pair: {"x": r.tolist(), "y": g.tolist()}}, "synthetic")


@pytest.fixture()
def single(tmp_path):
    """One species ``X`` of 100 atoms in a 20 A box at 300 K, real units."""
    import lammps_analysis_tpu_torch as lt
    from lammps_analysis_tpu_torch.database import (
        PropertyInfo, SpeciesInfo, TrajectoryChunkData, TrajectoryMetadata,
    )

    sp = [SpeciesInfo("X", 100, [PropertyInfo("Positions", 3)])]
    meta = TrajectoryMetadata(n_configurations=5, species_list=sp, box_l=[20.0] * 3, sample_rate=1,
                              temperature=300.0)
    chunk = TrajectoryChunkData(sp, 5)
    chunk.add_data(np.random.default_rng(42).uniform(0, 20, (5, 100, 3)), 0, "X", "Positions")
    return lt.Project(name="proj", storage_path=tmp_path).add_experiment(
        "e", timestep=0.1, temperature=300.0, units="real",
        simulation_data=lt.file_io.ScriptInput(chunk, meta, "d"),
    )


def test_coordination_numbers_integral(single):
    rdf = _synthetic_rdf()
    data = single.run.CoordinationNumbers(rdf_data=rdf, number_of_shells=1, plot=False)["X_X"]
    radii, g = np.asarray(rdf["X_X"]["x"])[1:], np.asarray(rdf["X_X"]["y"])[1:]
    rho = 100 / (single.volume * single.units.volume / 1e-27)
    direct = 4 * np.pi * rho * cumulative_trapezoid(radii[1:] ** 2 * g[1:], x=radii[1:])
    np.testing.assert_allclose(data["cn"], direct, rtol=1e-10)
    assert data["CN_1"] > 0


def test_potential_of_mean_force_formula(single):
    rdf = _synthetic_rdf()
    data = single.run.PotentialOfMeanForce(rdf_data=rdf, plot=False)["X_X"]
    g = np.asarray(rdf["X_X"]["y"])[1:]
    expected = -boltzmann_constant * 300.0 * np.log(g[g > 0]) * 6.242e8
    np.testing.assert_allclose(np.asarray(data["pomf"])[g > 0], expected, rtol=1e-8)
    assert "POMF_1" in data


def test_kirkwood_buff_integral_converges(single):
    kb = np.asarray(single.run.KirkwoodBuffIntegral(rdf_data=_synthetic_rdf(peak_h=0.0), plot=False)["X_X"]["kb_integral"])
    assert abs(kb[-1] - kb[-20]) < 1e-3


def test_structure_factor_of_an_ideal_gas_is_one(single):
    from lammps_analysis_tpu_torch.database import SpeciesInfo

    r = np.linspace(0, 0.5, 200)
    rdf = Computation("RadialDistributionFunction",
                      {"number_of_bins": 200, "cutoff": 5.0, "number_of_configurations": 100},
                      {"Na_Na": {"x": r.tolist(), "y": np.ones(200).tolist()}}, "synthetic")
    single.species = {"Na": SpeciesInfo("Na", 100, single.species["X"].properties, 22.99, 0.0)}
    res = single.run.StructureFactor(rdf_data=rdf, plot=False)
    np.testing.assert_allclose(res["System"]["S"], 1.0, atol=1e-10)
    np.testing.assert_allclose(res["Na_Na"]["S"], 1.0, atol=1e-10)


def test_structure_factor_rejects_unknown_method(single):
    with pytest.raises(ValueError, match="Faber-Ziman"):
        single.run.StructureFactor(rdf_data=_synthetic_rdf(), method="Ashcroft-Langreth", plot=False)


def test_post_processing_matches_the_oracles(tmp_path):
    """The reference's integral chains (``reference_oracles.py``): CN, POMF,
    KBI and S(q) series; CN_1 at the discrete RDF minimum between the first
    two peaks and POMF_1 at the g(r) maximum, as the JAX parity tests pin."""
    exp = _experiment(PACKAGES[0], tmp_path, counts=(24, 24))
    args, data = _liquid_rdf()
    rdf = _stored(exp, "RadialDistributionFunction", args, data)
    cn = exp.run.CoordinationNumbers(rdf_data=rdf, number_of_shells=1, plot=False)
    pomf = exp.run.PotentialOfMeanForce(rdf_data=rdf, number_of_shells=1, plot=False)
    kbi = exp.run.KirkwoodBuffIntegral(rdf_data=rdf, plot=False)
    sf = exp.run.StructureFactor(rdf_data=rdf, resolution=300, plot=False)
    volume_nm3 = exp.volume * exp.units.volume / 1e-27
    for pair in PAIRS:
        radii, g = np.asarray(data[pair]["x"])[1:], np.asarray(data[pair]["y"])[1:]
        ref = oracle.cn_integral_reference(radii, g, 24 / volume_nm3)
        np.testing.assert_allclose(cn[pair]["cn"], ref, rtol=1e-10)
        peaks = find_peaks(savgol_filter(g, 17, 2), height=1.0)[0]
        m = peaks[0] + int(np.argmin(g[peaks[0]:peaks[1]]))
        assert abs(cn[pair]["CN_1"] - ref[min(m, len(ref) - 1)]) <= 0.02 * abs(ref[m])
        pmf = oracle.pmf_reference(g, exp.temperature)
        finite = np.isfinite(pmf)
        np.testing.assert_allclose(np.asarray(pomf[pair]["pomf"])[finite], pmf[finite], rtol=1e-10)
        exact = pmf[int(np.argmax(g))]
        assert abs(pomf[pair]["POMF_1"] - exact) <= max(5e-3, 0.02 * abs(exact))
        np.testing.assert_allclose(kbi[pair]["kb_integral"], oracle.kbi_reference(radii, g), rtol=1e-9,
                                   atol=1e-12)
    q = np.linspace(0.5, 12.0, 300)
    ref = oracle.structure_factor_reference(
        np.asarray(data["Na_Na"]["x"])[1:] * 10.0, {p: np.asarray(data[p]["y"])[1:] for p in PAIRS}, q,
        rho_0=48 / (exp.volume * exp.units.volume / 1e-30), x_frac={"Na": 0.5, "Cl": 0.5},
        form_factors={n: form_factor(n, q) for n in ("Na", "Cl")},
    )
    for key in PAIRS + ("System",):
        np.testing.assert_allclose(sf[key]["S"], ref[key], rtol=1e-9, atol=1e-12, err_msg=key)


# --------------------------------------------------- pair keys (regressions)
def test_structure_factor_pair_split_handles_underscores():
    names = {"mol_1", "Na", "Cl"}
    assert StructureFactor._split_pair("mol_1_mol_1", names) == ("mol_1", "mol_1")
    assert StructureFactor._split_pair("Na_Cl", names) == ("Na", "Cl")
    assert StructureFactor._split_pair("mol_1_Na", names) == ("mol_1", "Na")
    with pytest.raises(ValueError, match="does not split"):
        StructureFactor._split_pair("K_K", names)


def test_coordination_numbers_molecule_pair_keys(single):
    """A molecule-COM pair key with underscores takes the molecule count as
    the density (the reference's first-entity convention)."""
    single.molecules = {"mol_1": {"n_particles": 50, "properties": []}}
    rdf = _synthetic_rdf(pair="mol_1_mol_1")
    cn = np.asarray(single.run.CoordinationNumbers(rdf_data=rdf, plot=False)["mol_1_mol_1"]["cn"])
    r, g = np.asarray(rdf["mol_1_mol_1"]["x"]), np.asarray(rdf["mol_1_mol_1"]["y"])
    volume_nm3 = single.volume * single.units.volume / 1e-27
    direct = 4 * np.pi * (50 / volume_nm3) * cumulative_trapezoid(r[2:] ** 2 * g[2:], x=r[2:])
    np.testing.assert_allclose(cn, direct, rtol=1e-10)


def test_nernst_einstein_distinct_terms_with_molecule_names(tmp_path):
    """With ``distinct_diffusion_data`` given, the corrected conductivity
    adds distinct terms whose pair keys carry underscore names, equal to the
    JAX package's (rtol 1e-12)."""
    results = []
    for package in PACKAGES:
        exp = _experiment(package, tmp_path, counts=(32, 32), units="si", temperature=300.0)
        exp.molecules = {"ion_pair": {"n_particles": 32, "charge": 1.0, "properties": []}}
        d_self = _stored(exp, "EinsteinDiffusionCoefficients", {"data_range": 4},
                         {"Na": {"diffusion_coefficient": 1e-9, "uncertainty": 1e-11},
                          "ion_pair": {"diffusion_coefficient": 2e-9, "uncertainty": 0.0}})
        d_dist = _stored(exp, "EinsteinDistinctDiffusionCoefficients", {"data_range": 4},
                         {"ion_pair_ion_pair": {"diffusion_coefficient": 5e-10},
                          "Na_Cl": {"diffusion_coefficient": -3e-10}})
        res = exp.run.NernstEinsteinIonicConductivity(diffusion_data=d_self, distinct_diffusion_data=d_dist,
                                                      plot=False)
        results.append(res.data_dict)
    assert_results_equal(*results, rtol=1e-12)
    out = results[0]["System"]
    base = 64 * elementary_charge**2 / (12.0**3 * 1.0 * boltzmann_constant * 300.0)
    np.testing.assert_allclose(out["nernst_einstein_ionic_conductivity"],
                               base * (0.5 * 1e-9 + 0.5 * 2e-9), rtol=1e-12)
    assert out["corrected_nernst_einstein_ionic_conductivity"] != out["nernst_einstein_ionic_conductivity"]


# ------------------------------------------------------------ Nernst-Einstein
def test_nernst_einstein_from_diffusion_matches_jax(tmp_path):
    """NE over one GK diffusion Computation in both results DBs (rtol
    1e-10), near the white-noise value (20 %, the JAX test's bound); the
    ``species`` restriction splits it into parts that add up."""
    n_frames, sigma_v, dt, box = 1500, 1.0, 0.05, 10.0
    exp = _experiment(PACKAGES[0], tmp_path, counts=(16, 16), n_frames=n_frames, box=box, units="si",
                      temperature=300.0, velocities=True, dt=dt)
    diff = exp.run.GreenKuboDiffusionCoefficients(data_range=64, correlation_time=64, plot=False)
    jax_exp = _experiment(PACKAGES[1], tmp_path, counts=(16, 16), n_frames=4, box=box, units="si",
                          temperature=300.0)
    jax_diff = _stored(jax_exp, diff.name, diff.args, diff.data_dict)
    sigma = {}
    for species in (None, ["Na"], ["Cl"]):
        kw = {} if species is None else {"species": species}
        ours = exp.run.NernstEinsteinIonicConductivity(diffusion_data=diff, plot=False, **kw)
        ref = jax_exp.run.NernstEinsteinIonicConductivity(diffusion_data=jax_diff, plot=False, **kw)
        assert ours.args == ref.args
        assert_results_equal(ours.data_dict, ref.data_dict)
        sigma[str(species)] = ours["System"]["nernst_einstein_ionic_conductivity"]
    expected = elementary_charge**2 * 32 * sigma_v**2 * dt / (2 * boltzmann_constant * 300.0 * box**3)
    assert abs(sigma["None"] / expected - 1) < 0.2
    assert 0 < sigma["['Na']"] < sigma["None"]
    np.testing.assert_allclose(sigma["['Na']"] + sigma["['Cl']"], sigma["None"], rtol=1e-10)


def test_nernst_einstein_auto_runs_einstein_and_refuses_corrected(tmp_path):
    """Without ``diffusion_data`` the data_range parameterises the auto-run
    Einstein diffusion and keys the cache; ``corrected=True`` without
    distinct data no longer refuses: it auto-runs
    ``EinsteinDistinctDiffusionCoefficients`` as the JAX package does, keys
    the cache with its args and gives a finite corrected conductivity."""
    import lammps_analysis_tpu_torch as lt
    from lammps_analysis_tpu_torch.database import (
        PropertyInfo, SpeciesInfo, TrajectoryChunkData, TrajectoryMetadata,
    )

    rng = np.random.default_rng(5)
    sp = [SpeciesInfo(n, 8, [PropertyInfo("Unwrapped_Positions", 3)]) for n in ("Na", "Cl")]
    meta = TrajectoryMetadata(n_configurations=200, species_list=sp, box_l=[10.0] * 3, sample_rate=1,
                              temperature=300.0)
    chunk = TrajectoryChunkData(sp, 200)
    for n in ("Na", "Cl"):
        chunk.add_data(np.cumsum(rng.normal(scale=0.05, size=(200, 8, 3)), axis=0), 0, n,
                       "Unwrapped_Positions")
    exp = lt.Project(name="p", storage_path=tmp_path).add_experiment(
        "e", timestep=0.05, temperature=300.0, units="si",
        simulation_data=lt.file_io.ScriptInput(chunk, meta, "d"),
    )
    exp.set_charge("Na", 1.0)
    exp.set_charge("Cl", -1.0)
    res_a = exp.run.NernstEinsteinIonicConductivity(data_range=48, plot=False)
    res_b = exp.run.NernstEinsteinIonicConductivity(data_range=96, plot=False)
    assert res_a.args["diffusion_args"]["data_range"] == 48
    assert res_b.args["diffusion_args"]["data_range"] == 96
    assert np.isfinite(res_a["System"]["nernst_einstein_ionic_conductivity"])
    corrected = exp.run.NernstEinsteinIonicConductivity(corrected=True, data_range=48, plot=False)
    assert corrected.args["distinct_source"] == "EinsteinDistinctDiffusionCoefficients"
    assert corrected.args["distinct_args"]["data_range"] == 48
    assert np.isfinite(corrected["System"]["corrected_nernst_einstein_ionic_conductivity"])


# -------------------------------------------------------------------- goldens
def _golden(name):
    return json.loads((GOLDENS / name).read_text())


def test_golden_section_search_matches_the_reference():
    gs = _golden("golden_units_meta.json")["golden_section"]
    lo, hi = golden_section_search([np.array(gs["x"]), np.array(gs["y"])], 3.0, 0.5)
    dx = gs["x"][1] - gs["x"][0]
    assert lo <= 1.3 + dx and hi >= 1.3 - dx
    assert abs(lo - gs["a"]) <= 5 * dx and abs(hi - gs["b"]) <= 5 * dx


def test_form_factors_are_proper_cromer_mann_not_the_reference_bug():
    """The port's Cromer-Mann equals the proper formula on the reference's
    own coefficients (rtol 1e-12); the reference's unsquared exponent with
    ``+c`` per term, reproduced from its CSV coefficients, equals its golden
    output and gives Cl a negative form factor."""
    g = _golden("golden_structure_factor.json")
    q = np.array(g["q"])
    for name in ("Na", "Cl"):
        np.testing.assert_allclose(form_factor(name, q), g["proper_cromer_mann"][name], rtol=1e-12)
        coef = g["csv_coefficients"][name]
        buggy = sum(coef[f"a{i}"] * np.exp(-coef[f"b{i}"] * (q / (4 * np.pi))) + coef["c"] for i in range(1, 5))
        np.testing.assert_allclose(buggy, g["reference_form_factors"][name], rtol=1e-12)
        assert not np.allclose(form_factor(name, q), buggy)
    assert np.array(g["reference_form_factors"]["Cl"]).max() < 0 < form_factor("Cl", q).min()
    with pytest.raises(KeyError, match="No Cromer-Mann coefficients"):
        form_factor("Xx", q)


def test_reference_partial_sf_and_weights_are_pinned():
    """The upstream partial S(q) is halved and has no density; its weights
    collapse to one astronomical scalar a pair (``structure_factor.py:260``,
    ``:278-287``); the port keeps the density and per-q weights."""
    g = _golden("golden_structure_factor.json")
    q = np.array(g["q"])
    for pair, vals in g["rdf"].items():
        r, rdf = np.array(vals["x"])[1:] * 10, np.array(vals["y"])[1:]
        qr = np.outer(q, r)
        integral = np.trapezoid(r**2 * np.sin(qr) / qr * (rdf - 1), x=r, axis=1)
        np.testing.assert_allclose((1 + 4 * np.pi * integral) * 0.5, g["reference_partial_sf"][pair], rtol=1e-9)
    f = {k: np.array(v) for k, v in g["reference_form_factors"].items()}
    x = g["molar_fractions"]
    for pair, golden in g["reference_weights"].items():
        a, b = pair.split("_")
        upstream = x[a] * x[b] * np.prod([f[a], f[b]]) / np.mean([f[a], f[b]]) ** 2
        assert np.ndim(golden) == 0
        np.testing.assert_allclose(upstream, golden, rtol=1e-9)
    assert max(abs(float(v)) for v in g["reference_weights"].values()) > 1e20


def test_structure_factor_full_chain_on_the_port_rdf(tmp_path):
    """The port's RDF -> StructureFactor: finite, and the partials tend to
    1 at large q (the density factor is there; upstream's halved version
    tends to 0.5)."""
    exp = _experiment(PACKAGES[0], tmp_path, counts=(16, 16), n_frames=4, units="metal")
    rdf = exp.run.RadialDistributionFunction(number_of_configurations=4, start=0, stop=3,
                                             number_of_bins=100, plot=False)
    res = exp.run.StructureFactor(rdf_data=rdf, resolution=64, plot=False)
    assert np.isfinite(res["System"]["S"]).all()
    for pair in PAIRS:
        assert abs(np.mean(res[pair]["S"][-10:]) - 1.0) < 0.35, pair
