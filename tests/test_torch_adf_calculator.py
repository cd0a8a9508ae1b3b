"""PyTorch port, the ADF slice as a whole: ScriptInput -> Project -> store ->
``exp.run.AngularDistributionFunction``, held against the JAX package and
the MDSuite golden.

Each package gets its own ``tmp_path`` directory: the results cache keys on
the calculator's class name, so a shared project would hand the port the
JAX result and test nothing. Both packages get the same planner budget: the
ADF normalises each frame batch by its own total, so the batch split is part
of the result. The JAX calculator runs its XLA route here
(``native_cpu_kernels`` off).

Tolerances, as for the plain kernels (``test_torch_adf_ops.py``): totals
within rtol 1e-5 and at most max(2, size // 64) bins outside rtol 1e-4.
"""

import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

from lammps_analysis_tpu.utils.config import config as jax_config
from lammps_analysis_tpu_torch.parallel import sharded_ops
from lammps_analysis_tpu_torch.utils import profiling
from lammps_analysis_tpu_torch.utils.config import config

torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).parent / "goldens"
KEYS = ("Na_Na_Na", "Na_Na_Cl", "Na_Cl_Cl", "Cl_Cl_Cl")
BYTES_PER_FRAME = 160 * 3 * 8  # the random case's positions, as the planner counts them


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(jax_config, "native_cpu_kernels", False)


def _random_case():
    rng = np.random.default_rng(5)
    n_na, n_cl, n_frames, box = 96, 64, 12, 9.0
    pos = rng.uniform(0, box, size=(n_frames, n_na + n_cl, 3))
    kw = {"number_of_configurations": 10, "cutoff": 3.3, "number_of_bins": 73, "start": 0}
    return pos, n_na, n_cl, box, kw


def _golden():
    return json.loads((GOLDENS / "golden_adf.json").read_text())


def _golden_case():
    g = _golden()
    pos = np.transpose(np.array(g["positions_atoms_time_dims"]), (1, 0, 2))
    n = g["n_frames"]
    kw = {
        "number_of_configurations": n, "cutoff": g["cutoff"], "start": 0, "stop": n - 1,
        "number_of_bins": g["n_bins"], "norm_power": g["norm_power"],
    }
    return pos, g["n_na"], g["n_cl"], g["box"], kw


def _experiment(package, root, pos, n_na, n_cl, box, budget=None):
    """A ``package`` Project under ``root`` with one experiment ``e``."""
    pkg = importlib.import_module(package)
    db = importlib.import_module(package + ".database")
    props = importlib.import_module(package + ".database.properties")
    file_io = importlib.import_module(package + ".file_io")
    planner = importlib.import_module(package + ".memory.planner")
    P = props.PropertyInfo("Positions", 3)
    species = [db.SpeciesInfo("Na", n_na, [P]), db.SpeciesInfo("Cl", n_cl, [P])]
    n_frames = pos.shape[0]
    meta = db.TrajectoryMetadata(
        n_configurations=n_frames, species_list=species, box_l=[box] * 3, sample_rate=1,
    )
    chunk = db.TrajectoryChunkData(species, n_frames)
    chunk.add_data(pos[:, :n_na], 0, "Na", "Positions")
    chunk.add_data(pos[:, n_na:], 0, "Cl", "Positions")
    project = pkg.Project(name="adf", storage_path=root)
    exp = project.add_experiment(
        "e", timestep=0.1, units="metal", simulation_data=file_io.ScriptInput(chunk, meta, "d"),
    )
    if budget is not None:
        exp.planner = planner.BatchPlanner(memory_budget_bytes=budget)
    return exp


def _assert_adf_close(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape and ref.sum() > 0
    np.testing.assert_allclose(ours.sum(), ref.sum(), rtol=1e-5)
    bad = ~np.isclose(ours, ref, rtol=1e-4, atol=1e-6)
    assert bad.sum() <= max(2, ref.size // 64), f"{bad.sum()} bins differ"


@pytest.mark.parametrize(
    "case, budget, n_batches",
    [
        (_random_case, 2**40, 1),
        # 10 * (4 frames * bytes)^2 fits: batches of 4: 4 + 4 + 2 frames
        (_random_case, 10 * (4 * BYTES_PER_FRAME) ** 2, 3),
        (_random_case, 10 * BYTES_PER_FRAME**2, 10),  # one frame per batch
        (_golden_case, 2**40, 1),
    ],
    ids=["random-1-batch", "random-3-batches", "random-10-batches", "golden"],
)
def test_port_adf_matches_jax_calculator(tmp_path, case, budget, n_batches):
    pos, n_na, n_cl, box, kw = case()
    kw = dict(kw, plot=False)
    port_exp = _experiment("lammps_analysis_tpu_torch", tmp_path / "torch", pos, n_na, n_cl, box, budget)
    jax_exp = _experiment("lammps_analysis_tpu", tmp_path / "jax", pos, n_na, n_cl, box, budget)

    before = profiling.counters.copy()
    ours = port_exp.run.AngularDistributionFunction(**kw)
    delta = profiling.counters - before
    assert delta["k3.plain"] > 0  # it computed
    assert (delta["adf.batches"], delta["adf.passes"]) == (n_batches, 1)
    ref = jax_exp.run.AngularDistributionFunction(**kw)

    assert set(ours.data_dict) == set(ref.data_dict) == set(KEYS)
    bin_width = 3.15 / kw["number_of_bins"]
    for key in KEYS:
        _assert_adf_close(ours[key]["adf"], ref[key]["adf"])
        np.testing.assert_allclose(ours[key]["angle"], ref[key]["angle"], rtol=1e-12)
        assert ours[key]["max_peak"] == ref[key]["max_peak"]
        # each batch is normalised to unit area
        np.testing.assert_allclose(np.sum(ours[key]["adf"]) * bin_width, n_batches, rtol=1e-5)


def test_port_adf_matches_mdsuite_golden(tmp_path):
    """At the JAX package's own tolerance against the reference pipeline
    (``test_reference_goldens.py::test_adf_full_calculator_vs_reference``)."""
    g = _golden()
    pos, n_na, n_cl, box, kw = _golden_case()
    exp = _experiment("lammps_analysis_tpu_torch", tmp_path, pos, n_na, n_cl, box)
    res = exp.run.AngularDistributionFunction(plot=False, **kw)
    for ref_key, ref_hist in g["histograms"].items():
        ref_hist = np.array(ref_hist)
        np.testing.assert_allclose(
            np.array(res[ref_key.replace("-", "_")]["adf"]), ref_hist,
            rtol=2e-4, atol=2e-4 * max(1.0, ref_hist.max()), err_msg=ref_key,
        )


def test_port_adf_cache_and_persistence(tmp_path):
    pos, n_na, n_cl, box, kw = _random_case()
    kw = dict(kw, plot=False)
    exp = _experiment("lammps_analysis_tpu_torch", tmp_path, pos, n_na, n_cl, box)
    first = exp.run.AngularDistributionFunction(**kw)
    calls = profiling.counters["k2.plain"]

    again = exp.run.AngularDistributionFunction(**kw)  # cache hit
    assert profiling.counters["k2.plain"] == calls
    assert again.data_dict == first.data_dict

    from lammps_analysis_tpu_torch import Project

    reopened = Project(name="adf", storage_path=tmp_path)
    by_exp = reopened.run.AngularDistributionFunction(**kw)  # project-bound: a dict
    assert profiling.counters["k2.plain"] == calls
    assert by_exp["e"].data_dict == first.data_dict

    forced = exp.run.AngularDistributionFunction(force=True, **kw)
    assert profiling.counters["k2.plain"] > calls
    assert forced.data_dict == first.data_dict

    other = exp.run.AngularDistributionFunction(**dict(kw, norm_power=2))  # new key
    assert other.data_dict != first.data_dict


def test_port_adf_saturation_retry_gives_the_same_result(tmp_path, monkeypatch):
    """K forced far below the largest neighbor count: the run saturates,
    escalates once and feeds every batch again, with the result of a run
    whose K fits."""
    pos, n_na, n_cl, box, kw = _random_case()
    kw = dict(kw, plot=False)
    budget = 10 * (4 * BYTES_PER_FRAME) ** 2  # three batches
    fits = _experiment("lammps_analysis_tpu_torch", tmp_path / "fits", pos, n_na, n_cl, box, budget)
    before = profiling.counters.copy()
    expected = fits.run.AngularDistributionFunction(**kw)
    delta = profiling.counters - before
    assert (delta["adf.batches"], delta["adf.passes"]) == (3, 1)

    class NarrowPlan(sharded_ops.AdfPlan):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.k_n = 4

    monkeypatch.setattr(sharded_ops, "AdfPlan", NarrowPlan)
    narrow = _experiment("lammps_analysis_tpu_torch", tmp_path / "narrow", pos, n_na, n_cl, box, budget)
    calculator = narrow.run.AngularDistributionFunction
    before = profiling.counters.copy()
    result = calculator(**kw)
    delta = profiling.counters - before
    assert (delta["adf.batches"], delta["adf.passes"]) == (6, 2) and calculator.last_k_n > 4
    for key in KEYS:
        np.testing.assert_allclose(result[key]["adf"], expected[key]["adf"], rtol=1e-6, atol=1e-9)
