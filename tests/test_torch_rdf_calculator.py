"""PyTorch port, the RDF slice as a whole: ScriptInput -> Project -> store ->
``exp.run.RadialDistributionFunction``, held against the JAX package.

Each package gets its own ``tmp_path`` directory: the results cache keys on
the calculator's class name, so a shared project would hand the port the
JAX result and test nothing.
"""

import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

from lammps_analysis_tpu_torch.ops import rdf as torch_rdf
from lammps_analysis_tpu_torch.utils import profiling
from lammps_analysis_tpu_torch.utils.config import config

torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).parent / "goldens"


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def _random_case():
    rng = np.random.default_rng(1234)
    n_na, n_cl, n_frames, box = 96, 64, 20, 9.0
    pos = rng.uniform(0, box, size=(n_frames, n_na + n_cl, 3))
    return pos, n_na, n_cl, box, {"cutoff": 4.4, "number_of_bins": 60}


def _golden_case():
    g = json.loads((GOLDENS / "golden_rdf.json").read_text())
    pos = np.transpose(np.array(g["positions_atoms_time_dims"]), (1, 0, 2))
    return pos, g["n_na"], g["n_cl"], g["box"], {
        "cutoff": g["cutoff"], "number_of_bins": g["n_bins"],
    }


def _project(package, root, pos, n_na, n_cl, box):
    """A ``package`` Project under ``root`` with one experiment ``e``."""
    pkg = importlib.import_module(package)
    db = importlib.import_module(package + ".database")
    props = importlib.import_module(package + ".database.properties")
    file_io = importlib.import_module(package + ".file_io")
    P = props.PropertyInfo("Positions", 3)
    species = [db.SpeciesInfo("Na", n_na, [P]), db.SpeciesInfo("Cl", n_cl, [P])]
    n_frames = pos.shape[0]
    meta = db.TrajectoryMetadata(
        n_configurations=n_frames, species_list=species, box_l=[box] * 3,
        sample_rate=1,
    )
    chunk = db.TrajectoryChunkData(species, n_frames)
    chunk.add_data(pos[:, :n_na], 0, "Na", "Positions")
    chunk.add_data(pos[:, n_na:], 0, "Cl", "Positions")
    project = pkg.Project(name="rdf", storage_path=root)
    project.add_experiment(
        "e", timestep=0.1, units="metal",
        simulation_data=file_io.ScriptInput(chunk, meta, "d"),
    )
    return project


def _counts(res, n_frames, n_per_species, box, cutoff, n_bins):
    """Raw counts recovered from g(r). Bin 0 has no count to recover: its
    ideal-gas shell at r = 0 vanishes, so both packages give it prefactor 0."""
    edges = np.linspace(0.0, cutoff, n_bins)
    order = [(0, 0), (0, 1), (1, 1)]
    pref = torch_rdf.rdf_prefactors(order, n_per_species, box**3, n_frames, edges, box)
    out = {}
    for p, key in enumerate(["Na_Na", "Na_Cl", "Cl_Cl"]):
        c = np.asarray(res[key]["y"])[1:] / pref[p][1:]
        np.testing.assert_allclose(c, np.rint(c), atol=1e-6)
        out[key] = np.rint(c).astype(np.int64)
    return out


@pytest.mark.parametrize("case", [_random_case, _golden_case], ids=["random", "golden"])
def test_port_rdf_matches_jax_calculator(tmp_path, case):
    """Equal counts bin for bin at these seeds, then x and y at rtol 1e-6.
    The JAX calculator runs the XLA histogram here (CPU mesh), whose bin
    formula differs from the kernel's only within about one float32 ulp of
    a bin edge; no pair of these inputs lies there."""
    pos, n_na, n_cl, box, kw = case()
    n_frames = pos.shape[0]
    kw = dict(kw, number_of_configurations=n_frames, plot=False)
    jax_exp = _project("lammps_analysis_tpu", tmp_path / "jax", pos, n_na, n_cl, box).experiments["e"]
    port_exp = _project("lammps_analysis_tpu_torch", tmp_path / "torch", pos, n_na, n_cl, box).experiments["e"]

    calls = profiling.counters["k1.plain"]
    ours = port_exp.run.RadialDistributionFunction(**kw)
    assert profiling.counters["k1.plain"] > calls  # it computed
    ref = jax_exp.run.RadialDistributionFunction(**kw)

    assert set(ours.data_dict) == set(ref.data_dict) == {"Na_Na", "Na_Cl", "Cl_Cl"}
    geometry = (n_frames, [n_na, n_cl], box, kw["cutoff"], kw["number_of_bins"])
    c_ours, c_ref = _counts(ours, *geometry), _counts(ref, *geometry)
    for key in c_ref:
        assert c_ours[key].sum() > 0
        np.testing.assert_array_equal(c_ours[key], c_ref[key], err_msg=key)
        for series in ("x", "y"):
            np.testing.assert_allclose(
                ours[key][series], ref[key][series], rtol=1e-6, err_msg=key
            )


def test_port_rdf_cache_and_persistence(tmp_path):
    pos, n_na, n_cl, box, kw = _random_case()
    kw = dict(kw, number_of_configurations=8, plot=False)
    project = _project("lammps_analysis_tpu_torch", tmp_path, pos, n_na, n_cl, box)
    exp = project.experiments["e"]
    first = exp.run.RadialDistributionFunction(**kw)
    calls = profiling.counters["k1.plain"]

    again = exp.run.RadialDistributionFunction(**kw)  # cache hit
    assert profiling.counters["k1.plain"] == calls
    assert again.data_dict == first.data_dict

    from lammps_analysis_tpu_torch import Project

    reopened = Project(name="rdf", storage_path=tmp_path)
    by_exp = reopened.run.RadialDistributionFunction(**kw)  # project-bound: a dict
    assert profiling.counters["k1.plain"] == calls
    assert by_exp["e"].data_dict == first.data_dict

    forced = exp.run.RadialDistributionFunction(force=True, **kw)
    assert profiling.counters["k1.plain"] > calls
    assert forced.data_dict == first.data_dict


def test_port_refuses_missing_gpu_and_files(tmp_path):
    pos, n_na, n_cl, box, kw = _random_case()
    exp = _project("lammps_analysis_tpu_torch", tmp_path, pos, n_na, n_cl, box).experiments["e"]
    with pytest.raises(FileNotFoundError):  # the extxyz reader takes the suffix now
        exp.add_data(tmp_path / "traj.xyz")
    with pytest.raises(AttributeError, match="No calculator or transformation named"):
        exp.run.SpatialDistributionFunctions  # every JAX name resolves; a misspelt one does not
    if torch.cuda.is_available():
        return  # the default device is there: nothing to refuse
    config.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp.run.RadialDistributionFunction(plot=False, **kw)
