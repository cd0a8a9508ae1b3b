"""The port's host modules held against the JAX package: time series, plots,
the trajectory visualizer, the environment report and the profiling hooks.

Each package gets its own ``tmp_path`` project (the results cache keys on
the calculator's class name, so a shared project would hand one package the
other's result). Inputs are numpy-seeded and float32-representable (the
port's store is float32).

Tolerances: the time series within 1e-6 relative (the port sums each frame
in float64 on the device, the JAX package its stored array with numpy); the
HTML plot of one Computation byte for byte (the port's
``visualizer/html_plots.py`` is a copy).
"""

import importlib
import json
import re

import numpy as np
import pytest
import torch

import lammps_analysis_tpu_torch as lt
from lammps_analysis_tpu_torch.calculators import base as port_base
from lammps_analysis_tpu_torch.utils import profiling
from lammps_analysis_tpu_torch.utils.config import config
from lammps_analysis_tpu_torch.visualizer import html_plots, have_matplotlib

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def _experiment(package, root, n_frames=12, seed=7):
    """Experiment ``e`` of a ``package`` Project under ``root``: Na (30) and
    Cl (20) with positions and per-atom potential energies."""
    pkg = importlib.import_module(package)
    db = importlib.import_module(package + ".database")
    props = importlib.import_module(package + ".database.properties")
    file_io = importlib.import_module(package + ".file_io")
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 8.0, (n_frames, 50, 3)).astype(np.float32).astype(np.float64)
    pe = rng.normal(-3.0, 0.5, (n_frames, 50, 1)).astype(np.float32).astype(np.float64)
    P = props.PropertyInfo("Positions", 3)
    E = props.PropertyInfo("Potential_Energy", 1)
    species = [db.SpeciesInfo("Na", 30, [P, E]), db.SpeciesInfo("Cl", 20, [P, E])]
    meta = db.TrajectoryMetadata(n_configurations=n_frames, species_list=species,
                                 box_l=[8.0] * 3, sample_rate=2)
    chunk = db.TrajectoryChunkData(species, n_frames)
    for name, sl in (("Na", slice(0, 30)), ("Cl", slice(30, 50))):
        chunk.add_data(pos[:, sl], 0, name, "Positions")
        chunk.add_data(pe[:, sl], 0, name, "Potential_Energy")
    project = pkg.Project(name="orch", storage_path=root)
    return project.add_experiment("e", timestep=0.002, units="metal",
                                  simulation_data=file_io.ScriptInput(chunk, meta, "d"))


def test_time_series_matches_jax(tmp_path):
    """``exp.time_series.Energies(window=3)``: the same times and rolling
    per-frame totals as the JAX package, within 1e-6 relative."""
    ours = _experiment("lammps_analysis_tpu_torch", tmp_path / "port")
    theirs = _experiment("lammps_analysis_tpu", tmp_path / "jax")
    mine = ours.time_series.Energies(window=3, save_plot=False)
    ref = theirs.time_series.Energies(window=3, save_plot=False)
    np.testing.assert_allclose(mine["time"], ref["time"], rtol=1e-12)
    assert set(mine["series"]) == set(ref["series"]) == {"Na", "Cl"}
    for sp, series in ref["series"].items():
        assert mine["series"][sp].shape == (10,) and mine["series"][sp].dtype == np.float64
        np.testing.assert_allclose(mine["series"][sp], series, rtol=1e-6)
    with pytest.raises(AttributeError, match="No time series named"):
        ours.time_series.Pressure
    assert sorted(dir(ours.time_series)) == ["Energies", "KineticEnergies", "Temperature"]


def test_time_series_plot_writes_html(tmp_path, monkeypatch):
    """``save_plot=True`` writes the HTML, and the PNG where matplotlib
    imports; without matplotlib the HTML alone."""
    exp = _experiment("lammps_analysis_tpu_torch", tmp_path)
    exp.time_series.Energies(window=2)
    figures = exp.path / "figures"
    assert (figures / "timeseries_Potential_Energy.html").exists()
    assert (figures / "timeseries_Potential_Energy.png").exists() == have_matplotlib()
    (figures / "timeseries_Potential_Energy.html").unlink()
    (figures / "timeseries_Potential_Energy.png").unlink(missing_ok=True)
    from lammps_analysis_tpu_torch.time_series import base as ts_base

    monkeypatch.setattr(ts_base, "have_matplotlib", lambda: False)
    exp.time_series.Energies(window=2)
    assert (figures / "timeseries_Potential_Energy.html").exists()
    assert not (figures / "timeseries_Potential_Energy.png").exists()


def _series_of(html):
    """The panels' embedded (x, y, labels) of a written HTML plot."""
    import html as html_module

    blobs = re.findall(r"data-series='([^']*)'", html)
    return [json.loads(html_module.unescape(b)) for b in blobs]


def test_html_plot_data_equals_jax(tmp_path):
    """One Computation (the same stored g(r) in each package's results DB)
    plotted by both packages: the same file, panel data included."""
    from lammps_analysis_tpu.visualizer import html_plots as jax_html_plots

    rng = np.random.default_rng(3)
    x = np.linspace(0.0, 0.44, 60)
    data = {pair: {"x": x.tolist(), "y": rng.uniform(0, 2, 60).tolist()}
            for pair in ("Na_Na", "Na_Cl", "Cl_Cl")}
    data["Na_Na"]["y"][5] = float("nan")  # a non-finite point is left out of the panel
    comps = {}
    for package, write in (("lammps_analysis_tpu_torch", html_plots.write_html_plot),
                           ("lammps_analysis_tpu", jax_html_plots.write_html_plot)):
        exp = _experiment(package, tmp_path / package)
        comp = exp.db.store_computation(exp.name, "RadialDistributionFunction",
                                        {"cutoff": 4.4}, exp.version, data)
        comps[package] = write(comp, ["x", "y"], tmp_path / package / "out", title="rdf")
    ours, ref = (comps[p].read_text() for p in comps)
    assert ours == ref
    panels = _series_of(ours)
    assert [len(p["x"]) for p in panels] == [59, 60, 60]
    np.testing.assert_array_equal(panels[1]["y"], np.asarray(data["Na_Cl"]["y"]))


def test_plot_true_writes_html_and_png(tmp_path, monkeypatch):
    """``plot=True`` on a calculator writes ``figures/<name>.html`` and, where
    matplotlib imports, the PNG; without matplotlib the HTML alone; a
    failing plot is logged and the result is returned."""
    exp = _experiment("lammps_analysis_tpu_torch", tmp_path)
    figures = exp.path / "figures"
    res = exp.run.RadialDistributionFunction(number_of_configurations=4, cutoff=3.9,
                                             number_of_bins=40, plot=True)
    assert (figures / "RadialDistributionFunction.html").exists()
    assert (figures / "RadialDistributionFunction.png").exists() == have_matplotlib()
    panels = _series_of((figures / "RadialDistributionFunction.html").read_text())
    np.testing.assert_allclose(panels[0]["y"], np.asarray(res["Na_Na"]["y"], float))

    monkeypatch.setattr(port_base, "have_matplotlib", lambda: False)
    adf = exp.run.AngularDistributionFunction(number_of_configurations=2, cutoff=3.0,
                                              number_of_bins=50, plot=True)
    assert (figures / "AngularDistributionFunction.html").exists()
    assert not (figures / "AngularDistributionFunction.png").exists()

    def broken(*args, **kwargs):
        raise RuntimeError("no disk")

    monkeypatch.setattr(port_base, "write_html_plot", broken)
    again = exp.run.AngularDistributionFunction(number_of_configurations=2, cutoff=3.0,
                                                number_of_bins=50, plot=True)
    assert again.data_dict == adf.data_dict  # a cache hit, plotting failed quietly


def test_sdf_and_nernst_einstein_plots(tmp_path):
    """The SDF writes its 3-D HTML (and PNG where matplotlib imports); the
    Nernst-Einstein result, a scalar, plots nothing and warns nothing."""
    exp = _experiment("lammps_analysis_tpu_torch", tmp_path)
    figures = exp.path / "figures"
    exp.run.SpatialDistributionFunction(species=["Na", "Cl"], r_min=1.0, r_max=3.0,
                                        number_of_bins=20, plot=True)
    html = (figures / "SpatialDistributionFunction3D.html").read_text()
    assert "VIZ_DATA" in html and '"values"' in html
    assert (figures / "SpatialDistributionFunction.png").exists() == have_matplotlib()
    from lammps_analysis_tpu_torch.calculators.post_processing import (
        NernstEinsteinIonicConductivity,
    )

    assert NernstEinsteinIonicConductivity(experiment=exp).plot_results(None) is None


def test_run_visualization_writes_trajectory_html(tmp_path):
    exp = _experiment("lammps_analysis_tpu_torch", tmp_path)
    path = exp.run_visualization()
    assert path == exp.path / "figures" / "trajectory.html"
    text = path.read_text()
    data = json.loads(re.search(r"window.VIZ_DATA = (\{.*?\});", text).group(1))
    assert len(data["frames"]) == 12 and [len(g) for g in data["frames"][0]] == [30, 20]
    stored = exp.store.load(["Na/Positions"], frames=np.array([3]))["Na/Positions"][0]
    np.testing.assert_allclose(data["frames"][3][0], stored.round(4), atol=1e-6)
    assert (exp.path / "figures" / "trajectory.png").exists() == have_matplotlib()


def test_report_lists_torch_and_no_jax():
    info = lt.Report().info
    assert "jax" not in info and "jaxlib" not in info
    assert info["torch"] == torch.__version__
    assert info["devices"] == [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    for key in ("python", "platform", "numpy", "scipy", "cuda"):
        assert key in info
    assert "environment report" in repr(lt.Report(additional={"run": "x"}))


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    """``device_trace`` exports a Chrome trace holding the ``annotate`` spans,
    which it switches on; ``None`` is a no-op; counters count either way."""
    before = profiling.counters.copy()
    with profiling.device_trace(tmp_path / "trace"):
        with profiling.annotate("rdf call"):
            profiling.count("test.trace", 2)
            torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = (tmp_path / "trace").glob("trace-*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "rdf call" in names
    with profiling.device_trace(None), profiling.annotate("untraced"):  # a no-op
        profiling.count("test.trace")
    assert len(list(tmp_path.rglob("*.json"))) == 1
    assert profiling.counters - before == {"test.trace": 3}
    assert profiling.current() is None
