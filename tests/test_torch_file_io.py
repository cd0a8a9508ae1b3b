"""PyTorch port, the LAMMPS dump and flux readers and file ingestion, held
against the JAX package's readers on the same text and against MDSuite's own
reader (``golden_lammps_reader.json``).

Both readers parse through ``native/table_parser.cpp``; the port builds its
own copy of it under ``lammps_analysis_tpu_torch/_build/``. Parsed arrays
must be identical (both emit float32 from the same text). Each package gets
its own ``tmp_path`` directory.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from lammps_analysis_tpu.file_io import LAMMPSDumpFile as JaxDumpFile
from lammps_analysis_tpu.file_io import LAMMPSFluxFile as JaxFluxFile
from lammps_analysis_tpu_torch.file_io import LAMMPSDumpFile, LAMMPSFluxFile, native_parser
from lammps_analysis_tpu_torch.utils.config import config

from torch_dumps import random_walk, walk_columns, write_dump, write_flux_file
from torch_jax_parser import ensure_jax_native_parser

torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).parent / "goldens"
PORT_ROOT = pathlib.Path(native_parser.__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def jax_reads_natively():
    ensure_jax_native_parser()


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def _walk_dump(path, counts=(9, 7), n_frames=12, label="element", with_id=True,
               shuffle=True, ids=None):
    wrapped, _, vel, names = random_walk(counts, n_frames, 8.0, 0.4, 0.02, seed=5)
    cols = walk_columns(wrapped, vel, names, with_id=with_id, label=label)
    if ids is not None:
        cols["id"] = ids
    write_dump(path, 8.0, cols, every=10, shuffle_seed=6 if shuffle else None)
    return path


def _read_all(reader):
    meta = reader.metadata
    chunks = list(reader.get_configurations_generator())
    data = {}
    for sp in meta.species_list:
        for prop in sp.properties:
            data[f"{sp.name}/{prop.name}"] = np.concatenate(
                [np.asarray(c.get_data(sp.name, prop.name)) for c in chunks]
            )
    return meta, data


def _species(meta):
    return {
        sp.name: (sp.n_particles, sorted(p.name for p in sp.properties))
        for sp in meta.species_list
    }


@pytest.mark.parametrize(
    "case",
    ["element", "type", "sorted-no-id", "ids-not-1..N"],
)
def test_reader_matches_jax_reader(tmp_path, case):
    """Same dump text through both readers: equal metadata, identical arrays.
    ``ids-not-1..N`` (ids 101, 103, ...) takes the host id-sort route;
    ``sorted-no-id`` has no id column and is declared sorted."""
    kw = {}
    if case == "type":
        _walk_dump(tmp_path / "t.lammpstrj", label="type")
    elif case == "sorted-no-id":
        _walk_dump(tmp_path / "t.lammpstrj", with_id=False, shuffle=False)
        kw = dict(trajectory_is_sorted_by_ids=True)
    elif case == "ids-not-1..N":
        _walk_dump(tmp_path / "t.lammpstrj", ids=101 + 2 * np.arange(16))
    else:
        _walk_dump(tmp_path / "t.lammpstrj")
    meta, ours = _read_all(LAMMPSDumpFile(tmp_path / "t.lammpstrj", **kw))
    ref_meta, ref = _read_all(JaxDumpFile(tmp_path / "t.lammpstrj", **kw))
    assert meta.n_configurations == ref_meta.n_configurations == 12
    assert meta.box_l == ref_meta.box_l == [8.0] * 3
    assert meta.sample_rate == ref_meta.sample_rate == 10
    assert _species(meta) == _species(ref_meta)
    assert set(ours) == set(ref) and len(ours) == 4
    for key in ref:
        assert ours[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_reader_matches_mdsuite_golden(tmp_path):
    """MDSuite's reader on the same text (the golden): equal metadata, arrays
    within atol 2e-5 (float32 against the reference's float64 parse)."""
    g = json.loads((GOLDENS / "golden_lammps_reader.json").read_text())
    path = tmp_path / "t.lammpstraj"
    path.write_text(g["file_text"])
    meta, data = _read_all(LAMMPSDumpFile(path))
    assert meta.n_configurations == g["n_configurations"]
    np.testing.assert_allclose(meta.box_l, g["box_l"])
    assert meta.sample_rate == g["sample_rate"]
    assert _species(meta) == {
        name: (v["n_particles"], sorted(v["properties"]))
        for name, v in g["species"].items()
    }
    for key, ref_arr in g["data"].items():
        np.testing.assert_allclose(data[key], np.array(ref_arr), rtol=0, atol=2e-5, err_msg=key)


def test_missing_id_column_raises_unless_declared_sorted(tmp_path):
    _walk_dump(tmp_path / "t.lammpstrj", with_id=False, shuffle=False)
    with pytest.raises(ValueError, match="no 'id' column"):
        LAMMPSDumpFile(tmp_path / "t.lammpstrj").metadata
    assert LAMMPSDumpFile(
        tmp_path / "t.lammpstrj", trajectory_is_sorted_by_ids=True
    ).metadata.n_configurations == 12


@pytest.mark.parametrize("cut", ["mid-frame", "whole-frames"])
def test_truncated_file_raises(tmp_path, cut):
    """A file that is not a whole number of frames fails its line count; one
    cut after its metadata was read raises EOFError in the stream."""
    path = _walk_dump(tmp_path / "t.lammpstrj")
    lines = path.read_text().splitlines(keepends=True)
    lines_per_frame = 16 + 9
    reader = LAMMPSDumpFile(path)
    assert reader.metadata.n_configurations == 12
    keep = len(lines) - (5 if cut == "mid-frame" else 2 * lines_per_frame)
    path.write_text("".join(lines[:keep]))
    with pytest.raises(EOFError):
        list(reader.get_configurations_generator())
    if cut == "mid-frame":
        with pytest.raises(ValueError, match="not a whole number"):
            LAMMPSDumpFile(path).metadata


def test_parser_builds_in_the_port_and_not_in_native(tmp_path, monkeypatch):
    """The port's parser library carries a hash of source, flags and CPU and
    lives in the port's ``_build/``; a build compiles ``native/table_parser.cpp``
    where it is and writes only under the build directory."""
    lib = native_parser.library_path()
    assert lib.parent == PORT_ROOT / "_build" and lib.name.startswith("libtable_parser-")
    assert native_parser.SOURCE == PORT_ROOT.parent / "native" / "table_parser.cpp"

    commands = []
    run = native_parser.subprocess.run

    def recording_run(cmd, *args, **kwargs):
        commands.append(cmd)
        return run(cmd, *args, **kwargs)

    monkeypatch.setattr(native_parser, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_parser.subprocess, "run", recording_run)
    built = native_parser.build()
    assert built == native_parser.library_path() and built.parent == tmp_path / "_build"
    assert len(commands) == 1 and commands[0][0] == "g++"
    assert str(native_parser.SOURCE) in commands[0]
    out = pathlib.Path(commands[0][commands[0].index("-o") + 1])
    assert out.parent == tmp_path / "_build"
    assert native_parser.build() == built and len(commands) == 1  # built once
    assert not list(native_parser.SOURCE.parent.glob("libtable_parser*"))


def test_failed_parser_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output; no
    other engine takes over."""
    bad = tmp_path / "table_parser.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_parser, "SOURCE", bad)
    monkeypatch.setattr(native_parser, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="table-parser build failed"):
        native_parser.build()


def test_add_data_from_path(tmp_path):
    """``add_data(path)``: the store holds the parsed arrays; a second add of
    the same file is a no-op unless ``force``; an unported suffix raises."""
    import lammps_analysis_tpu_torch as lt

    path = _walk_dump(tmp_path / "t.lammpstrj")
    _, parsed = _read_all(LAMMPSDumpFile(path))
    exp = lt.Project(name="p", storage_path=tmp_path).add_experiment(
        "e", timestep=0.002, units="metal", simulation_data=str(path)
    )
    assert exp.number_of_configurations == 12
    assert exp.sample_rate == 10 and exp.box_array == [8.0] * 3
    assert {k: v.n_particles for k, v in exp.species.items()} == {"Na": 9, "Cl": 7}
    for key, arr in parsed.items():
        np.testing.assert_array_equal(exp.store.load([key])[key], arr)
    version = exp.version
    exp.add_data(path)
    assert exp.number_of_configurations == 12 and exp.version == version
    exp.add_data(path, force=True)
    assert exp.number_of_configurations == 24 and exp.version > version
    with pytest.raises(FileNotFoundError):  # the extxyz reader takes the suffix now
        exp.add_data(tmp_path / "t.xyz")
    with pytest.raises(ValueError, match="Cannot infer a reader"):
        exp.add_data(tmp_path / "t.unknown")


def _flux_file(path, n_steps=50, trailing_log=False):
    rng = np.random.default_rng(21)
    flux = rng.normal(scale=2.0, size=(n_steps, 3))
    stress = rng.normal(scale=300.0, size=(n_steps, 3))
    write_flux_file(path, {
        "time": 10 * np.arange(n_steps), "temp": 1200.0 + rng.normal(size=n_steps),
        "c_flux_thermal[1]": flux[:, 0], "c_flux_thermal[2]": flux[:, 1],
        "c_flux_thermal[3]": flux[:, 2], "pxy": stress[:, 0], "pxz": stress[:, 1],
        "pyz": stress[:, 2],
    })
    if trailing_log:
        with open(path, "a") as f:
            f.write("Loop time of 12.5 on 4 procs for 500 steps with 1000 atoms\n\n")
            f.write("Performance: 3.456 ns/day\n")
    return path


@pytest.mark.parametrize("case", ["block", "trailing-log", "custom-map"])
def test_flux_reader_matches_jax_reader(tmp_path, case):
    """Same flux text through both readers: one ``Observables`` particle,
    the first contiguous block only (log text after it is not read), equal
    metadata and identical arrays."""
    path = _flux_file(tmp_path / "flux.dat", trailing_log=case == "trailing-log")
    kw = dict(sample_rate=10, box_l=[20.0, 20.0, 21.0])
    if case == "custom-map":
        kw["custom_data_map"] = {"Shear_Pair": ["pxy", "pxz"]}
    meta, ours = _read_all(LAMMPSFluxFile(path, **kw))
    ref_meta, ref = _read_all(JaxFluxFile(path, **kw))
    assert meta.n_configurations == ref_meta.n_configurations == 50
    assert meta.box_l == ref_meta.box_l == [20.0, 20.0, 21.0]
    assert meta.sample_rate == ref_meta.sample_rate == 10
    assert _species(meta) == _species(ref_meta)
    expected = {"Temperature", "Time", "Thermal_Flux", "Stress_Visc"}
    if case == "custom-map":
        expected.add("Shear_Pair")
    assert _species(meta) == {"Observables": (1, sorted(expected))}
    assert set(ours) == set(ref)
    for key in ref:
        assert ours[key].dtype == ref[key].dtype and ours[key].shape == (50, 1, ref[key].shape[-1])
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_flux_file_ingests_into_observables(tmp_path):
    """``add_experiment(simulation_data=LAMMPSFluxFile(...))``: the series
    land under ``Observables`` with one particle, which counts as no atom."""
    import lammps_analysis_tpu_torch as lt

    path = _flux_file(tmp_path / "flux.dat", trailing_log=True)
    _, parsed = _read_all(LAMMPSFluxFile(path, sample_rate=10, box_l=[20.0] * 3))
    exp = lt.Project(name="p", storage_path=tmp_path).add_experiment(
        "e", timestep=0.001, temperature=1200.0, units="metal",
        simulation_data=LAMMPSFluxFile(path, sample_rate=10, box_l=[20.0] * 3),
    )
    assert exp.number_of_configurations == 50 and exp.number_of_atoms == 0
    assert exp.sample_rate == 10 and exp.volume == 8000.0
    assert exp.species["Observables"].n_particles == 1
    for key, arr in parsed.items():
        np.testing.assert_array_equal(exp.store.load([key])[key], arr)
    with pytest.raises(ValueError, match="LAMMPSFluxFile"):
        exp.add_data(tmp_path / "flux.unknown")
