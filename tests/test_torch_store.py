"""PyTorch port: the npy trajectory store against the JAX package's HDF5
store on the same chunks, and ``store_from_hdf5`` carrying a JAX
experiment's ``database.h5`` across."""

import contextlib
import sqlite3

import numpy as np
import pytest
import torch

from lammps_analysis_tpu.database import (
    SpeciesInfo as JSpeciesInfo,
    TrajectoryChunkData as JChunk,
    TrajectoryMetadata as JMeta,
)
from lammps_analysis_tpu.database.properties import PropertyInfo as JProp
from lammps_analysis_tpu.database.trajectory_store import TrajectoryStore as H5Store
from lammps_analysis_tpu_torch.database import (
    SpeciesInfo,
    TrajectoryChunkData,
    TrajectoryMetadata,
    TrajectoryStore,
)
from lammps_analysis_tpu_torch.database.convert import store_from_hdf5
from lammps_analysis_tpu_torch.database.properties import PropertyInfo
from lammps_analysis_tpu_torch.ops import rdf as torch_rdf
from lammps_analysis_tpu_torch.utils.config import config

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def _chunks(rng, sizes, n_a=7, n_b=5):
    return [
        {"A": rng.normal(size=(n, n_a, 3)), "B": rng.normal(size=(n, n_b, 3))}
        for n in sizes
    ]


def _fill(store, species_cls, meta_cls, chunk_cls, prop_cls, chunks):
    prop = prop_cls("Positions", 3)
    species = [species_cls("A", 7, [prop]), species_cls("B", 5, [prop])]
    store.initialize(meta_cls(n_configurations=chunks[0]["A"].shape[0], species_list=species))
    for data in chunks:
        n = data["A"].shape[0]
        chunk = chunk_cls(species, n)
        for name, arr in data.items():
            chunk.add_data(arr, 0, name, "Positions")
        store.add_chunk(chunk)


def test_npy_store_matches_hdf5_store(tmp_path):
    rng = np.random.default_rng(5)
    chunks = _chunks(rng, [6, 4, 3])  # appends grow past the initial size
    ours = TrajectoryStore(tmp_path / "npy")
    ref = H5Store(tmp_path / "ref.h5", dtype="float32")
    _fill(ours, SpeciesInfo, TrajectoryMetadata, TrajectoryChunkData, PropertyInfo, chunks)
    _fill(ref, JSpeciesInfo, JMeta, JChunk, JProp, chunks)

    assert ours.species_names() == sorted(ref.species_names()) == ["A", "B"]
    assert ours.properties_of("A") == ref.properties_of("A") == ["Positions"]
    for path in ("A/Positions", "B/Positions"):
        assert ours.check_existence(path) and ref.check_existence(path)
        assert ours.get_cursor(path) == ref.get_cursor(path) == 13
        assert ours.get_data_size(path) == ref.get_data_size(path)
    assert not ours.check_existence("A/Velocities")

    frames = np.array([0, 5, 6, 12])
    for kw in (
        {},
        {"frames": slice(2, 9)},
        {"frames": frames},
        {"frames": frames, "atoms": np.array([1, 4])},
        {"atoms": slice(0, 3)},
        {"frames": frames, "dtype": np.float64},
    ):
        a = ours.load(["A/Positions", "B/Positions"], **kw)
        b = ref.load(["A/Positions", "B/Positions"], **kw)
        for path in a:
            assert a[path].dtype == b[path].dtype
            np.testing.assert_array_equal(a[path], b[path], err_msg=str(kw))
    # float32 by default: the stored values are the inputs rounded once
    whole = np.concatenate([c["A"] for c in chunks])
    np.testing.assert_array_equal(
        ours.load(["A/Positions"])["A/Positions"], whole.astype(np.float32)
    )

    ours.set_cursor("A/Positions", 4)
    assert TrajectoryStore(tmp_path / "npy").get_cursor("A/Positions") == 4


def test_store_from_hdf5_and_rdf_on_it(tmp_path):
    """A JAX experiment's store converted to npy reads back identically, and
    the port's RDF on it equals the JAX RDF on the original."""
    import lammps_analysis_tpu as latpu
    from lammps_analysis_tpu.file_io import ScriptInput

    import lammps_analysis_tpu_torch as lt

    rng = np.random.default_rng(11)
    n_a, n_b, n_frames, box = 40, 24, 6, 6.0
    pos = rng.uniform(0, box, size=(n_frames, n_a + n_b, 3))
    prop = JProp("Positions", 3)
    species = [JSpeciesInfo("Na", n_a, [prop]), JSpeciesInfo("Cl", n_b, [prop])]
    meta = JMeta(n_configurations=n_frames, species_list=species, box_l=[box] * 3, sample_rate=1)
    chunk = JChunk(species, n_frames)
    chunk.add_data(pos[:, :n_a], 0, "Na", "Positions")
    chunk.add_data(pos[:, n_a:], 0, "Cl", "Positions")
    jax_project = latpu.Project(name="p", storage_path=tmp_path / "jax")
    jax_exp = jax_project.add_experiment(
        "e", timestep=0.1, units="metal", simulation_data=ScriptInput(chunk, meta, "d")
    )

    # carry the project across: same results DB, trajectory converted. The DB
    # runs in WAL mode, so it is copied through sqlite's backup API, which
    # includes the pages still in the write-ahead log.
    port_root = tmp_path / "torch" / "p"
    (port_root / "e").mkdir(parents=True)
    with contextlib.closing(sqlite3.connect(jax_project.path / "project.db")) as src, \
            contextlib.closing(sqlite3.connect(port_root / "project.db")) as dst:
        src.backup(dst)
    converted = store_from_hdf5(jax_exp.store.path, port_root / "e" / "database")
    for path in ("Na/Positions", "Cl/Positions"):
        np.testing.assert_array_equal(
            converted.load([path])[path], jax_exp.store.load([path])[path]
        )
        assert converted.get_cursor(path) == jax_exp.store.get_cursor(path)

    port_exp = lt.Project(name="p", storage_path=tmp_path / "torch").experiments["e"]
    kw = dict(cutoff=2.9, number_of_bins=40, number_of_configurations=n_frames, plot=False)
    calls = torch_rdf.rdf_histogram_reference.calls
    ours = port_exp.run.RadialDistributionFunction(**kw)
    assert torch_rdf.rdf_histogram_reference.calls > calls
    ref = jax_exp.run.RadialDistributionFunction(**kw)
    for key in ("Na_Na", "Na_Cl", "Cl_Cl"):
        assert np.sum(ref[key]["y"]) > 0
        for series in ("x", "y"):
            np.testing.assert_allclose(ours[key][series], ref[key][series], rtol=1e-6)
