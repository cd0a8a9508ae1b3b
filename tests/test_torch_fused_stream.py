"""PyTorch port, the fused unwrap stream (``config.fuse_streaming``) and the
two-species stream of the distinct diffusion pair.

With ``config.fuse_streaming`` the Einstein calculator unwraps the wrapped
positions slab by slab instead of running ``CoordinateUnwrapper`` into the
store. Its result must equal the materialised run's bit for bit (the same
floats, compared with ``==``): one slab, many overlapping slabs, disjoint
slabs (``correlation_time > data_range``: the gap frames enter the unwrap
carry without being yielded) and atom minibatches. No
``Unwrapped_Positions`` dataset may be written. Against the JAX package's
fused run the result is held to the transport tolerance
(``tests/torch_dumps.py``): the port unwraps in float32, the JAX package in
float64 under x64 from the same float32-representable positions.
"""

import importlib

import numpy as np
import pytest
import torch

from lammps_analysis_tpu import config as jax_config
from lammps_analysis_tpu_torch.calculators import EinsteinDiffusionCoefficients
from lammps_analysis_tpu_torch.calculators.distinct_diffusion_coefficients import (
    EinsteinDistinctDiffusionCoefficients,
)
from lammps_analysis_tpu_torch.memory.planner import BatchPlanner
from lammps_analysis_tpu_torch.transformations import CoordinateUnwrapper
from lammps_analysis_tpu_torch.utils.config import config

from torch_dumps import assert_einstein_close

torch.set_num_threads(1)

BOX = 2.0
PORT = "lammps_analysis_tpu_torch"


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def _wrapped_walk(n_frames, n_atoms, sigma, seed):
    """Float32-representable wrapped positions of a random walk in a 2 A box
    (steps of ``sigma`` A a frame per axis: many face crossings)."""
    rng = np.random.default_rng(seed)
    unwrapped = np.cumsum(rng.normal(scale=sigma, size=(n_frames, n_atoms, 3)), axis=0) + BOX / 2
    wrapped = unwrapped - BOX * np.floor(unwrapped / BOX)
    return wrapped.astype(np.float32).astype(np.float64)


def _experiment(package, root, wrapped, prop="Positions", budget=None):
    pkg = importlib.import_module(package)
    db = importlib.import_module(package + ".database")
    file_io = importlib.import_module(package + ".file_io")
    props = importlib.import_module(package + ".database.properties")
    n_frames, n_atoms, _ = wrapped.shape
    species = [db.SpeciesInfo("X", n_atoms, [props.PropertyInfo(prop, 3)])]
    meta = db.TrajectoryMetadata(
        n_configurations=n_frames, species_list=species, box_l=[BOX] * 3, sample_rate=1
    )
    chunk = db.TrajectoryChunkData(species, n_frames)
    chunk.add_data(wrapped, 0, "X", prop)
    exp = pkg.Project(name="p", storage_path=root).add_experiment(
        "w", timestep=0.1, units="si", simulation_data=file_io.ScriptInput(chunk, meta, "d")
    )
    if budget is not None:
        planner = importlib.import_module(package + ".memory.planner")
        exp.planner = planner.BatchPlanner(memory_budget_bytes=budget)
    return exp


def _slab_plan(exp, kw):
    probe = EinsteinDiffusionCoefficients(exp)
    probe.args = probe.prepare_args(**kw)
    return probe._window_stream_plan(
        "X/Positions", kw["data_range"], kw["correlation_time"],
        max_slab_bytes=probe.MAX_SLAB_BYTES, n_selected=exp.species["X"].n_particles,
    )


# (frames, atoms, data_range, correlation_time, planner budget, what the plan must show)
CASES = {
    "one slab": (300, 20, 60, 10, None, "one"),
    # 12 atoms x 3 x 8 B x scale 10 = 2880 B a frame: 80 frames a slab
    "many slabs": (600, 12, 64, 16, 2880 * 80, "many"),
    "ct > range, disjoint slabs": (600, 8, 24, 100, 1920 * 30, "gaps"),
    "atom minibatches": (300, 8, 64, 8, 3000, "groups"),
}


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_fused_equals_materialised_bit_for_bit(tmp_path, monkeypatch, case):
    n_frames, n_atoms, data_range, ct, budget, shape = CASES[case]
    wrapped = _wrapped_walk(n_frames, n_atoms, 0.3, seed=n_frames + n_atoms)
    kw = dict(data_range=data_range, correlation_time=ct, plot=False)

    mat = _experiment(PORT, tmp_path / "mat", wrapped, budget=budget)
    res_mat = mat.run.EinsteinDiffusionCoefficients(**kw)
    assert mat.store.check_existence("X/Unwrapped_Positions")

    fused = _experiment(PORT, tmp_path / "fused", wrapped, budget=budget)
    slabs, n_groups = _slab_plan(fused, kw)
    assert {
        "one": len(slabs) == 1 and n_groups == 1,
        "many": len(slabs) > 3 and n_groups == 1,
        "gaps": len(slabs) > 2 and any(b[0] > a[1] for a, b in zip(slabs, slabs[1:])),
        "groups": n_groups > 1,
    }[shape], (slabs, n_groups)

    def refuse(*args, **kwargs):
        raise AssertionError("the fused stream may not run the unwrap transformation")

    monkeypatch.setattr(config, "fuse_streaming", True)
    monkeypatch.setattr(CoordinateUnwrapper, "run_transformation", refuse)
    res_fused = fused.run.EinsteinDiffusionCoefficients(**kw)
    assert not fused.store.check_existence("X/Unwrapped_Positions")
    assert res_fused.data_dict == res_mat.data_dict  # every float, with ==


def test_fused_port_matches_the_jax_fused_run(tmp_path, monkeypatch):
    wrapped = _wrapped_walk(300, 20, 0.3, seed=5)
    kw = dict(data_range=60, correlation_time=10, plot=False)
    monkeypatch.setattr(config, "fuse_streaming", True)
    monkeypatch.setattr(jax_config, "fuse_streaming", True)
    results = {}
    for package in (PORT, "lammps_analysis_tpu"):
        exp = _experiment(package, tmp_path / package, wrapped)
        results[package] = exp.run.EinsteinDiffusionCoefficients(**kw).data_dict
        assert not exp.store.check_existence("X/Unwrapped_Positions"), package
    assert_einstein_close(results[PORT], results["lammps_analysis_tpu"])


def test_fused_stream_prefers_a_materialised_dataset(tmp_path, monkeypatch):
    """A complete ``Unwrapped_Positions`` is cheaper to read than to recompute;
    without ``Positions`` there is nothing to unwrap from; a calculator that
    does not declare ``supports_fused_streaming`` never fuses."""
    monkeypatch.setattr(config, "fuse_streaming", True)
    exp = _experiment(PORT, tmp_path / "a", _wrapped_walk(200, 10, 0.05, seed=3))
    calc = EinsteinDiffusionCoefficients(exp)
    calc.args = calc.prepare_args(data_range=50, correlation_time=10)
    assert calc._fusible_unwrap("X")
    exp.run.CoordinateUnwrapper()
    assert not calc._fusible_unwrap("X")
    distinct = EinsteinDistinctDiffusionCoefficients(exp)
    exp.store.drop("X/Unwrapped_Positions")
    assert not distinct._fusible_unwrap("X")
    only_unwrapped = _experiment(PORT, tmp_path / "b", _wrapped_walk(200, 10, 0.05, seed=3),
                                 prop="Unwrapped_Positions")
    calc = EinsteinDiffusionCoefficients(only_unwrapped)
    assert not calc._fusible_unwrap("X")
    monkeypatch.setattr(config, "fuse_streaming", False)
    assert not EinsteinDiffusionCoefficients(exp)._fusible_unwrap("X")


def test_multi_species_stream_slabs_capped(tmp_path):
    """``_stream_properties_multi`` caps its window slabs at ``MAX_SLAB_BYTES``
    divided by the number of species it loads (each slab loads all of them),
    as the JAX package does (``test_calculators_integration.py``)."""
    rng = np.random.default_rng(17)
    n_frames, n_atoms = 180, 6
    pos = np.cumsum(rng.normal(scale=0.05, size=(n_frames, n_atoms, 3)), axis=0)
    lt = importlib.import_module(PORT)
    db = importlib.import_module(PORT + ".database")
    from lammps_analysis_tpu_torch.database.properties import PropertyInfo
    from lammps_analysis_tpu_torch.file_io import ScriptInput

    prop = PropertyInfo("Unwrapped_Positions", 3)
    species = [db.SpeciesInfo("A", n_atoms, [prop]), db.SpeciesInfo("B", n_atoms, [prop])]
    meta = db.TrajectoryMetadata(n_configurations=n_frames, species_list=species,
                                 box_l=[100.0] * 3, sample_rate=1)
    chunk = db.TrajectoryChunkData(species, n_frames)
    chunk.add_data(pos, 0, "A", "Unwrapped_Positions")
    chunk.add_data(pos + 1.0, 0, "B", "Unwrapped_Positions")
    exp = lt.Project(name="p", storage_path=tmp_path).add_experiment(
        "mcap", timestep=0.1, temperature=300.0, units="si",
        simulation_data=ScriptInput(chunk, meta, "d"),
    )
    calc = EinsteinDistinctDiffusionCoefficients(exp)
    calc.args = calc.prepare_args(data_range=32, correlation_time=8)
    seen = {}
    orig = calc._window_slab_plan

    def spy(path, data_range, correlation_time, max_slab_bytes=None):
        seen["max_slab_bytes"] = max_slab_bytes
        return orig(path, data_range, correlation_time, max_slab_bytes=max_slab_bytes)

    calc._window_slab_plan = spy
    first = next(iter(calc._stream_properties_multi(["A", "B"], "Unwrapped_Positions", 32, 8)))
    assert seen["max_slab_bytes"] == calc.MAX_SLAB_BYTES // 2 == (1 << 29) // 2
    assert set(first) == {"A", "B"}
    t = first["A"].shape[0]
    np.testing.assert_array_equal(first["A"].numpy(), pos[:t].astype(np.float32))
    np.testing.assert_array_equal(first["B"].numpy(), (pos[:t] + 1.0).astype(np.float32))
    calc._window_slab_plan = orig
    seen.clear()
    same = next(iter(calc._stream_properties_multi(["A", "A"], "Unwrapped_Positions", 32, 8)))
    assert set(same) == {"A"}


@pytest.mark.parametrize("budget", [None, 20000])
def test_multi_species_stream_covers_every_atom_once(tmp_path, budget):
    """Slab-major order: for each slab every atom group of every species, the
    groups of one slab concatenating to the whole selected atom axis."""
    rng = np.random.default_rng(23)
    counts, n_frames = {"A": 9, "B": 5}, 120
    pos = {sp: rng.normal(size=(n_frames, n, 3)).astype(np.float32).astype(np.float64)
           for sp, n in counts.items()}
    lt = importlib.import_module(PORT)
    db = importlib.import_module(PORT + ".database")
    from lammps_analysis_tpu_torch.database.properties import PropertyInfo
    from lammps_analysis_tpu_torch.file_io import ScriptInput

    prop = PropertyInfo("Velocities", 3)
    species = [db.SpeciesInfo(sp, n, [prop]) for sp, n in counts.items()]
    meta = db.TrajectoryMetadata(n_configurations=n_frames, species_list=species,
                                 box_l=[10.0] * 3, sample_rate=1)
    chunk = db.TrajectoryChunkData(species, n_frames)
    for sp in counts:
        chunk.add_data(pos[sp], 0, sp, "Velocities")
    exp = lt.Project(name="p", storage_path=tmp_path).add_experiment(
        "e", timestep=0.1, units="si", simulation_data=ScriptInput(chunk, meta, "d")
    )
    if budget is not None:
        exp.planner = BatchPlanner(memory_budget_bytes=budget)
    calc = EinsteinDistinctDiffusionCoefficients(exp)
    calc.args = calc.prepare_args(data_range=24, correlation_time=6)
    slabs = {}
    for data, info in calc._stream_properties_multi(["A", "B"], "Velocities", 24, 6, with_info=True):
        slabs.setdefault(info.slab_index, []).append((info, data))
    assert (budget is None) == (max(i.n_groups for s in slabs.values() for i, _ in s) == 1)
    for si, parts in slabs.items():
        assert [info.group for info, _ in parts] == list(range(parts[0][0].n_groups))
        start, stop = parts[0][0].start, parts[0][0].stop
        for sp in counts:
            whole = torch.cat([data[sp] for _, data in parts], dim=1).numpy()
            np.testing.assert_array_equal(whole, pos[sp][start:stop].astype(np.float32))
