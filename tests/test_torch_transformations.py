"""PyTorch port, the coordinate transformations, held against the JAX
package's transformations and against MDSuite's own outputs
(``golden_transformations.json``).

Tolerances. The goldens feed float64 tensors to ``transform_batch`` and
compare at the JAX package's own tolerances (rtol 1e-12). Through a store,
the port computes in float32 (the store's dtype) and the JAX package, with
x64 on, in float64 from the same float32 values: with a box that float32
holds exactly, ``pos + image * box`` is one rounding of the same exact sum,
so the port's stored output equals the JAX output rounded to float32.
Each package gets its own ``tmp_path`` directory.
"""

import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

from lammps_analysis_tpu_torch.transformations import (
    CoordinateUnwrapper,
    CoordinateWrapper,
    ScaleCoordinates,
    UnwrapViaIndices,
    VelocityFromPositions,
    transformation_for_property,
)
from lammps_analysis_tpu_torch.utils.config import config

from torch_dumps import random_walk, walk_columns, write_dump
from torch_jax_parser import ensure_jax_native_parser

torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).parent / "goldens"
BOX = 8.0


@pytest.fixture(scope="module", autouse=True)
def jax_reads_natively():
    ensure_jax_native_parser()


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


# ------------------------------------------------------------------ goldens
@pytest.fixture(scope="module")
def golden():
    return json.loads((GOLDENS / "golden_transformations.json").read_text())


def _t(x):
    """reference layout (atoms, time, d) -> (time, atoms, d), float64 tensor"""
    return torch.from_numpy(np.transpose(np.array(x, dtype=np.float64), (1, 0, 2)).copy())


def test_golden_unwrap_with_carry_chain(golden):
    ins = golden["inputs"]
    box = torch.tensor(ins["box"], dtype=torch.float64)
    trafo = CoordinateUnwrapper()
    o1, carry = trafo.transform_batch({"Positions": _t(ins["pos_a_1"]), "Box_Array": box})
    np.testing.assert_allclose(o1.numpy(), _t(golden["unwrap_batch1"]).numpy(), rtol=1e-12)
    o2, _ = trafo.transform_batch({"Positions": _t(ins["pos_a_2"]), "Box_Array": box}, carry)
    np.testing.assert_allclose(o2.numpy(), _t(golden["unwrap_batch2"]).numpy(), rtol=1e-12)


def test_golden_unwrap_via_indices(golden):
    ins = golden["inputs"]
    out, _ = UnwrapViaIndices().transform_batch({
        "Positions": _t(ins["pos_a_1"]),
        "Box_Array": torch.tensor(ins["box"], dtype=torch.float64),
        "Box_Images": _t(ins["images_a"]),
    })
    np.testing.assert_allclose(out.numpy(), _t(golden["unwrap_via_indices"]).numpy(), rtol=1e-12)


@pytest.mark.parametrize("center", [False, True])
def test_golden_wrap(golden, center):
    ins = golden["inputs"]
    out, _ = CoordinateWrapper(center_box=center).transform_batch({
        "Unwrapped_Positions": _t(ins["upos_a"]),
        "Box_Array": torch.tensor(ins["box"], dtype=torch.float64),
    })
    np.testing.assert_allclose(
        out.numpy(), _t(golden[f"wrap_center_{center}"]).numpy(), rtol=1e-12, atol=1e-12
    )


def test_golden_scale(golden):
    ins = golden["inputs"]
    out, _ = ScaleCoordinates().transform_batch({
        "Scaled_Positions": _t(ins["spos_a"]),
        "Box_Array": torch.tensor(ins["box"], dtype=torch.float64),
    })
    np.testing.assert_allclose(out.numpy(), _t(golden["scale"]).numpy(), rtol=1e-12)


def test_golden_velocity_from_positions(golden):
    ins = golden["inputs"]
    out, _ = VelocityFromPositions().transform_batch({
        "Unwrapped_Positions": _t(ins["upos_a"]),
        "Time_Step": torch.tensor(ins["time_step"], dtype=torch.float64),
        "Sample_Rate": torch.tensor(float(ins["sample_rate"]), dtype=torch.float64),
    })
    np.testing.assert_allclose(
        out.numpy(), _t(golden["velocity_from_positions"]).numpy(), rtol=1e-10
    )


# ---------------------------------------------------------- through a store
def _walk(n_frames=60):
    return random_walk((9, 7), n_frames, BOX, 0.5, 0.02, seed=21)


def _write(path, wrapped, vel, names, first_frame=0, extra=None):
    cols = walk_columns(wrapped, vel, names)
    cols.update(extra or {})
    write_dump(path, BOX, cols, every=10, shuffle_seed=first_frame + 1,
               first_step=10 * first_frame)
    return path


def _experiment(package, root, source, budget=None):
    pkg = importlib.import_module(package)
    exp = pkg.Project(name="p", storage_path=root).add_experiment(
        "e", timestep=0.002, units="metal"
    )
    if budget is not None:
        planner = importlib.import_module(package + ".memory.planner")
        exp.planner = planner.BatchPlanner(memory_budget_bytes=budget)
    if source is not None:
        exp.add_data(str(source))
    return exp


def _stored(exp, prop):
    return {sp: exp.store.load([f"{sp}/{prop}"])[f"{sp}/{prop}"] for sp in ("Na", "Cl")}


def test_unwrap_matches_jax_over_small_slabs_and_an_append(tmp_path):
    """Ingest 30 frames, unwrap in 7-frame slabs, append 30 more, unwrap again
    (the carry is rebuilt at the seam): equal to the JAX package doing the
    same, to one pass over the whole file, and to the generator's walk."""
    wrapped, unwrapped, vel, names = _walk()
    first = _write(tmp_path / "a.lammpstrj", wrapped[:30], vel[:30], names)
    second = _write(tmp_path / "b.lammpstrj", wrapped[30:], vel[30:], names, first_frame=30)
    whole = _write(tmp_path / "w.lammpstrj", wrapped, vel, names)
    seven_frames = 7 * 9 * 3 * 8 * 3 * 2  # transformation_batch_size -> 7

    results = {}
    for package in ("lammps_analysis_tpu_torch", "lammps_analysis_tpu"):
        exp = _experiment(package, tmp_path / package, first, budget=seven_frames)
        assert exp.planner.transformation_batch_size(CoordinateUnwrapper(), exp) == 7
        exp.run.CoordinateUnwrapper()
        exp.add_data(str(second))
        exp.run.CoordinateUnwrapper()
        assert exp.store.get_cursor("Na/Unwrapped_Positions") == 60
        results[package] = _stored(exp, "Unwrapped_Positions")
    single = _experiment("lammps_analysis_tpu_torch", tmp_path / "one", whole)
    single.run.CoordinateUnwrapper()
    one_pass = _stored(single, "Unwrapped_Positions")
    ours, ref = results["lammps_analysis_tpu_torch"], results["lammps_analysis_tpu"]
    for sp, rows in (("Na", slice(0, 9)), ("Cl", slice(9, 16))):
        assert ours[sp].dtype == np.float32
        np.testing.assert_array_equal(ours[sp], ref[sp].astype(np.float32), err_msg=sp)
        np.testing.assert_array_equal(ours[sp], one_pass[sp], err_msg=sp)
        np.testing.assert_allclose(ours[sp], unwrapped[:, rows], rtol=0, atol=1e-4)
        assert np.abs(np.diff(ours[sp], axis=0)).max() < BOX / 2  # no jump left


def test_unwrap_via_indices_from_dump_images(tmp_path):
    """A dump with ``ix iy iz``: Einstein's dependency check picks
    ``UnwrapViaIndices`` (store-aware, as the JAX registry), and the stored
    unwrap equals the JAX package's."""
    wrapped, unwrapped, vel, names = _walk(n_frames=20)
    images = np.floor_divide(unwrapped, BOX).astype(np.int64)
    extra = {f"i{a}": images[:, :, i] for i, a in enumerate("xyz")}
    path = _write(tmp_path / "t.lammpstrj", wrapped, vel, names, extra=extra)
    results = {}
    for package in ("lammps_analysis_tpu_torch", "lammps_analysis_tpu"):
        exp = _experiment(package, tmp_path / package, path)
        assert type(transformation_for_property(
            "Unwrapped_Positions", experiment=exp, species="Na"
        )).__name__ == "UnwrapViaIndices"
        exp.run.EinsteinDiffusionCoefficients(data_range=5, plot=False)
        results[package] = _stored(exp, "Unwrapped_Positions")
    for sp in ("Na", "Cl"):
        np.testing.assert_array_equal(
            results["lammps_analysis_tpu_torch"][sp],
            results["lammps_analysis_tpu"][sp].astype(np.float32),
        )
    np.testing.assert_allclose(results["lammps_analysis_tpu_torch"]["Na"], unwrapped[:, :9], atol=1e-4)


def _script_experiment(package, root, props):
    """An experiment whose store holds exactly ``props`` for Na (4 atoms)."""
    pkg = importlib.import_module(package)
    db = importlib.import_module(package + ".database")
    file_io = importlib.import_module(package + ".file_io")
    prop_infos = [db.PropertyInfo(p, 3) for p in props]
    species = [db.SpeciesInfo("Na", 4, prop_infos)]
    meta = db.TrajectoryMetadata(n_configurations=5, species_list=species,
                                 box_l=[BOX] * 3, sample_rate=1)
    chunk = db.TrajectoryChunkData(species, 5)
    rng = np.random.default_rng(3)
    for p in props:
        chunk.add_data(rng.uniform(0, 1, (5, 4, 3)).astype(np.float32), 0, "Na", p)
    return pkg.Project(name="p", storage_path=root).add_experiment(
        "e", timestep=0.1, units="metal",
        simulation_data=file_io.ScriptInput(chunk, meta, "s"),
    )


@pytest.mark.parametrize(
    "props",
    [
        ("Positions",),
        ("Positions", "Box_Images"),
        ("Scaled_Positions",),
        ("Unwrapped_Positions",),
        ("Velocities",),
    ],
    ids=lambda p: "+".join(p),
)
def test_registry_store_aware_choice_matches_jax(tmp_path, props):
    from lammps_analysis_tpu.transformations.registry import (
        transformation_for_property as jax_choice,
    )

    ours = _script_experiment("lammps_analysis_tpu_torch", tmp_path / "t", props)
    ref = _script_experiment("lammps_analysis_tpu", tmp_path / "j", props)
    for prop in ("Unwrapped_Positions", "Positions", "Velocities_From_Positions", "Velocities"):
        got = transformation_for_property(prop, experiment=ours, species="Na")
        want = jax_choice(prop, experiment=ref, species="Na")
        assert type(got).__name__ == type(want).__name__, prop


def test_registry_refuses_unported_producers():
    """Every flux property has its producer now, and the run hub serves
    ``MolecularMap`` as the JAX package's does; a property no
    transformation produces has no producer."""
    from lammps_analysis_tpu_torch.experiment.run import RunComputation
    from lammps_analysis_tpu_torch.transformations import ALL_TRANSFORMATIONS, IonicCurrent

    assert isinstance(transformation_for_property("Ionic_Current"), IonicCurrent)
    assert ALL_TRANSFORMATIONS["MolecularMap"].__name__ == "MolecularMap"
    assert callable(RunComputation().MolecularMap)
    assert transformation_for_property("Forces") is None
    assert isinstance(transformation_for_property("Unwrapped_Positions"), CoordinateUnwrapper)


def test_scaled_only_store_cascades_like_jax(tmp_path):
    """Only ``Scaled_Positions`` stored: the unwrapper's Positions input is
    produced by ``ScaleCoordinates`` first (the input cascade), as in the
    JAX package."""
    results = {}
    for package in ("lammps_analysis_tpu_torch", "lammps_analysis_tpu"):
        exp = _script_experiment(package, tmp_path / package, ("Scaled_Positions",))
        exp.run.CoordinateUnwrapper()
        results[package] = {
            p: exp.store.load([f"Na/{p}"])[f"Na/{p}"]
            for p in ("Positions", "Unwrapped_Positions")
        }
    for p, ref in results["lammps_analysis_tpu"].items():
        np.testing.assert_array_equal(results["lammps_analysis_tpu_torch"][p], ref.astype(np.float32))


def test_hub_runs_transformations_like_jax(tmp_path):
    wrapped, _, vel, names = _walk(n_frames=12)
    path = _write(tmp_path / "t.lammpstrj", wrapped, vel, names)
    results = {}
    for package in ("lammps_analysis_tpu_torch", "lammps_analysis_tpu"):
        exp = _experiment(package, tmp_path / package, path)
        exp.run.VelocityFromPositions()  # runs the unwrapper first
        exp.store.drop("Na/Positions")
        exp.run.CoordinateWrapper(species=["Na"], center_box=False)
        results[package] = {
            p: _stored(exp, p)["Na"]
            for p in ("Velocities_From_Positions", "Positions")
        }
    ours, ref = results["lammps_analysis_tpu_torch"], results["lammps_analysis_tpu"]
    # velocities: float32 differences over float32 dt against float64 ones
    np.testing.assert_allclose(ours["Velocities_From_Positions"],
                               ref["Velocities_From_Positions"], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(ours["Positions"], ref["Positions"], rtol=0, atol=1e-5)
    from lammps_analysis_tpu_torch import Molecule, Project

    exp = Project(name="p", storage_path=tmp_path / "lammps_analysis_tpu_torch").experiments["e"]
    with pytest.raises(ValueError, match="needs species"):  # the JAX package's error
        exp.run.MolecularMap(molecules=[Molecule("water", smiles="O", cutoff=1.2)])
