"""PyTorch port, the flux transformations and the multi-species runner, held
against the JAX package's ``flux_transforms.py`` on the same inputs, against
MDSuite's own kernels (``golden_transformations.json``) and against float64
numpy evaluations of the formulas (``tests/torch_dumps.py``).

Tolerances. Inputs are float32 values (rounded first); the port sums them in
float64 and stores float32, the JAX package runs here with x64 on. Each
series: ``max|diff| <= 1e-5 * max|J|`` plus rtol 1e-5. Runs that chain or
resume one computation (slabs, appends) are held to the uninterrupted run
at float64 rounding (rtol 1e-12), or at float32 storage rounding (rtol 1e-6)
when both are stored. Each package gets its own ``tmp_path`` directory.
"""

import importlib
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lammps_analysis_tpu.transformations.flux_transforms as jax_flux
from lammps_analysis_tpu_torch.database.properties import mdsuite_properties as mp
from lammps_analysis_tpu_torch.transformations import flux_transforms as flux
from lammps_analysis_tpu_torch.utils.config import config

from torch_dumps import FLUX_SERIES, flux_columns, flux_series_direct, random_walk, walk_columns, write_dump
from torch_jax_parser import ensure_jax_native_parser

torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).parent / "goldens"
DT, EVERY = 0.002, 10  # ps, frames written every 10 steps
CLASSES = {
    "IonicCurrent": "Ionic_Current",
    "TranslationalDipoleMoment": "Translational_Dipole_Moment",
    "ThermalFlux": "Thermal_Flux",
    "IntegratedHeatCurrent": "Integrated_Heat_Current",
    "KinaciIntegratedHeatCurrent": "Kinaci_Heat_Current",
    "MomentumFlux": "Momentum_Flux",
}


@pytest.fixture(scope="module", autouse=True)
def jax_reads_natively():
    ensure_jax_native_parser()


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def assert_flux_close(ours, ref, err_msg=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(
        np.asarray(ours, np.float64), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(), err_msg=err_msg
    )


# ------------------------------------------------------------- batch kernels
def _batch(counts, n_frames, seed, q_per_atom=False):
    """``{species: {property: float32-valued float64 array}}`` of every flux
    input; charges a (1, 1, 1) constant or a per-atom (T, N, 1) column."""
    rng = np.random.default_rng(seed)
    batch = {}
    for i, (sp, n) in enumerate(zip(("Na", "Cl", "K"), counts)):
        shape = (n_frames, n)
        q = (1.0, -1.0, 2.0)[i]
        props = {
            "Velocities": rng.normal(scale=10.0, size=shape + (3,)),
            "Unwrapped_Positions": np.cumsum(rng.normal(size=shape + (3,)), axis=0),
            "Forces": rng.normal(size=shape + (3,)),
            "Stress": rng.normal(scale=1000.0, size=shape + (6,)),
            "Kinetic_Energy": rng.uniform(0.0, 0.2, shape + (1,)),
            "Potential_Energy": rng.uniform(-6.0, -2.0, shape + (1,)),
            "Charge": rng.choice([q, q / 2], size=shape + (1,)) if q_per_atom else np.full((1, 1, 1), q),
        }
        props = {k: v.astype(np.float32).astype(np.float64) for k, v in props.items()}
        props["Time_Step"] = np.asarray(0.002)
        props["Sample_Rate"] = np.asarray(10.0)
        batch[sp] = props
    return batch


def _port_batch(batch):
    """The runner's layout: stored data float32, metadata constants float64."""
    constants = ("Charge", "Time_Step", "Sample_Rate")
    return {
        sp: {
            k: torch.from_numpy(v if (k in constants and v.size == 1) else v.astype(np.float32))
            for k, v in props.items()
        }
        for sp, props in batch.items()
    }


def _select(batch, cls):
    names = {p.name for p in cls.input_properties}
    return {sp: {k: v for k, v in props.items() if k in names} for sp, props in batch.items()}


CASES = [(name, kw) for name in CLASSES for kw in ({},)] + [
    ("KinaciIntegratedHeatCurrent", {"reference_accumulation": True})
]


@pytest.mark.parametrize("q_per_atom", [False, True], ids=["q-constant", "q-per-atom"])
@pytest.mark.parametrize("name, kw", CASES, ids=[n + ("-reference" if kw else "") for n, kw in CASES])
def test_transform_batch_matches_jax(name, kw, q_per_atom):
    counts = (9, 9, 9) if kw else (9, 7, 5)
    batch = _batch(counts, 24, seed=len(name), q_per_atom=q_per_atom)
    ours_cls, ref_cls = getattr(flux, name), getattr(jax_flux, name)
    inputs = _select(batch, ours_cls)
    ours, carry = ours_cls(**kw).transform_batch(_port_batch(inputs), None)
    ref, ref_carry = ref_cls(**kw).transform_batch(
        {sp: {k: jnp.asarray(v) for k, v in p.items()} for sp, p in inputs.items()}, None
    )
    assert ours.dtype == torch.float64 and ours.shape == (24, 3)
    assert_flux_close(ours.numpy(), ref, name)
    if ours_cls.requires_carryover:
        assert set(carry) == set(ref_carry)
        for key in carry:
            np.testing.assert_allclose(carry[key].numpy(), np.asarray(ref_carry[key]), rtol=1e-10)


def test_direct_series_match_jax():
    """``flux_series_direct``, which ``chip_smoke.py`` holds the card's
    series to, against the JAX transformations in float64 (rtol 1e-10)."""
    batch = _batch((6, 4), 12, seed=3)
    data = {sp: {k: v for k, v in p.items()} for sp, p in batch.items()}
    direct = flux_series_direct(data, {"Na": 1.0, "Cl": -1.0}, 0.002 * 10.0)
    for name, prop in CLASSES.items():
        cls = getattr(jax_flux, name)
        inputs = _select(batch, cls)
        ref, _ = cls().transform_batch(
            {sp: {k: jnp.asarray(v) for k, v in p.items()} for sp, p in inputs.items()}, None
        )
        np.testing.assert_allclose(direct[prop], np.asarray(ref), rtol=1e-10,
                                   atol=1e-10 * np.abs(np.asarray(ref)).max(), err_msg=name)


@pytest.mark.parametrize("reference", [False, True], ids=["per-species", "reference"])
def test_kinaci_slabs_with_carry(reference):
    """Slabs of 7, 1 and 22 frames chained by the carry: the per-species
    integrals equal one slab (rtol 1e-12); the reference's coupled
    accumulation carries one total across slabs, which depends on the
    slabs by construction, and equals the JAX package's chain."""
    batch = _select(_batch((6, 6), 30, seed=8), flux.KinaciIntegratedHeatCurrent)
    ours_cls = flux.KinaciIntegratedHeatCurrent(reference_accumulation=reference)
    ref_cls = jax_flux.KinaciIntegratedHeatCurrent(reference_accumulation=reference)
    whole, _ = ours_cls.transform_batch(_port_batch(batch), None)
    parts, ref_parts, carry, ref_carry = [], [], None, None
    for a, b in ((0, 7), (7, 8), (8, 30)):
        sub = {sp: {k: (v[a:b] if v.ndim == 3 and v.shape[0] > 1 else v) for k, v in p.items()}
               for sp, p in batch.items()}
        out, carry = ours_cls.transform_batch(_port_batch(sub), carry)
        parts.append(out.numpy())
        ref_out, ref_carry = ref_cls.transform_batch(
            {sp: {k: jnp.asarray(v) for k, v in p.items()} for sp, p in sub.items()}, ref_carry
        )
        ref_parts.append(np.asarray(ref_out))
    chained = np.concatenate(parts)
    assert_flux_close(chained, np.concatenate(ref_parts))
    if not reference:
        np.testing.assert_allclose(chained, whole.numpy(), rtol=1e-12, atol=1e-12 * np.abs(chained).max())


def test_kinaci_reference_accumulation_needs_equal_counts(tmp_path):
    batch = _port_batch(_select(_batch((6, 4), 5, seed=2), flux.KinaciIntegratedHeatCurrent))
    with pytest.raises(ValueError, match="equal particle counts"):
        flux.KinaciIntegratedHeatCurrent(reference_accumulation=True).transform_batch(batch)
    flux.KinaciIntegratedHeatCurrent().transform_batch(batch)  # the default mode takes any counts
    exp = _dump_experiment("lammps_analysis_tpu_torch", tmp_path, _dump(tmp_path / "t.lammpstrj", counts=(6, 4)))
    with pytest.raises(ValueError, match="resume requires equal particle counts"):
        flux.KinaciIntegratedHeatCurrent(reference_accumulation=True).bootstrap_carry_multi(
            exp, ["Na", "Cl"], 5
        )


# -------------------------------------------------------------------- goldens
def _golden_batch(g, spec):
    ins = g["inputs"]
    batch = {}
    for sp, props in spec.items():
        batch[sp] = {}
        for attr, key in props.items():
            value = np.array(ins[key], np.float64)
            # the reference's (atoms, time, d) -> (time, atoms, d)
            value = np.transpose(value, (1, 0, 2)) if value.ndim == 3 else value
            batch[sp][getattr(mp, attr).name] = torch.from_numpy(np.ascontiguousarray(value))
    return batch


GOLDEN_CASES = [
    ("IonicCurrent", "ionic_current",
     {"A": {"velocities": "vel_a", "charge": "q_a"}, "B": {"velocities": "vel_b", "charge": "q_b"}}),
    ("TranslationalDipoleMoment", "translational_dipole_moment",
     {"A": {"unwrapped_positions": "upos_a", "charge": "q_a"},
      "B": {"unwrapped_positions": "upos_b", "charge": "q_b"}}),
    ("ThermalFlux", "thermal_flux",
     {"A": {"stress": "stress_a", "velocities": "vel_a", "kinetic_energy": "ke_a", "potential_energy": "pe_a"},
      "B": {"stress": "stress_b", "velocities": "vel_b", "kinetic_energy": "ke_b", "potential_energy": "pe_b"}}),
    ("IntegratedHeatCurrent", "integrated_heat_current",
     {"A": {"unwrapped_positions": "upos_a", "kinetic_energy": "ke_a", "potential_energy": "pe_a"},
      "B": {"unwrapped_positions": "upos_b", "kinetic_energy": "ke_b", "potential_energy": "pe_b"}}),
    ("MomentumFlux", "momentum_flux", {"A": {"stress": "stress_a"}, "B": {"stress": "stress_b"}}),
]


@pytest.fixture(scope="module")
def golden():
    return json.loads((GOLDENS / "golden_transformations.json").read_text())


@pytest.mark.parametrize("name, key, spec", GOLDEN_CASES, ids=[c[0] for c in GOLDEN_CASES])
def test_flux_matches_the_reference_kernels(golden, name, key, spec):
    out, _ = getattr(flux, name)().transform_batch(_golden_batch(golden, spec))
    np.testing.assert_allclose(out.numpy(), np.array(golden[key]), rtol=1e-9, atol=1e-9)


def test_kinaci_reference_accumulation_matches_the_reference_kernel(golden):
    spec = {
        "A": {"unwrapped_positions": "kin_pos_a", "velocities": "vel_a", "forces": "force_a",
              "potential_energy": "pe_a", "time_step": "time_step", "sample_rate": "sample_rate"},
        "B": {"unwrapped_positions": "kin_pos_b", "velocities": "kin_vel_b", "forces": "kin_force_b",
              "potential_energy": "kin_pe_b", "time_step": "time_step", "sample_rate": "sample_rate"},
    }
    trafo = flux.KinaciIntegratedHeatCurrent(reference_accumulation=True)
    batch = _golden_batch(golden, spec)
    first, carry = trafo.transform_batch(batch, None)
    np.testing.assert_allclose(first.numpy(), np.array(golden["kinaci_batch1"]), rtol=1e-9, atol=1e-9)
    # upstream's own carry crashes (recorded in the golden); the carried run
    # matches the golden with the carry reshaped as the tile expects
    assert golden["kinaci_carry_crashes_upstream"]
    second, _ = trafo.transform_batch(batch, carry)
    np.testing.assert_allclose(second.numpy(), np.array(golden["kinaci_batch2_same_inputs_with_carry"]),
                               rtol=1e-9, atol=1e-9)


# ---------------------------------------------------------------- the runner
def _dump(path, counts=(12, 8), n_frames=40, seed=11, q_column=False, first_step=0, frames=None):
    wrapped, _, vel, names = random_walk(counts, n_frames, 10.0, 0.3, DT * EVERY, seed)
    cols = walk_columns(wrapped, vel, names)
    cols.update(flux_columns(n_frames, sum(counts), seed + 1))
    if q_column:
        cols["q"] = np.where(names == "Na", 1.0, -1.0)
    if frames is not None:
        cols = {k: (v[frames] if np.ndim(v) == 2 else v) for k, v in cols.items()}
    write_dump(path, 10.0, cols, every=EVERY, shuffle_seed=seed + 2, first_step=first_step)
    return path


def _dump_experiment(package, root, path, charges=True, budget=None):
    pkg = importlib.import_module(package)
    exp = pkg.Project(name="p", storage_path=root / package).add_experiment(
        "e", timestep=DT, temperature=1200.0, units="metal"
    )
    if budget is not None:
        exp.planner = importlib.import_module(package + ".memory.planner").BatchPlanner(
            memory_budget_bytes=budget
        )
    for p in path if isinstance(path, list) else [path]:
        exp.add_data(str(p))
    if charges:
        exp.set_charge("Na", 1.0)
        exp.set_charge("Cl", -1.0)
    return exp


def _observables(exp):
    return {p: exp.store.load([f"Observables/{p}"])[f"Observables/{p}"] for p in FLUX_SERIES}


def _run_all(exp):
    for name in CLASSES:
        getattr(exp.run, name)()


@pytest.mark.parametrize("charge", ["metadata", "q-column"])
def test_runner_matches_jax_and_the_direct_series(tmp_path, charge):
    """Every flux transformation through ``exp.run`` on a dump: the
    multi-species runner resolves each species' inputs through the cascade
    (stored datasets, the charge as a metadata constant or as the dump's
    ``q`` column, ``Unwrapped_Positions`` by running the unwrapper) and
    writes ``(T, 1, 3)`` rows under ``Observables``."""
    path = _dump(tmp_path / "t.lammpstrj", q_column=charge == "q-column")
    results = {}
    for package in ("lammps_analysis_tpu_torch", "lammps_analysis_tpu"):
        exp = _dump_experiment(package, tmp_path, path, charges=charge == "metadata")
        _run_all(exp)
        results[package] = _observables(exp)
        if package == "lammps_analysis_tpu_torch":
            port = exp
    assert "Observables" not in port.species
    assert port.store.get_data_size("Observables/Ionic_Current") == (40, 1, 3)
    for prop in FLUX_SERIES:
        assert results["lammps_analysis_tpu_torch"][prop].dtype == np.float32
        assert_flux_close(results["lammps_analysis_tpu_torch"][prop], results["lammps_analysis_tpu"][prop], prop)
    arrays = {
        sp: {k: port.store.load([f"{sp}/{k}"])[f"{sp}/{k}"] for k in
             ("Velocities", "Unwrapped_Positions", "Forces", "Stress", "Kinetic_Energy", "Potential_Energy")}
        for sp in ("Na", "Cl")
    }
    direct = flux_series_direct(arrays, {"Na": 1.0, "Cl": -1.0}, DT * EVERY)
    for prop in FLUX_SERIES:
        assert_flux_close(results["lammps_analysis_tpu_torch"][prop][:, 0], direct[prop], prop)


def test_stored_charge_column_wins_over_metadata(tmp_path):
    """The cascade reads a stored ``Charge`` before the species' charge."""
    path = _dump(tmp_path / "t.lammpstrj", q_column=True)
    exp = _dump_experiment("lammps_analysis_tpu_torch", tmp_path, path, charges=False)
    exp.set_charge("Na", 5.0)
    exp.run.IonicCurrent()
    vel = {sp: exp.store.load([f"{sp}/Velocities"])[f"{sp}/Velocities"].astype(np.float64) for sp in ("Na", "Cl")}
    expected = vel["Na"].sum(1) - vel["Cl"].sum(1)
    assert_flux_close(exp.store.load(["Observables/Ionic_Current"])["Observables/Ionic_Current"][:, 0], expected)


def test_runner_resumes_after_an_append(tmp_path):
    """Two dumps appended one after the other, the transformations run in
    between, in slabs of a few frames: every series equals the one-pass run
    over both (rtol 1e-6), Kinaci through ``bootstrap_carry_multi``'s
    float64 re-integration and the position-based series through the
    unwrapper's extension of ``Unwrapped_Positions``."""
    first = _dump(tmp_path / "a.lammpstrj", frames=slice(0, 25))
    second = _dump(tmp_path / "b.lammpstrj", frames=slice(25, 40), first_step=25 * EVERY)
    whole = _dump_experiment("lammps_analysis_tpu_torch", tmp_path / "whole", [first, second])
    _run_all(whole)
    resumed = _dump_experiment("lammps_analysis_tpu_torch", tmp_path / "resumed", first, budget=100_000)
    _run_all(resumed)
    assert resumed.store.get_cursor("Observables/Kinaci_Heat_Current") == 25
    resumed.add_data(str(second))
    calls = []
    original = flux.KinaciIntegratedHeatCurrent.bootstrap_carry_multi

    def spy(self, *args):
        calls.append(args[-1])
        return original(self, *args)

    flux.KinaciIntegratedHeatCurrent.bootstrap_carry_multi = spy
    try:
        _run_all(resumed)
    finally:
        flux.KinaciIntegratedHeatCurrent.bootstrap_carry_multi = original
    assert calls == [25]
    ours, ref = _observables(resumed), _observables(whole)
    for prop in FLUX_SERIES:
        np.testing.assert_allclose(ours[prop], ref[prop], rtol=1e-6, atol=1e-6 * np.abs(ref[prop]).max(),
                                   err_msg=prop)


def test_bootstrap_carry_multi_equals_the_running_integral(tmp_path):
    """The resume carry at frame k equals the uninterrupted run's carry
    after k frames, in both modes (rtol 1e-12)."""
    exp = _dump_experiment("lammps_analysis_tpu_torch", tmp_path, _dump(tmp_path / "t.lammpstrj", counts=(7, 7)))
    exp.run.CoordinateUnwrapper()
    data = {
        sp: {k: torch.from_numpy(exp.store.load([f"{sp}/{k}"], frames=slice(0, 17))[f"{sp}/{k}"])
             for k in ("Unwrapped_Positions", "Velocities", "Forces", "Potential_Energy")}
        for sp in ("Na", "Cl")
    }
    for sp in data:
        data[sp]["Time_Step"] = torch.tensor([DT], dtype=torch.float64)
        data[sp]["Sample_Rate"] = torch.tensor([float(EVERY)], dtype=torch.float64)
    for reference in (False, True):
        trafo = flux.KinaciIntegratedHeatCurrent(reference_accumulation=reference)
        _, running = trafo.transform_batch(data, None)
        rebuilt = trafo.bootstrap_carry_multi(exp, ["Na", "Cl"], 17)
        assert set(rebuilt) == set(running)
        for key in running:
            np.testing.assert_allclose(rebuilt[key].numpy(), running[key].numpy(), rtol=1e-12)
