"""A configuration's generator may hand over named per-atom properties.

A generator returns the positions ``(F, N, 3)`` or a mapping from the port's
property names (``Positions``, ``Velocities``, ...) to such tensors. The
harness ingests every property through ``ScriptInput`` and the plain
reference receives the generator's output in its form.

These tests build a tiny two-species cell of their own (ions of charge +1
and -1 with seeded positions and velocities) and drive it on the CPU:
through ``harness.ingest`` into the port's store and its ``IonicCurrent``,
and through a whole ``harness.Run`` of ``GreenKuboIonicConductivity``. The
cells of ``BENCHMARK.json`` hand over a positions tensor, which is ingested
exactly as ``{"Positions": tensor}`` is.
"""

import types
import weakref

import numpy as np
import pytest
import torch

from portbench import harness, spec

from conftest import tiny_cell

TINY_IONS = {
    "name": "ions_tiny",
    "species": {"Na": 24, "Cl": 16},
    "charges": {"Na": 1.0, "Cl": -1.0},
    "box_length": 12.0,
    "n_frames": 60,
    "units": "metal",
    "timestep": 0.002,
    "sample_rate": 100,
    "temperature": 1400,
}
GK_TRAFFIC = {
    "calculator": "GreenKuboIonicConductivity",
    "args": {"data_range": 20, "correlation_time": 10},
    "trace_calls": 2,
}


def generate_ions(config, seed, device):
    """Seeded positions in the box and velocities of a few A/ps, float32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (config["n_frames"], sum(config["species"].values()), 3)
    positions = torch.rand(shape, generator=gen, device=device) * config["box_length"]
    velocities = 7.0 * torch.randn(shape, generator=gen, device=device)
    return {"Positions": positions, "Velocities": velocities}


def ions_cell(**traffic):
    bench = spec.load_benchmark()
    return spec.Cell(
        name="ions_tiny.gk", chips=1, config=dict(TINY_IONS), traffic=dict(GK_TRAFFIC, **traffic),
        limits={}, end_to_end=bench["end_to_end"], per_layer=[],
    )


class SeenReference:
    """A test-local reference that keeps what the harness hands it."""

    def __init__(self):
        self.inputs = []

    def compute(self, inputs, config, args, dtype=torch.float64):
        self.inputs.append(inputs)
        return {}, {}

    def judge(self, answer, reference, work):
        return {}


@pytest.fixture()
def ions(monkeypatch):
    """``ions_cell``'s generator and a ``SeenReference`` in place of the
    modules a cell finds by name."""
    seen = SeenReference()
    module = types.SimpleNamespace(generate=generate_ions)
    monkeypatch.setattr(spec.Cell, "generator", lambda self: module)
    monkeypatch.setattr(spec.Cell, "reference", lambda self: seen)
    return seen


def test_velocities_come_through_ingest_and_the_ionic_current(tmp_path, port_on_cpu):
    """(a) Each species' ``Velocities`` come back from the store bit for bit,
    and the stored ``Ionic_Current`` is ``sum_i q_i v_i(t)``.

    The port sums in float64 and stores the current as float32, so the
    stored value is the float64 sum rounded once: it may lie half a float32
    ulp from it, plus what the order of a float64 sum of 40 terms can move
    (40 float64 ulps of the summed magnitudes)."""
    generated = generate_ions(TINY_IONS, seed=2**31 + 7, device="cpu")
    host = {name: tensor.numpy() for name, tensor in generated.items()}
    exp = harness.ingest(str(tmp_path), TINY_IONS, host)
    store = exp.store
    offset = 0
    for name, n in TINY_IONS["species"].items():
        assert store.properties_of(name) == ["Positions", "Velocities"]
        for prop in ("Positions", "Velocities"):
            stored = store.load([f"{name}/{prop}"])[f"{name}/{prop}"]
            assert stored.dtype == np.float32
            np.testing.assert_array_equal(stored, host[prop][:, offset:offset + n])
        offset += n

    exp.run.IonicCurrent()
    current = store.load(["Observables/Ionic_Current"])["Observables/Ionic_Current"][:, 0]
    charges = np.repeat([TINY_IONS["charges"][s] for s in TINY_IONS["species"]],
                        list(TINY_IONS["species"].values()))
    terms = charges[None, :, None] * host["Velocities"].astype(np.float64)
    expected = terms.sum(axis=1)
    room = (0.5 * np.spacing(np.abs(expected).astype(np.float32)).astype(np.float64)
            + terms.shape[1] * np.finfo(np.float64).eps * np.abs(terms).sum(axis=1))
    assert current.shape == expected.shape
    assert np.all(np.abs(current.astype(np.float64) - expected) <= room)


def test_a_run_of_green_kubo_hands_the_reference_the_velocities(ions, port_on_cpu):
    """(b) A whole run of the GK ionic conductivity on the tiny cell: no call
    fails, and the reference receives the generator's mapping, velocities and
    all, on the run's device."""
    run = harness.Run(ions_cell(), seed=2**31 + 3, seconds=0.2, trace=False, device="cpu")
    result = run.execute()
    assert result["failed"] == 0 and result["attempted"] >= 1 and result["correct"]
    (inputs,) = ions.inputs
    assert set(inputs) == {"Positions", "Velocities"}
    expected = generate_ions(TINY_IONS, seed=2**31 + 3, device="cpu")
    for name, tensor in expected.items():
        assert inputs[name].device.type == "cpu" and inputs[name].dtype == torch.float32
        assert torch.equal(inputs[name], tensor)


@pytest.mark.parametrize("name", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_a_positions_tensor_is_ingested_as_a_mapping_of_positions(name, tmp_path, port_on_cpu):
    """(c) Every cell of ``BENCHMARK.json`` hands over one tensor; it is
    stored exactly as ``{"Positions": tensor}`` is: Positions alone, the same
    arrays."""
    cell = tiny_cell(name, n_atoms=40, n_frames=3)
    host = cell.generator().generate(cell.config, seed=2**31 + 21, device="cpu").numpy()
    assert isinstance(host, np.ndarray)
    stores = [harness.ingest(str(tmp_path / kind), cell.config, form).store
              for kind, form in (("tensor", host), ("mapping", {"Positions": host}))]
    assert stores[0].summary() == stores[1].summary()
    for species in cell.config["species"]:
        assert stores[0].properties_of(species) == ["Positions"]
        path = f"{species}/Positions"
        np.testing.assert_array_equal(stores[0].load([path])[path], stores[1].load([path])[path])


@pytest.mark.parametrize("form", ["tensor", "mapping"])
def test_the_generated_tensors_are_freed_before_ingest(form, ions, port_on_cpu, monkeypatch):
    """The harness keeps the generator's output on the host alone, so the
    window's device memory is the program's: by ingest no tensor that the
    generator returned is alive. The reference receives the form returned."""
    refs = []

    def generate(config, seed, device):
        generated = generate_ions(config, seed, device)
        refs.extend(weakref.ref(tensor) for tensor in generated.values())
        return generated if form == "mapping" else generated["Positions"]

    monkeypatch.setattr(spec.Cell, "generator", lambda self: types.SimpleNamespace(generate=generate))
    alive_at_ingest = []
    ingest = harness.ingest

    def watched(root, config, properties):
        alive_at_ingest.extend(ref() is not None for ref in refs)
        return ingest(root, config, properties)

    monkeypatch.setattr(harness, "ingest", watched)
    # positions alone feed no GK call: the tensor form runs the Einstein MSD
    traffic = {} if form == "mapping" else {"calculator": "EinsteinDiffusionCoefficients"}
    run = harness.Run(ions_cell(**traffic), seed=2**31 + 9, seconds=0.2, trace=False, device="cpu")
    assert run.execute()["failed"] == 0
    assert alive_at_ingest == [False, False]
    (inputs,) = ions.inputs
    if form == "tensor":
        assert isinstance(inputs, torch.Tensor) and inputs.shape[-1] == 3
    else:
        assert set(inputs) == {"Positions", "Velocities"}
