"""The cell ``nacl_melt_32k.rdf``: its configuration, the port against the
plain reference at a tiny size on the CPU (one frame batch, and a budget cut
so that the RDF streams four), the faults its limits catch, and the
per-layer reader it brings (``h2d_hidden_pct``); then, on the card
(``cuda``), the control and each planted fault at the cell's own size.

Two faults are the cell's own: the stream's last frame batch left out, and
the ``Na_Cl`` row added into the ``Na_Na`` row. The others are those of
``test_portbench_faults.py``. At the cell's size the three seeds' plain
reference is worked out once and judges every fault's run.

The limits sit between the program's float32 readings and the least fault
reading: half of the frames left out with the rest scaled reads a ``g_l1``
of 1.5e-3 at the cell's size (500 frames of one ideal-gas g(r)), some 15
times the program's, and ``g_l1``'s limit lies near the geometric middle of
the two. ``cdf_gap``'s limit stays above one count's flip in the CPU's
tiny cell (4e-6 of its pairs) and catches the fullest bin doubled."""

import dataclasses
import json
import math
import types

import pytest
import torch

from portbench import control, harness, spec
from portbench.trace import Trace

from conftest import tiny_cell
from test_portbench_faults import KINDS, RDF_MODULE, rdf_fault

NAME = "nacl_melt_32k.rdf"
RDF = spec.load_module("reference", "radial_distribution_function")
H2D = spec.load_module("metrics", "h2d_hidden_pct")

#: molten NaCl at 1400 K by Janz's fit (NSRDS-NBS 15): g/cm^3, then ions/A^3
JANZ_G_CM3 = 2.139 - 0.543e-3 * 1400
NACL_G_MOL = 58.443
AVOGADRO = 6.02214076e23
JANZ_IONS_A3 = 2 * JANZ_G_CM3 / NACL_G_MOL * AVOGADRO / 1e24

#: the port's host budget for a stream of four batches at ``tiny_cell``'s
#: 200 ions: the RDF's quarter of it holds 25 of the 100 frames
STREAM_BUDGET_BYTES = 6.2e7


def test_the_configuration_gives_its_sizes():
    cell = spec.find_cell(NAME)
    config = cell.config
    assert config["name"] == "nacl_melt_32k" and config["reduced"] == []
    assert list(config["species"].items()) == [("Na", 16000), ("Cl", 16000)]
    assert config["charges"] == {"Na": 1.0, "Cl": -1.0}
    assert (config["n_frames"], config["box_length"]) == (500, 104.04)
    assert (config["units"], config["timestep"], config["sample_rate"],
            config["temperature"]) == ("metal", 0.002, 100, 1400)
    # every MDSuite default: all 500 frames, cutoff box/2 - 0.1, 0.01 A bins
    args = RDF.resolve_args(cell.traffic["args"], config)
    assert len(args["frames"]) == 500 and args["cutoff"] == pytest.approx(51.92)
    assert args["n_bins"] == 5192
    # the walk's step is sqrt(2 D dt) for D = 1e-8 m^2/s over 0.2 ps, in A
    dt_s = config["timestep"] * config["sample_rate"] * config["time_s"]
    assert config["walk_sigma"] == pytest.approx(math.sqrt(2 * 1e-8 * dt_s) / 1e-10, rel=0.01)
    assert {"ions", "frames", "diffusion", "walk", "positions"} <= set(config["assumed"])
    small = tiny_cell(NAME, n_atoms=200, n_frames=3)
    positions = small.generator().generate(small.config, seed=2**31 + 11, device="cpu")
    assert positions.shape == (3, 200, 3) and positions.dtype == torch.float32
    assert 0 <= float(positions.min()) and float(positions.max()) < small.config["box_length"]


def test_the_density_is_janz_s_at_1400_k():
    config = spec.find_cell(NAME).config
    density = sum(config["species"].values()) / config["box_length"] ** 3
    assert JANZ_IONS_A3 == pytest.approx(0.02841, rel=5e-4)
    assert density == pytest.approx(0.02841, rel=5e-3)


def test_species_order_and_charges_come_through_ingest(tmp_path, port_on_cpu):
    cell = tiny_cell(NAME, n_atoms=40, n_frames=2)
    positions = cell.generator().generate(cell.config, seed=5, device="cpu").numpy()
    exp = harness.ingest(str(tmp_path), cell.config, positions)
    assert list(exp.species) == ["Na", "Cl"]
    assert [exp.species[s].n_particles for s in exp.species] == [20, 20]
    assert {s: exp.species[s].charge for s in exp.species} == {"Na": 1.0, "Cl": -1.0}


def _stream(monkeypatch):
    """The port's host budget cut to ``STREAM_BUDGET_BYTES``."""
    import os

    import lammps_analysis_tpu_torch as lt

    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    monkeypatch.setattr(lt.config, "memory_fraction", STREAM_BUDGET_BYTES / host)


def _run(seed=2**31 + 7):
    """A run of the cell at ``tiny_cell``'s size on the CPU, with the frame
    batches each computing call dispatched."""
    from lammps_analysis_tpu_torch.utils import profiling

    before = profiling.counters["rdf.batches"]
    result = harness.Run(tiny_cell(NAME), seed=seed, seconds=0.2, trace=False,
                         device="cpu").execute()
    # the first call, the warm calls and the window's; the stored answer is a cache hit
    calls = 1 + harness.WARMUP_CALLS + result["attempted"]
    batches = profiling.counters["rdf.batches"] - before
    assert batches % calls == 0
    return result, batches // calls


@pytest.mark.parametrize("stream", [False, True], ids=["one-batch", "four-batches"])
def test_the_port_agrees_with_the_reference(stream, port_on_cpu, monkeypatch):
    if stream:
        _stream(monkeypatch)
    result, batches = _run()
    assert batches == (4 if stream else 1)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    for check in result["checks"].values():
        assert check["value"] < check["limit"] / 4
    assert set(result["metrics"]) == {m["name"] for m in spec.find_cell(NAME).end_to_end}


def test_the_control_fails_at_a_test_size():
    cell = tiny_cell(NAME, n_atoms=400, n_frames=100)
    numbers = control.readings(cell, seed=99, device="cpu")
    assert any(numbers[name] > limit for name, limit in cell.limits.items())


def last_batch_fault():
    """The stream's last frame batch never reaches the kernel."""
    from lammps_analysis_tpu_torch.pipeline.prefetch import prefetch_to_device

    def broken(load_fn, items, *args, **kwargs):
        return prefetch_to_device(load_fn, list(items)[:-1], *args, **kwargs)

    return RDF_MODULE, "prefetch_to_device", broken


def mixed_rows_fault():
    """Each batch's ``Na_Cl`` row is added into its ``Na_Na`` row."""
    from lammps_analysis_tpu_torch.parallel.sharded_ops import sharded_rdf_histogram

    def broken(positions, *args):
        h = sharded_rdf_histogram(positions, *args)
        h[0] += h[1]
        return h

    return RDF_MODULE, "sharded_rdf_histogram", broken


FAULTS = {kind: (lambda kind=kind: rdf_fault(kind)) for kind in KINDS}
FAULTS.update({"last_batch": last_batch_fault, "mixed_rows": mixed_rows_fault})


@pytest.mark.parametrize("kind", sorted(FAULTS))
def test_a_broken_stream_is_not_correct(kind, port_on_cpu, monkeypatch):
    """Each fault, in a stream of four batches at a tiny size."""
    _stream(monkeypatch)
    assert _run()[0]["correct"]
    module, attr, broken = FAULTS[kind]()
    monkeypatch.setattr(f"{module}.{attr}", broken)
    result, _ = _run()
    assert not result["correct"], result["checks"]


def _trace(*device):
    return Trace(n_calls=2, window=(0.0, 1000.0), launches=0, device=sorted(device))


def test_h2d_hidden_pct_of_hand_built_traces():
    kernel = "void (anonymous namespace)::rdf_histogram_kernel<1>(float const*)"
    copy = "Memcpy HtoD (Pinned -> Device)"
    # no host-to-device copy: nothing to read
    assert H2D.read(_trace((0.0, 500.0, kernel), (600.0, 610.0, "Memcpy DtoH (Device -> Pageable)"),
                           (700.0, 710.0, "Memset (Device)")), {}) is None
    # the first batch's copy before any kernel, the next under the kernel
    trace = _trace((0.0, 100.0, copy), (100.0, 600.0, kernel), (200.0, 300.0, copy))
    assert H2D.read(trace, {}) == pytest.approx(50.0)
    # half of a copy under a kernel; a fill and a copy the other way hide nothing
    trace = _trace((100.0, 200.0, kernel), (150.0, 250.0, copy), (200.0, 260.0, "Memset (Device)"),
                   (210.0, 230.0, "Memcpy DtoH (Device -> Pinned)"))
    assert H2D.read(trace, {}) == pytest.approx(50.0)
    # two kernels over one copy count its time once; the window clips
    trace = _trace((900.0, 1100.0, copy), (850.0, 1000.0, kernel), (950.0, 1050.0, "elementwise"))
    assert H2D.read(trace, {}) == pytest.approx(100.0)


# ------------------------------------------------------------ at the cell's size
SEEDS = (41, 42, 43)


@dataclasses.dataclass
class CachedCell(spec.Cell):
    """The cell whose plain reference keeps its answer for each precision:
    the runs of one seed share it."""

    answers: dict = dataclasses.field(default_factory=dict)

    def reference(self):
        module = super().reference()

        def compute(positions, config, args, dtype=torch.float64):
            if dtype not in self.answers:
                self.answers[dtype] = module.compute(positions, config, args, dtype)
            return self.answers[dtype]

        return types.SimpleNamespace(compute=compute, judge=module.judge)


@pytest.fixture(scope="module")
def at_size():
    """One cell a seed, each with its own reference answers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the runs are at the cell's own size")
    cell = spec.find_cell(NAME)
    return {seed: CachedCell(**vars(cell)) for seed in SEEDS}


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size(at_size):
    for seed, cell in at_size.items():
        numbers = control.readings(cell, seed=seed, device="cuda")
        print(json.dumps({"cell": NAME, "control": control.CONTROL_DTYPE, "seed": seed,
                          "numbers": numbers, "limits": cell.limits}))
        assert any(numbers[name] > limit for name, limit in cell.limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(FAULTS))
def test_a_broken_stream_is_not_correct_at_the_cells_size(kind, at_size, monkeypatch):
    module, attr, broken = FAULTS[kind]()
    monkeypatch.setattr(f"{module}.{attr}", broken)
    results = {seed: harness.Run(cell, seed=seed, seconds=1.0, trace=False).execute()
               for seed, cell in at_size.items()}
    for seed, result in results.items():
        print(json.dumps({"cell": NAME, "fault": kind, "seed": seed, "checks": result["checks"]}))
    assert not any(result["correct"] for result in results.values())
