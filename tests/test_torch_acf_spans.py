"""The spans and counters of the Green-Kubo path (``utils/profiling.py``):
``acf.batch`` and ``acf.windows``/``acf.batches``/``acf.sequences`` in
``ops/correlation.py::windowed_acf_sum``, ``gk.integrate`` in the GK
calculators, ``trafo.<Name>`` and ``trafo.frames`` in the transformation
runner, for a GK diffusion call and a GK ionic-conductivity call at a small
size on the CPU. Every count is exact. Also ``correlation.to_host``, the GK
calculators' fetch of the ACF sums: on the card (``cuda``) through
page-locked memory."""

import numpy as np
import pytest
import torch

import lammps_analysis_tpu_torch as lt
from lammps_analysis_tpu_torch.calculators.base import window_aligned_slabs
from lammps_analysis_tpu_torch.database import SpeciesInfo, TrajectoryChunkData, TrajectoryMetadata
from lammps_analysis_tpu_torch.database.properties import PropertyInfo
from lammps_analysis_tpu_torch.file_io import ScriptInput
from lammps_analysis_tpu_torch.memory.planner import BatchPlanner
from lammps_analysis_tpu_torch.ops import correlation
from lammps_analysis_tpu_torch.utils import profiling
from lammps_analysis_tpu_torch.utils.config import config

N_IONS, N_FRAMES, BOX = 64, 160, 12.0
DATA_RANGE, CORRELATION_TIME = 32, 4
ARGS = {"data_range": DATA_RANGE, "correlation_time": CORRELATION_TIME}
#: a planner budget whose slab holds 64 frames of one species' velocities
#: (64 ions x 3 x 8 bytes a frame, GK diffusion's scale factor 150)
BUDGET = 64 * 150 * N_IONS * 3 * 8
#: the stream's window-aligned slabs at that budget, and their windows
SLABS = [(0, 64), (36, 100), (72, 136), (108, 160)]
SLAB_WINDOWS = [9, 9, 9, 6]
#: windows of the whole trajectory: (160 - 32) // 4 + 1
N_WINDOWS = 33


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def _experiment(root):
    rng = np.random.default_rng(11)
    data = {"Positions": rng.uniform(0, BOX, size=(N_FRAMES, 2 * N_IONS, 3)),
            "Velocities": rng.normal(size=(N_FRAMES, 2 * N_IONS, 3))}
    props = [PropertyInfo(name, 3) for name in data]
    species = [SpeciesInfo("Na", N_IONS, props), SpeciesInfo("Cl", N_IONS, props)]
    meta = TrajectoryMetadata(n_configurations=N_FRAMES, species_list=species,
                              box_l=[BOX] * 3, sample_rate=4)
    chunk = TrajectoryChunkData(species, N_FRAMES)
    for i, name in enumerate(["Na", "Cl"]):
        for prop, array in data.items():
            chunk.add_data(array[:, i * N_IONS:(i + 1) * N_IONS], 0, name, prop)
    project = lt.Project(name="acf_spans", storage_path=root)
    exp = project.add_experiment("e", timestep=0.001, temperature=1400.0, units="metal",
                                 simulation_data=ScriptInput(chunk, meta, "d"))
    exp.set_charge("Na", 1.0)
    exp.set_charge("Cl", -1.0)
    exp.planner = BatchPlanner(memory_budget_bytes=BUDGET)
    return exp


def _traced(call):
    """``(spans by name, counter deltas)`` of ``call()`` under ``tracing()``."""
    before = profiling.counters.copy()
    with profiling.tracing() as log:
        call()
    names = {}
    for span in log:
        names[span.name] = names.get(span.name, 0) + 1
    return names, profiling.counters - before, log


def test_the_planned_stream_is_four_slabs_of_one_batch_each():
    """The sizes the counts below rest on, from the program's own plans."""
    assert window_aligned_slabs(N_FRAMES, 64, DATA_RANGE, CORRELATION_TIME) == SLABS
    assert [(b - a - DATA_RANGE) // CORRELATION_TIME + 1 for a, b in SLABS] == SLAB_WINDOWS
    assert sum(SLAB_WINDOWS) == N_WINDOWS == BatchPlanner.window_plan(
        N_FRAMES, DATA_RANGE, CORRELATION_TIME)
    assert BatchPlanner(BUDGET).plan(N_FRAMES, N_IONS * 3 * 8, {"linear": {"scale_factor": 150}},
                                     DATA_RANGE).frame_batch == 64
    # 75 windows a batch: each slab's windows are one batch
    assert correlation._auto_chunk(N_IONS, 3, DATA_RANGE, BUDGET) == 75


def test_windowed_acf_sum_counts_its_batches():
    """One call whose budget holds 8 windows a batch: 33 windows in 5 batches."""
    x = torch.randn((N_FRAMES, N_IONS, 3), generator=torch.Generator().manual_seed(3))
    budget = 8 * N_IONS * 3 * 64 * 16  # 8 windows of the padded length 64
    assert correlation._auto_chunk(N_IONS, 3, DATA_RANGE, budget) == 8
    names, delta, _ = _traced(lambda: correlation.windowed_acf_sum(
        x, DATA_RANGE, CORRELATION_TIME, budget))
    assert names == {"acf.batch": 5}
    assert (delta["acf.windows"], delta["acf.batches"], delta["acf.sequences"]) == (
        33, 5, 33 * N_IONS * 3)


def test_gk_diffusion_call_spans_and_counters(tmp_path):
    """A forced GK diffusion call over both species: each species' stream of
    4 slabs runs 4 FFT batches, and each species integrates once."""
    exp = _experiment(tmp_path)
    names, delta, log = _traced(lambda: exp.run.GreenKuboDiffusionCoefficients(
        plot=False, force=True, **ARGS))
    assert delta["acf.windows"] == 2 * N_WINDOWS == 66
    assert delta["acf.batches"] == 2 * len(SLABS) == 8
    assert delta["acf.sequences"] == 2 * N_WINDOWS * N_IONS * 3 == 12672
    assert delta["trafo.frames"] == 0
    assert (names["call"], names["deps"], names["acf.batch"], names["gk.integrate"]) == (1, 2, 8, 2)
    assert not [name for name in names if name.startswith("trafo.")]
    (call,) = [s for s in log if s.name == "call"]
    assert all(s.call == call.id for s in log if s.name in ("acf.batch", "gk.integrate"))


def test_gk_ionic_runs_its_transformation_in_the_first_call_alone(tmp_path):
    """The first call runs ``IonicCurrent`` once over the 160 frames, then
    the ACF of the stored series (one slab, one batch); a forced call finds
    the series stored and runs the ACF alone."""
    exp = _experiment(tmp_path)
    first, delta, _ = _traced(lambda: exp.run.GreenKuboIonicConductivity(plot=False, **ARGS))
    assert first["trafo.IonicCurrent"] == 1
    assert delta["trafo.frames"] == N_FRAMES == 160
    assert (delta["acf.windows"], delta["acf.batches"], delta["acf.sequences"]) == (33, 1, 33 * 3)
    assert (first["call"], first["deps"], first["acf.batch"], first["gk.integrate"]) == (1, 1, 1, 1)

    forced, delta, _ = _traced(lambda: exp.run.GreenKuboIonicConductivity(
        plot=False, force=True, **ARGS))
    assert not [name for name in forced if name.startswith("trafo.")]
    assert delta["trafo.frames"] == 0
    assert (delta["acf.windows"], delta["acf.batches"], delta["acf.sequences"]) == (33, 1, 33 * 3)
    assert (forced["call"], forced["deps"], forced["acf.batch"], forced["gk.integrate"]) == (
        1, 1, 1, 1)


def test_to_host_returns_the_tensors_as_numpy_arrays():
    """On the CPU the tensors' own memory, as ``.cpu().numpy()`` gives it."""
    a, b = torch.arange(6.0).reshape(2, 3), torch.ones(4, dtype=torch.float64)
    out = correlation.to_host(a, b)
    assert [type(x) for x in out] == [np.ndarray, np.ndarray]
    np.testing.assert_array_equal(out[0], a.numpy())
    np.testing.assert_array_equal(out[1], b.numpy())
    assert correlation.to_host() == []


@pytest.mark.cuda
def test_to_host_copies_from_the_card_through_page_locked_memory():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the copy is from the device")
    x = torch.randn((1501, 500), dtype=torch.float64, device="cuda")
    s = x.sum(0)
    host_s, host_x = correlation.to_host(s, x)
    np.testing.assert_array_equal(host_x, x.cpu().numpy())
    np.testing.assert_array_equal(host_s, s.cpu().numpy())
    assert host_x.dtype == np.float64 and host_x.shape == (1501, 500)
    assert torch.from_numpy(host_x).is_pinned()
