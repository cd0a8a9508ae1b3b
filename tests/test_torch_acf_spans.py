"""The spans and counters of the Green-Kubo path (``utils/profiling.py``):
``acf.batch`` and ``acf.windows``/``acf.batches``/``acf.sequences`` in
``ops/correlation.py::windowed_acf_sum``, ``gk.integrate`` in the GK
calculators, ``trafo.<Name>`` and ``trafo.frames`` in the transformation
runner, for a GK diffusion call and a GK ionic-conductivity call at a small
size on the CPU. Every count is exact. Also ``correlation.to_host``, the GK
calculators' fetch of the ACF sums: on the card (``cuda``) through
page-locked memory. And the three steps of an FFT batch on the CPU: the
plain pack, ``torch.fft.rfft`` and the plain power sum compose to the
windowed ACF's torch loop as it was before the card's kernels
(``csrc/acf_power.cu``) took its pack and power sum, bit for bit; the plain
power sum counts ``acf.plain`` once a batch; the power sum's split
(``power_split``) and the checks on the kernels' inputs."""

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


def _loop_as_it_was(x, window, stride, budget_bytes, tau=None):
    """The oracle: ``windowed_acf_sum``'s batch loop before the pack and the
    power sum were split out (strided view, ``index_select``, ``rfft`` with
    its own padding, ``square_``, float64 ``sum``)."""
    total, n_particles, n_dims = x.shape
    r = window if tau is None else len(tau)
    n_windows = (total - window) // stride + 1
    chunk = correlation._auto_chunk(n_particles, n_dims, r, budget_bytes)
    fft_len = correlation._next_fast_len(2 * r)
    windows = x.unfold(0, window, stride)
    tau_idx = None if tau is None else torch.as_tensor(tau, dtype=torch.long)
    acf_sum = torch.zeros(r, dtype=torch.float64)
    per_window = []
    for c0 in range(0, n_windows, chunk):
        seg = windows[c0 : c0 + chunk]
        if tau_idx is not None:
            seg = seg.index_select(-1, tau_idx)
        f = torch.view_as_real(torch.fft.rfft(seg, n=fft_len, dim=-1))
        power = torch.sum(f.square_(), dim=(1, 2, 4), dtype=torch.float64)
        acf = torch.fft.irfft(power, n=fft_len, dim=-1)[:, :r] / r
        acf_sum += acf.sum(0)
        per_window.append(acf / n_particles)
    return acf_sum, torch.cat(per_window)


#: (frames, particles, components, window, stride, windows a batch, lags):
#: ragged last batches, one batch, a lag table, a system series, float64
ACF_LOOPS = {
    "ragged": (160, 64, 3, 32, 4, 8, None),
    "one_batch": (160, 64, 3, 32, 4, 75, None),
    "tau": (300, 7, 3, 50, 3, 5, [0, 1, 2, 5, 9, 20, 33, 49]),
    "series": (2000, 1, 3, 500, 1, 5461, None),
    "series_tau": (2000, 1, 3, 500, 1, 5461, list(range(0, 500, 7))),
    "gk_d_batch": (700, 40, 3, 500, 5, 32, None),
    "float64": (120, 5, 2, 20, 3, 4, [0, 3, 19]),
}


@pytest.mark.parametrize("case", list(ACF_LOOPS))
def test_plain_pack_fft_and_power_compose_to_the_loop(case):
    frames, particles, dims, window, stride, per_batch, tau = ACF_LOOPS[case]
    dtype = torch.float64 if case == "float64" else torch.float32
    x = torch.randn((frames, particles, dims), dtype=dtype,
                    generator=torch.Generator().manual_seed(frames + particles))
    r = window if tau is None else len(tau)
    budget = per_batch * particles * dims * correlation._next_fast_len(2 * r) * 16
    expect_sum, expect_windows = _loop_as_it_was(x, window, stride, budget, tau)
    got_sum, got_windows = correlation.windowed_acf_sum(x, window, stride, budget, tau=tau)
    scale = float(expect_sum[0])
    torch.testing.assert_close(got_sum, expect_sum, rtol=0, atol=1e-7 * scale)
    torch.testing.assert_close(got_windows, expect_windows, rtol=0,
                               atol=1e-7 * float(expect_windows[:, 0].max()))
    assert torch.equal(got_sum, expect_sum) and torch.equal(got_windows, expect_windows)


def test_plain_power_sum_counts_the_batches_on_a_cpu_tensor():
    """33 windows in 5 batches on the CPU: five plain batches, no launch."""
    x = torch.randn((N_FRAMES, N_IONS, 3), generator=torch.Generator().manual_seed(4))
    budget = 8 * N_IONS * 3 * 64 * 16
    _, delta, _ = _traced(lambda: correlation.windowed_acf_sum(
        x, DATA_RANGE, CORRELATION_TIME, budget))
    assert delta["acf.batches"] == delta["acf.plain"] == 5
    assert delta["acf.pack.launches"] == delta["acf.power.launches"] == 0


@pytest.mark.parametrize("tau", [None, [0, 4, 7, 31]], ids=["lags", "tau"])
def test_plain_pack_into_a_reused_buffer_keeps_its_zero_tail(tau):
    """The first batch's buffer holds a later, ragged batch: its windows'
    values are written, its tail keeps the first call's zeros, and it
    equals a freshly padded batch."""
    x = torch.randn((N_FRAMES, N_IONS, 3), generator=torch.Generator().manual_seed(6))
    lags = None if tau is None else correlation.lag_table(tau, DATA_RANGE, "cpu")
    r = DATA_RANGE if tau is None else len(tau)
    fft_len = correlation._next_fast_len(2 * r)
    buf = correlation.acf_pack(x, DATA_RANGE, CORRELATION_TIME, 0, 20, fft_len, lags)
    assert buf.shape == (20, N_IONS * 3, fft_len) and not bool(buf[..., r:].any())
    later = correlation.acf_pack(x, DATA_RANGE, CORRELATION_TIME, 20, 13, fft_len, lags, out=buf)
    assert later.data_ptr() == buf.data_ptr() and later.shape[0] == 13
    fresh = correlation.acf_pack_reference(x, DATA_RANGE, CORRELATION_TIME, 20, 13, fft_len, lags)
    assert torch.equal(later, fresh)
    windows = x.unfold(0, DATA_RANGE, CORRELATION_TIME)[20:33]
    seg = windows if tau is None else windows[..., tau]
    assert torch.equal(later.view(13, N_IONS, 3, fft_len)[..., :r], seg)


#: (windows, sequences, bins, SMs) -> (chunks, rows): many chunks a window for
#: GK self-diffusion's batch, one for a system series, and between
POWER_SPLITS = [
    ((32, 48000, 513, 132), (132, 364)),
    ((5, 48000, 513, 132), (750, 64)),
    ((1501, 3, 513, 132), (1, 3)),
    ((1, 100, 513, 132), (1, 100)),
    ((5, 333, 129, 132), (5, 67)),
    ((2, 10**6, 16385, 132), (82, 12196)),
]


@pytest.mark.parametrize("shape, split", POWER_SPLITS, ids=lambda v: "x".join(map(str, v)))
def test_power_split_adapts_to_the_shape(shape, split):
    n_windows, n_seq, _, _ = shape
    chunks, rows = correlation.power_split(*shape)
    assert (chunks, rows) == split
    assert (chunks - 1) * rows < n_seq <= chunks * rows
    assert rows >= min(correlation.POWER_MIN_ROWS, n_seq)


@pytest.mark.parametrize("tau", [[-1, 3], [0, 32], [40]], ids=["negative", "window", "past"])
def test_lag_table_rejects_lags_outside_the_window(tau):
    with pytest.raises(ValueError, match=r"\[0, 32\)"):
        correlation.lag_table(tau, DATA_RANGE, "cpu")
    with pytest.raises(ValueError):
        correlation.windowed_acf_sum(torch.zeros((N_FRAMES, 2, 3)), DATA_RANGE, 4, 1 << 20, tau=tau)


def _bad_pack_args():
    x = torch.zeros((100, 4, 3))
    return {
        "integer_x": ((x.long(), 32, 4, 0, 2, 64), TypeError),
        "past_the_frames": ((x, 32, 4, 11, 8, 64), ValueError),
        "short_fft": ((x, 32, 4, 0, 2, 16), ValueError),
        "out_shape": ((x, 32, 4, 0, 2, 64, None, torch.zeros((2, 11, 64))), ValueError),
        "out_windows": ((x, 32, 4, 0, 3, 64, None, torch.zeros((2, 12, 64))), ValueError),
        "out_dtype": ((x, 32, 4, 0, 2, 64, None, torch.zeros((2, 12, 64), dtype=torch.float64)),
                      ValueError),
        "lags_2d": ((x, 32, 4, 0, 2, 64, torch.zeros((2, 2), dtype=torch.int32)), ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_pack_args()))
def test_acf_pack_rejects_bad_inputs(case):
    args, error = _bad_pack_args()[case]
    with pytest.raises(error):
        correlation.acf_pack(*args)


@pytest.mark.parametrize("spec, error", [
    (torch.zeros((2, 3, 5)), TypeError),
    (torch.zeros((2, 3), dtype=torch.complex64), TypeError),
    (torch.zeros((2, 5, 3), dtype=torch.complex64).transpose(1, 2), ValueError),
], ids=["real", "2d", "strided"])
def test_acf_power_sum_rejects_bad_inputs(spec, error):
    with pytest.raises(error):
        correlation.acf_power_sum(spec)
