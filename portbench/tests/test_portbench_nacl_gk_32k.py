"""The configuration ``nacl_gk_32k`` and its two cells,
``nacl_gk_32k.gk_diffusion`` and ``nacl_gk_32k.gk_ionic``: the generator's
sizes and its Ornstein-Uhlenbeck velocities, both plain references against
the port at a tiny size on the CPU, the control, the faults the cells'
limits catch, the frozen ACF count and the reader of ``acf_roofline_pct``;
then, on the card (``cuda``), the control and each planted fault at the
cells' own size, printing each number beside its limit.

The faults: the ACF's sum left unchanged (zeros), the last FFT batch of
windows of each slab left out, half the ions left out with the sum scaled to
all of them, MDSuite's ``+1`` in ``n_windows * (N + 1)`` dropped (a
relative change of 1/16001 = 6.2e-5 at 16000 ions, which ``acf_gap`` has to
catch), and, in the ionic cell, Cl's charge sign flipped in the current.
In the CPU's tiny cells every slab's windows are one FFT batch, so the last
batch left out is the whole slab; at the cells' size it is 5, 5 and 3 of a
species' 101, 101 and 99 slab windows.
The ionic cell's 1501 windows are one batch at any size: its last batch is
all of them, which the sum left unchanged stands for."""

import json
import math

import pytest
import torch

from portbench import control, harness, spec
from portbench.trace import Trace

from conftest import tiny_cell

DIFFUSION, IONIC = "nacl_gk_32k.gk_diffusion", "nacl_gk_32k.gk_ionic"
CELLS = [DIFFUSION, IONIC]
GENERATOR = spec.load_module("configs", "nacl_gk_32k")
ACF = spec.load_module("counts", "acf")
ROOFLINE = spec.load_module("metrics", "acf_roofline_pct")
GK_MODULE = "lammps_analysis_tpu_torch.calculators.green_kubo_diffusion_coefficients"
CORRELATION = "lammps_analysis_tpu_torch.ops.correlation"
#: the tiny cells' windows: 160 frames, range 32 (strides 4 and 1)
TINY_ARGS = {DIFFUSION: dict(data_range=32, correlation_time=4),
             IONIC: dict(data_range=32, correlation_time=1)}


def small(name, **kwargs):
    return tiny_cell(name, n_atoms=128, n_frames=160, **TINY_ARGS[name], **kwargs)


def test_the_configuration_gives_its_sizes():
    config = spec.find_cell(DIFFUSION).config
    assert config["name"] == "nacl_gk_32k" and config["reduced"] == []
    assert list(config["species"].items()) == [("Na", 16000), ("Cl", 16000)]
    assert config["charges"] == {"Na": 1.0, "Cl": -1.0}
    assert config["masses"] == {"Na": 22.98977, "Cl": 35.453}
    assert (config["n_frames"], config["box_length"], config["units"]) == (2000, 104.04, "metal")
    assert (config["timestep"], config["sample_rate"], config["temperature"]) == (0.001, 4, 1400)
    assert config["diffusion_m2_s"] == 1e-8
    assert {"ions", "frames", "dump", "masses", "diffusion", "velocities",
            "positions"} <= set(config["assumed"])
    # the nacl_melt_32k melt: same ions, box and charges
    melt = spec.find_cell("nacl_melt_32k.rdf").config
    for key in ("species", "charges", "box_length", "units", "temperature"):
        assert config[key] == melt[key]
    params = GENERATOR.ion_parameters(config)
    assert params["Na"]["sigma"] ** 2 == pytest.approx(50.63, abs=0.01)
    assert params["Cl"]["sigma"] ** 2 == pytest.approx(32.83, abs=0.01)
    assert params["Na"]["tau"] == pytest.approx(0.01975, abs=1e-5)
    assert params["Cl"]["tau"] == pytest.approx(0.03046, abs=1e-5)
    assert (params["Na"]["phi"], params["Cl"]["phi"]) == (
        pytest.approx(0.8167, abs=1e-4), pytest.approx(0.8769, abs=1e-4))
    # the traffic's windows: 301 a species at range 500, stride 5; 1501 at stride 1
    for name, windows in ((DIFFUSION, 301), (IONIC, 1501)):
        args = spec.find_cell(name).traffic["args"]
        assert (2000 - args["data_range"]) // args["correlation_time"] + 1 == windows


@pytest.mark.parametrize("seed", [5, 2**31 + 11])
def test_the_generator_gives_the_same_sizes_for_any_seed(seed):
    config = dict(spec.find_cell(DIFFUSION).config, n_frames=3)
    out = GENERATOR.generate(config, seed=seed, device="cpu")
    assert list(out) == ["Positions", "Velocities"]
    for array in out.values():
        assert array.shape == (3, 32000, 3) and array.dtype == torch.float32
    pos = out["Positions"]
    assert 0 <= float(pos.min()) and float(pos.max()) < config["box_length"]
    again = GENERATOR.generate(config, seed=seed, device="cpu")
    assert all(torch.equal(out[k], again[k]) for k in out)


def test_ou_velocities_have_their_variance_and_lag_one_correlation():
    """1000 ions of each species over 400 frames: the variance kT/m within
    2 % (7 standard errors of 1.2e6 correlated draws) and the lag-1
    correlation phi within 0.005 (10 standard errors); the positions move by
    v dt a frame under the minimum image."""
    config = dict(spec.find_cell(DIFFUSION).config, n_frames=400,
                  species={"Na": 1000, "Cl": 1000})
    out = GENERATOR.generate(config, seed=2**31 + 3, device="cpu")
    v = out["Velocities"].double()
    params = GENERATOR.ion_parameters(config)
    for name, ions in (("Na", slice(0, 1000)), ("Cl", slice(1000, 2000))):
        x = v[:, ions]
        variance = float((x * x).mean())
        assert variance == pytest.approx(params[name]["sigma"] ** 2, rel=0.02)
        assert float((x[1:] * x[:-1]).mean()) / variance == pytest.approx(
            params[name]["phi"], abs=0.005)
    box = config["box_length"]
    dt = config["timestep"] * config["sample_rate"]
    step = out["Positions"].double().diff(dim=0)
    step -= box * torch.round(step / box)
    assert float((step - v[:-1] * dt).abs().max()) < 1e-4  # float32 positions near the box edge


@pytest.mark.parametrize("name", CELLS)
def test_the_port_agrees_with_the_reference(name, port_on_cpu):
    result = harness.Run(small(name), seed=2**31 + 7, seconds=0.2, trace=False,
                         device="cpu").execute()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    for check in result["checks"].values():
        assert check["value"] < check["limit"] / 10
    assert set(result["metrics"]) == {m["name"] for m in spec.find_cell(name).end_to_end}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_a_test_size(name):
    cell = small(name)
    numbers = control.readings(cell, seed=99, device="cpu")
    assert any(numbers[key] > limit for key, limit in cell.limits.items())


# ------------------------------------------------------------------ faults
def acf_fault(kind):
    """A fault in the windowed ACF every GK calculator runs."""
    from lammps_analysis_tpu_torch.ops import correlation

    real = correlation.windowed_acf_sum

    def broken(x, window, stride, budget_bytes, tau=None):
        if kind == "unchanged":  # the slab adds nothing to the sums
            acf, per_window = real(x, window, stride, budget_bytes, tau=tau)
            return torch.zeros_like(acf), torch.zeros_like(per_window)
        if kind == "half":  # half the ions, the sum scaled to all of them
            half = max(1, x.shape[1] // 2)
            acf, per_window = real(x[:, :half], window, stride, budget_bytes, tau=tau)
            return acf * x.shape[1] / half, per_window
        # the last FFT batch of the slab's windows left out
        n_windows = (x.shape[0] - window) // stride + 1
        chunk = correlation._auto_chunk(x.shape[1], x.shape[2], window, budget_bytes)
        kept = (n_windows - 1) // chunk * chunk
        if kept == 0:
            acf, per_window = real(x, window, stride, budget_bytes, tau=tau)
            return torch.zeros_like(acf), per_window[:0]
        return real(x[:(kept - 1) * stride + window], window, stride, budget_bytes, tau=tau)

    return CORRELATION, "windowed_acf_sum", broken


def no_plus_one_fault():
    """MDSuite's ``n_windows * (N + 1)`` becomes ``n_windows * N``."""
    from lammps_analysis_tpu_torch.calculators.green_kubo_diffusion_coefficients import (
        GreenKuboDiffusionCoefficients as gk,
    )

    real = gk.selected_counts

    def broken(self, species):
        return [n - 1 for n in real(self, species)]

    return f"{GK_MODULE}.GreenKuboDiffusionCoefficients", "selected_counts", broken


def charge_flip_fault():
    """Cl's charge enters the ionic current with its sign flipped."""
    from lammps_analysis_tpu_torch.transformations.flux_transforms import IonicCurrent

    def broken(self, batch, carryover=None):
        return sum(-self.term(p) if sp == "Cl" else self.term(p) for sp, p in batch.items()), None

    return "lammps_analysis_tpu_torch.transformations.flux_transforms.IonicCurrent", \
        "transform_batch", broken


FAULTS = {
    DIFFUSION: {"unchanged": lambda: acf_fault("unchanged"),
                "last_batch": lambda: acf_fault("last"),
                "half_ions": lambda: acf_fault("half"), "no_plus_one": no_plus_one_fault},
    IONIC: {"unchanged": lambda: acf_fault("unchanged"), "charge_flip": charge_flip_fault},
}
PAIRS = [(name, kind) for name in CELLS for kind in sorted(FAULTS[name])]


@pytest.mark.parametrize(("name", "kind"), PAIRS)
def test_a_broken_gk_path_is_not_correct(name, kind, port_on_cpu, monkeypatch):
    cell = small(name)
    run = harness.Run(cell, seed=12345, seconds=0.2, trace=False, device="cpu")
    assert run.execute()["correct"]
    module, attr, broken = FAULTS[name][kind]()
    monkeypatch.setattr(f"{module}.{attr}", broken)
    result = harness.Run(cell, seed=12345, seconds=0.2, trace=False, device="cpu").execute()
    assert not result["correct"], result["checks"]


# ------------------------------------------------------- count and reader
def test_the_acf_count_at_the_cells_size():
    """301 windows x 48000 sequences a species at the padded length 1024:
    7.84e11 operations, 11.7 ms a call, set by the operations."""
    work = dict(sequences=2 * 301 * 48000, fft_len=1024, values_read=2000 * 32000 * 3,
                acf_written=2 * 301 * 500)
    ms, by = ACF.bound(work)
    flops = 2 * 301 * 48000 * (2.5 * 1024 * 10 + 3 * 513)
    assert flops == pytest.approx(7.84e11, rel=1e-3)
    assert (ms, by) == (pytest.approx(flops / 67e12 * 1e3), "operations")
    assert ms == pytest.approx(11.7, abs=0.05)
    # a few windows of one particle: the bytes set it
    ms, by = ACF.bound(dict(sequences=3, fft_len=4, values_read=10**9, acf_written=0))
    assert (ms, by) == (pytest.approx(4e9 / 3.35e12 * 1e3), "bytes")


def test_the_reference_work_is_the_programs_estimator():
    """The work the reference hands the count: the program's windows,
    particles, axes and padded length."""
    cell = small(DIFFUSION)
    inputs = cell.generator().generate(cell.config, seed=1, device="cpu")
    _, work = cell.reference().compute(inputs, cell.config, cell.traffic["args"])
    windows = (160 - 32) // 4 + 1
    assert work == dict(sequences=2 * windows * 64 * 3, fft_len=64, values_read=160 * 128 * 3,
                        acf_written=2 * windows * 32)


def _trace(*device):
    return Trace(n_calls=2, window=(0.0, 1000.0), launches=0, device=sorted(device))


def test_acf_roofline_pct_of_hand_built_traces():
    work = dict(sequences=10**6, fft_len=1024, values_read=0, acf_written=0)
    ms, _ = ACF.bound(work)
    # copies and fills only: nothing to read
    assert ROOFLINE.read(_trace((0.0, 500.0, "Memcpy HtoD (Pinned -> Device)"),
                                (600.0, 700.0, "Memset (Device)")), {"work": work}) is None
    # every other kernel counts, clipped to the window; two calls
    ctx = {"work": work}
    trace = _trace((0.0, 300.0, "void vector_fft<256u, EPT<8u>>(...)"),
                   (300.0, 400.0, "reduce_kernel<512, 1>"),
                   (900.0, 1100.0, "void regular_fft<512u>(...)"),
                   (400.0, 450.0, "Memcpy DtoH (Device -> Pageable)"))
    assert ROOFLINE.read(trace, ctx) == pytest.approx(100.0 * ms * 2 * 1e3 / 500.0)
    assert ctx["bound_by"] == {"acf": "operations"}


# --------------------------------------------------------- at the cells' size
def fails(cell, numbers) -> bool:
    return any(numbers[name] > limit for name, limit in cell.limits.items())


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the runs are at the cells' own size")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(name, card):
    cell = spec.find_cell(name)
    for seed in (31, 32, 33):
        numbers = control.readings(cell, seed=seed, device="cuda")
        print(json.dumps({"cell": name, "control": control.CONTROL_DTYPE, "seed": seed,
                          "numbers": numbers, "limits": cell.limits}))
        assert fails(cell, numbers)


@pytest.mark.cuda
@pytest.mark.parametrize(("name", "kind"), PAIRS)
def test_a_broken_gk_path_is_not_correct_at_the_cells_size(name, kind, card, monkeypatch):
    module, attr, broken = FAULTS[name][kind]()
    monkeypatch.setattr(f"{module}.{attr}", broken)
    results = {seed: harness.Run(spec.find_cell(name), seed=seed, seconds=1.0,
                                 trace=False).execute() for seed in (41, 42, 43)}
    for seed, result in results.items():
        print(json.dumps({"cell": name, "fault": kind, "seed": seed, "checks": result["checks"]}))
    assert not any(result["correct"] for result in results.values())


@pytest.mark.cuda
def test_the_nernst_einstein_values_at_the_cells_size(card):
    """The D each species gets from the plain reference against the assumed
    1e-8 m^2/s, and sigma against Nernst-Einstein's e^2 sum_i D_i / (V k T)
    (about 377 S/m), printed: they check the generator and the prefactor's
    units. D's discrete-time OU integral over a 2 ps window is within 2 %;
    sigma's integral at 8 ps is noise-dominated and is only printed."""
    cell = spec.find_cell(DIFFUSION)
    inputs = cell.generator().generate(cell.config, seed=51, device="cuda")
    answer, _ = cell.reference().compute(inputs, cell.config, cell.traffic["args"])
    ionic = spec.find_cell(IONIC)
    sigma, _ = ionic.reference().compute(inputs, ionic.config, ionic.traffic["args"])
    config = cell.config
    volume = config["box_length"] ** 3 * 1e-30
    nernst = (1.602176634e-19 ** 2 * sum(config["species"].values()) * config["diffusion_m2_s"]
              / (volume * 1.380649e-23 * config["temperature"]))
    d = {name: float(answer[name]["diffusion_coefficient"][0]) for name in answer}
    print(json.dumps({"D": d, "sigma": float(sigma["System"]["ionic_conductivity"][0]),
                      "sigma_sem": float(sigma["System"]["uncertainty"][0]),
                      "nernst_einstein": nernst}))
    assert nernst == pytest.approx(377, rel=0.01)
    for value in d.values():
        assert math.isclose(value, config["diffusion_m2_s"], rel_tol=0.02)
