"""Each plain reference on hand-worked cases, and against the port at a
tiny size on the CPU (the whole run: store, pipeline, the port's plain
kernel versions, normalisation, the results DB)."""

import math

import numpy as np
import pytest
import torch

from portbench import harness, spec

from conftest import tiny_cell

RDF = spec.load_module("reference", "radial_distribution_function")
ADF = spec.load_module("reference", "angular_distribution_function")
EINSTEIN = spec.load_module("reference", "einstein_diffusion_coefficients")


def config(species, box, n_frames, **extra):
    return dict(species=species, box_length=box, n_frames=n_frames, length_m=1e-10,
                time_s=1e-12, timestep=0.002, sample_rate=100, **extra)


def test_rdf_counts_a_pair_under_the_minimum_image():
    cfg = config({"A": 2}, 10.0, 1)
    pos = torch.tensor([[[0.5, 1.0, 1.0], [9.5, 1.0, 1.0]]])  # 1 A apart across the seam
    answer, work = RDF.compute(pos, cfg, {})
    n_bins = int((10.0 / 2 - 0.1) / 0.01)
    assert work["counts"].sum() == 1 and work["counts"][0, int(1.0 * n_bins / 4.9)] == 1
    edges = np.linspace(0, 4.9, n_bins)
    b = int(1.0 * n_bins / 4.9)
    # MDSuite's g: 2 (one species) / (frames * rho * N * 4 pi r^2 dr), r the bin's edge
    expected = 2.0 / (1 * (2 / 1000) * 2 * 4 * math.pi * edges[b] ** 2 * 4.9 / n_bins)
    assert answer["A_A"]["y"][b] == pytest.approx(expected)
    assert answer["A_A"]["x"][-1] == pytest.approx(0.49)


def test_adf_bins_the_angles_of_an_l_shape():
    cfg = config({"A": 3}, 20.0, 2)
    frame = torch.tensor([[5.0, 5.0, 5.0], [6.0, 5.0, 5.0], [5.0, 6.0, 5.0]])
    pos = torch.stack([frame, frame])
    answer, work = ADF.compute(pos, cfg, {"number_of_configurations": 1, "cutoff": 1.5})
    adf = answer["A_A_A"]["adf"]
    # 90 degrees at the corner (weight 2 x 1), 45 at each end (2 x (1/sqrt 2)^4 each)
    assert np.nonzero(adf)[0].tolist() == [124, 249]
    assert adf[249] / adf[124] == pytest.approx(2.0)
    assert adf.sum() * 3.15 / 500 == pytest.approx(1.0)  # one batch, normalised
    assert work["max_count"] == 2 and work["angles"] == 3 and work["kept"] == 6


def test_einstein_unwraps_and_counts_windows_as_mdsuite():
    cfg = config({"A": 1}, 10.0, 30)
    x = torch.arange(30, dtype=torch.float32) % 10  # +1 A a frame, wrapped
    pos = torch.stack([x, torch.zeros(30), torch.zeros(30)], -1)[:, None, :]
    answer, _ = EINSTEIN.compute(pos, cfg, {"data_range": 5, "correlation_time": 5})
    tau = np.arange(5)
    # 6 windows, each tau^2; MDSuite divides by windows * (atoms + 1)
    np.testing.assert_allclose(answer["A"]["msd"], 6 * tau**2 / (6 * 2) * 1e-20)
    np.testing.assert_allclose(answer["A"]["time"], tau * 0.002 * 100 * 1e-12)


CELLS = ["lj_melt_32k.rdf", "lj_melt_32k.adf", "lj_melt_32k.einstein"]


@pytest.mark.parametrize("name", CELLS)
def test_the_port_agrees_with_the_reference(name, port_on_cpu):
    result = harness.Run(tiny_cell(name), seed=2**31 + 7, seconds=0.2, trace=False,
                         device="cpu").execute()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    for check in result["checks"].values():
        assert check["value"] < check["limit"] / 10
    assert set(result["metrics"]) == {m["name"] for m in spec.find_cell(name).end_to_end}
