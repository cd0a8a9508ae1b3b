"""Cells, configurations, traffic, limits and readers are found by name."""

import json

import pytest

from portbench import harness, spec


def test_every_cell_resolves_by_name():
    bench = spec.load_benchmark()
    for entry in bench["workloads"]:
        cell = spec.find_cell(entry["name"], bench)
        assert cell.config["name"] == entry["config"]
        assert callable(cell.generator().generate)
        reference = cell.reference()
        assert callable(reference.compute) and callable(reference.judge)
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        for metric in cell.per_layer:
            assert callable(spec.load_module("metrics", metric["name"]).read)
        names = {m["name"] for m in cell.end_to_end}
        assert {"device_ms_per_call", "peak_device_MiB", "setup_s"} <= names


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.find_cell("no_such_cell")


def test_metric_workloads_select_cells():
    assert spec.applies({"name": "m"}, "any.cell")
    assert spec.applies({"name": "m", "workloads": ["a.b"]}, "a.b")
    assert not spec.applies({"name": "m", "workloads": ["a.b"]}, "c.d")
    cell = spec.find_cell("lj_melt_32k.einstein")
    assert "k1_roofline_pct" not in {m["name"] for m in cell.per_layer}
    assert "device_idle_pct" in {m["name"] for m in cell.per_layer}


def test_configurations_state_their_cuts():
    bench = spec.load_benchmark()
    for config in bench["configs"]:
        data = json.loads((spec.ROOT / config["file"]).read_text())
        assert data["reduced"] == config["reduced"]
        assert set(data["reduced"]) <= set(data) and set(data["reduced"]) <= set(data["assumed"])
        assert data["source"] == config["source"]


def test_no_jax_check_compares_whole_top_level_names():
    assert harness.forbidden_modules({"lammps_analysis_tpu.ops": None}) == ["lammps_analysis_tpu.ops"]
    assert harness.forbidden_modules({"jax": None, "jaxlib.xla": None}) == ["jax", "jaxlib.xla"]
    assert harness.forbidden_modules({"lammps_analysis_tpu_torch": None,
                                      "lammps_analysis_tpu_torch.ops": None,
                                      "jaxtyping": None, "numpy": None}) == []
