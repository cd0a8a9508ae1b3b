"""Find a cell of ``BENCHMARK.json`` and everything it names, by name.

Nothing here knows a particular cell: a configuration is
``configs/<config>.json`` with its generator ``configs/<config>.py``, a
traffic mix is ``traffic/<mix>.json``, a cell's limits are
``cells/<cell>.json``, the plain reference of a traffic mix's calculator is
``reference/<calculator in snake case>.py``, and the modules a metric names
are files under ``metrics/`` and ``counts/``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
import sys
from types import ModuleType

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    key = f"portbench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    module_spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(module_spec)
    sys.modules[key] = module
    module_spec.loader.exec_module(module)
    return module


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def snake_case(name: str) -> str:
    """``RadialDistributionFunction`` -> ``radial_distribution_function``."""
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


def applies(metric: dict, cell: str) -> bool:
    """A metric without ``workloads`` belongs to every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file as it is run
    traffic: dict  # the traffic mix's parameters
    limits: dict  # number compared -> its limit
    end_to_end: list
    per_layer: list

    def generator(self) -> ModuleType:
        return load_module("configs", self.config["name"])

    def reference(self) -> ModuleType:
        return load_module("reference", snake_case(self.traffic["calculator"]))


def find_cell(name: str, bench: dict | None = None) -> Cell:
    bench = load_benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[entry["config"]]["file"]).read_text())
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=config,
        traffic=load_json("traffic", entry["traffic"]),
        limits=load_json("cells", name)["limits"],
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
    )
