"""Helpers of the benchmark's CPU tests: a cell cut to a size the CPU can
run in a second, at the configuration's own density, and the port's
settings a run changes, restored after each test."""

import dataclasses
import os
import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from portbench import spec  # noqa: E402


def tiny_cell(name: str, n_atoms: int = 200, n_frames: int = 100, **traffic_args):
    """``name``'s cell with ``n_atoms`` atoms (split evenly over its species)
    and ``n_frames`` frames in a box of the configuration's density."""
    cell = spec.find_cell(name)
    config = dict(cell.config)
    n_full = sum(config["species"].values())
    density = n_full / config["box_length"] ** 3
    per = n_atoms // len(config["species"])
    config["species"] = {s: per for s in config["species"]}
    config["box_length"] = (per * len(config["species"]) / density) ** (1 / 3)
    config["n_frames"] = n_frames
    traffic = dict(cell.traffic, args=dict(cell.traffic["args"], **traffic_args))
    return dataclasses.replace(cell, config=config, traffic=traffic)


#: the port's host budget in these tests: its ADF planner then takes one
#: frame a batch at a few hundred atoms, as it does on a card at the cells'
#: sizes, while the RDF's batch and the MSD's slab still hold every frame
BUDGET_BYTES = 4e8


@pytest.fixture()
def port_on_cpu():
    """The port on the CPU with ``BUDGET_BYTES`` to plan into; restored afterwards."""
    import lammps_analysis_tpu_torch as lt

    old = (lt.config.device, lt.config.memory_fraction)
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    lt.config.device, lt.config.memory_fraction = "cpu", BUDGET_BYTES / host
    yield lt
    lt.config.device, lt.config.memory_fraction = old
