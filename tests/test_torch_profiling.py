"""The port's spans and counters (``utils/profiling.py``): what a span costs
with tracing off, what the log holds with it on (parents, call ids and
threads, the prefetch workers' too), and the counters of one forced call of
each benchmarked calculator against what is observed directly."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import lammps_analysis_tpu_torch as lt
from lammps_analysis_tpu_torch.calculators import angular_distribution_function, base
from lammps_analysis_tpu_torch.calculators import radial_distribution_function
from lammps_analysis_tpu_torch.database import SpeciesInfo, TrajectoryChunkData, TrajectoryMetadata
from lammps_analysis_tpu_torch.database.properties import PropertyInfo
from lammps_analysis_tpu_torch.database.results_db import ResultsDatabase
from lammps_analysis_tpu_torch.database.trajectory_store import TrajectoryStore
from lammps_analysis_tpu_torch.file_io import ScriptInput
from lammps_analysis_tpu_torch.memory.planner import BatchPlanner
from lammps_analysis_tpu_torch.pipeline import prefetch
from lammps_analysis_tpu_torch.utils import profiling
from lammps_analysis_tpu_torch.utils.config import config

torch.set_num_threads(1)

#: seconds that 10^5 spans may take with tracing off. Each is a flag check
#: and a shared no-op (0.4-0.8 us a span on a loaded CPU host); opening a
#: ``record_function`` range each would take about 16 us a span: 1.6 s
OFF_LIMIT_S = 0.5

N_NA, N_CL, N_FRAMES, BOX = 96, 64, 12, 9.0
#: a planner budget under which the ADF takes 3 batches of 4, 4 and 2 frames
#: (``test_torch_adf_calculator.py``)
ADF_BUDGET = 10 * (4 * (N_NA + N_CL) * 3 * 8) ** 2
CALLS = {
    "rdf": ("RadialDistributionFunction", {"cutoff": 4.4, "number_of_bins": 60,
                                           "number_of_configurations": 10}),
    "adf": ("AngularDistributionFunction", {"cutoff": 3.3, "number_of_bins": 73,
                                            "number_of_configurations": 10, "start": 0}),
    "einstein": ("EinsteinDiffusionCoefficients", {"data_range": 6, "correlation_time": 2}),
}


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def test_spans_off_record_nothing_and_cost_a_flag_check():
    assert profiling.annotate("a") is profiling.annotate("b")  # one shared no-op
    t0 = time.perf_counter()
    for _ in range(10**5):
        with profiling.annotate("off") as span:
            pass
    elapsed = time.perf_counter() - t0
    assert span is None and profiling.current() is None
    assert elapsed < OFF_LIMIT_S, f"10^5 spans off took {elapsed:.3f} s"


def test_counts_from_many_threads_lose_no_update():
    """The prefetch workers count the store's loads from their threads
    (``count_shared``): 16 threads, a switch every microsecond, no increment
    lost."""
    n_threads, n = 16, 2000
    before = profiling.counters["test.threads"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [profiling.count_shared("test.threads")
                                                    for _ in range(n)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert profiling.counters["test.threads"] - before == n_threads * n


def test_live_spans_hold_parent_call_and_thread():
    """Nested spans on the main thread, and the prefetch workers' spans,
    children of the span that queued their item (the consumer's, then its
    ``prefetch.wait``); every span inside ``call`` carries its id, none
    outside it."""

    def load(i):
        with profiling.annotate("test.inner"):
            return np.full((2, 3), i, np.float32)

    with profiling.tracing() as log:
        with profiling.annotate("call") as call:
            with profiling.annotate("test.outer") as outer:
                items = list(prefetch.prefetch_to_device(load, [0, 1, 2], device="cpu"))
        with profiling.annotate("test.after") as after:
            pass
    assert [int(t[0, 0]) for t in items] == [0, 1, 2]
    main = threading.get_ident()
    by_id = {s.id: s for s in log}
    assert len(by_id) == len(log) == 1 + 1 + 3 * 3 + 1
    assert (call.parent, call.call, call.thread) == (None, call.id, main)
    assert (outer.parent, outer.call, outer.thread) == (call.id, call.id, main)
    assert (after.parent, after.call) == (None, None)
    loads = [s for s in log if s.name == "prefetch.load"]
    waits = [s for s in log if s.name == "prefetch.wait"]
    assert len(loads) == len(waits) == 3
    # the first two loads are queued from the consumer's span, the third
    # from the wait for the first item
    assert sorted(by_id[s.parent].name for s in loads) == [
        "prefetch.wait", "test.outer", "test.outer"]
    for s in loads:
        assert s.call == call.id and s.thread != main
    for s in waits:
        assert (s.parent, s.call, s.thread) == (outer.id, call.id, main)
    for s in (s for s in log if s.name == "test.inner"):
        parent = by_id[s.parent]
        assert parent.name == "prefetch.load" and s.thread == parent.thread
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    for s in log:
        if s.parent is not None and by_id[s.parent].thread == s.thread:
            assert by_id[s.parent].start_ns <= s.start_ns <= s.end_ns <= by_id[s.parent].end_ns
    assert profiling.current() is None


def _experiment(root):
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, BOX, size=(N_FRAMES, N_NA + N_CL, 3))
    prop = PropertyInfo("Positions", 3)
    species = [SpeciesInfo("Na", N_NA, [prop]), SpeciesInfo("Cl", N_CL, [prop])]
    meta = TrajectoryMetadata(n_configurations=N_FRAMES, species_list=species,
                              box_l=[BOX] * 3, sample_rate=1)
    chunk = TrajectoryChunkData(species, N_FRAMES)
    chunk.add_data(pos[:, :N_NA], 0, "Na", "Positions")
    chunk.add_data(pos[:, N_NA:], 0, "Cl", "Positions")
    project = lt.Project(name="spans", storage_path=root)
    exp = project.add_experiment("e", timestep=0.1, units="metal",
                                 simulation_data=ScriptInput(chunk, meta, "d"))
    exp.planner = BatchPlanner(memory_budget_bytes=ADF_BUDGET)
    return exp


@pytest.mark.parametrize("calc", sorted(CALLS))
def test_counters_of_a_forced_call_equal_what_is_observed(tmp_path, monkeypatch, calc):
    """One forced call (after an unforced one has run the dependencies):
    ``db.connections`` equals the connections a wrapper of ``_connect``
    sees, ``store.bytes`` and ``store.frames`` the arrays the store's load
    returned, ``prefetch.items`` the items handed to the prefetch pipeline,
    and the ADF's ``adf.batches`` and ``adf.passes`` its 3 batches and one
    pass. Under ``tracing()`` every span of the call carries its id."""
    name, kwargs = CALLS[calc]
    exp = _experiment(tmp_path)
    run = getattr(exp.run, name)
    run(plot=False, **kwargs)

    seen = {"connections": 0, "items": 0, "loads": []}
    connect, load = ResultsDatabase._connect, TrajectoryStore.load

    def counted_connect(self):
        seen["connections"] += 1
        return connect(self)

    def counted_load(self, *args, **kw):
        out = load(self, *args, **kw)
        seen["loads"].extend((a.nbytes, len(a)) for a in out.values())
        return out

    def counted_prefetch(load_fn, items, *args, **kw):
        items = list(items)
        seen["items"] += len(items)
        return prefetch.prefetch_to_device(load_fn, items, *args, **kw)

    monkeypatch.setattr(ResultsDatabase, "_connect", counted_connect)
    monkeypatch.setattr(TrajectoryStore, "load", counted_load)
    for module in (base, radial_distribution_function, angular_distribution_function):
        monkeypatch.setattr(module, "prefetch_to_device", counted_prefetch)

    before = profiling.counters.copy()
    with profiling.tracing() as log:
        run(plot=False, force=True, **kwargs)
    delta = profiling.counters - before

    assert seen["connections"] > 0 and seen["loads"] and seen["items"] > 0
    assert delta["db.connections"] == seen["connections"]
    assert delta["store.bytes"] == sum(nbytes for nbytes, _ in seen["loads"])
    assert delta["store.frames"] == sum(frames for _, frames in seen["loads"])
    assert delta["prefetch.items"] == seen["items"]
    if calc == "adf":
        assert (delta["adf.batches"], delta["adf.passes"]) == (seen["items"], 1) == (3, 1)
    else:
        assert delta["adf.batches"] == delta["adf.passes"] == 0

    (call,) = [s for s in log if s.name == "call"]
    assert all(s.call == call.id for s in log)
    names = {s.name for s in log}
    assert {"db.find_computation", "db.store_computation", "store.load", "prefetch.load",
            "prefetch.wait", f"{calc}.fetch", f"{calc}.normalise"} <= names
    assert sum(s.name == "store.load" for s in log) == len(seen["loads"])  # one path a load
