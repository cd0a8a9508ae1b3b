"""One run of one cell: set up, warm up, measure (or trace), judge.

The system under test is ``lammps_analysis_tpu_torch``'s user entry:
``exp.run.<Calculator>(force=True, plot=False, **args)`` on an experiment
whose store was ingested at set-up through ``ScriptInput``. One client
calls it back to back, each call recomputing (the DB entry of the last one
is deleted first), as a user does when the data or arguments change. The
device's busy time over the window is taken from the profiler's CUDA
activity (``trace.DeviceClock``), armed in set-up by the warm call. After
the window the answer is read back from the results DB by an unforced
call (a cache hit), the program's state is freed, and the plain reference
works the answer out again from the generated inputs, on the device.

A configuration's generator returns the positions ``(F, N, 3)``, or a
mapping from the port's property names (``Positions`` and, say,
``Velocities``) to such tensors; every property is ingested, and the
reference receives the generator's output in the form it was returned.
"""

from __future__ import annotations

import contextlib
import gc
import random
import statistics
import sys
import tempfile
import time
import traceback
from collections.abc import Mapping

import torch

from portbench import spec, trace as tracing

#: top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "lammps_analysis_tpu"})

#: forced calls after the first (which builds the kernels and runs dependencies)
WARMUP_CALLS = 1
#: warm calls under the device clock, at most, until it has seen the device work
CLOCK_WARMUPS = 3
#: window answers judged besides the one the results DB holds, drawn from the seed
SAMPLE_ANSWERS = 8


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``lammps_analysis_tpu_torch`` is not
    ``lammps_analysis_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in modules if name.split(".", 1)[0] in FORBIDDEN)


def call_stats(walls: list, window_s: float) -> dict:
    """``call_ms``: the window over the calls completed in it;
    ``call_p95_ms``: the 95th percentile of every call's wall."""
    p95 = statistics.quantiles(walls, n=20, method="inclusive")[18] if len(walls) > 1 else walls[0]
    return {"call_ms": 1e3 * window_s / len(walls), "call_p95_ms": 1e3 * p95}


def ingest(root: str, config: dict, properties):
    """An experiment of ``config`` holding ``properties``, ingested through
    the program's ``ScriptInput`` path into its npy store: the positions
    ``(F, N, 3)``, or a mapping from property names to such arrays, each
    stored under its name for every species."""
    import lammps_analysis_tpu_torch as lt
    from lammps_analysis_tpu_torch.database import (
        PropertyInfo, SpeciesInfo, TrajectoryChunkData, TrajectoryMetadata,
    )
    from lammps_analysis_tpu_torch.file_io import ScriptInput

    if not isinstance(properties, Mapping):
        properties = {"Positions": properties}
    props = [PropertyInfo(name, 3) for name in properties]
    names = list(config["species"])
    species = [SpeciesInfo(name, config["species"][name], props) for name in names]
    n_frames = properties["Positions"].shape[0]
    meta = TrajectoryMetadata(
        n_configurations=n_frames, species_list=species, box_l=[config["box_length"]] * 3,
        sample_rate=config["sample_rate"], temperature=config["temperature"],
    )
    chunk = TrajectoryChunkData(species, n_frames)
    offset = 0
    for name in names:
        n = config["species"][name]
        for prop, array in properties.items():
            chunk.attach_data(array[:, offset:offset + n], name, prop)
        offset += n
    project = lt.Project(name="portbench", storage_path=root)
    exp = project.add_experiment(
        config["name"], timestep=config["timestep"], temperature=config["temperature"],
        units=config["units"], simulation_data=ScriptInput(chunk, meta, "seeded"),
    )
    for name, charge in config.get("charges", {}).items():
        exp.set_charge(name, charge)
    return exp


def bytes_written() -> int | None:
    """Bytes this process has passed to ``write`` calls (``/proc/self/io``'s
    ``wchar``: files, pipes and the terminal alike), if known."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


class Run:
    """One run of ``cell``; ``device`` is ``"cuda"`` for a measured run, and
    ``"cpu"`` only where the CPU tests drive the rest of a run."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", started: float | None = None):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = device
        self.started = time.perf_counter() if started is None else started
        self.phases: dict = {}

    def _phase(self, name: str, since: float) -> float:
        now = time.perf_counter()
        self.phases[name] = now - since
        return now

    def _call(self, exp, force: bool):
        traffic = self.cell.traffic
        calc = getattr(exp.run, traffic["calculator"])
        return calc(force=force, plot=False, **traffic["args"])

    def _window(self, exp, rng, sample, walls, start) -> tuple:
        """Forced calls back to back from ``start`` until ``seconds`` have
        passed; each call's wall goes to ``walls``, a seeded sample of the
        answers to ``sample``. Returns the window's length and the calls
        that failed."""
        failed = 0
        while True:
            t0 = time.perf_counter()
            try:
                answer = self._call(exp, force=True)
            except Exception:  # a call that fails is counted and reported
                failed += 1
                print(traceback.format_exc(), file=sys.stderr, flush=True)
                answer = None
            t1 = time.perf_counter()
            walls.append(t1 - t0)
            if answer is not None:  # a seeded sample of the window's answers
                if len(sample) < SAMPLE_ANSWERS:
                    sample.append(answer)
                else:
                    k = rng.randrange(len(walls))
                    if k < SAMPLE_ANSWERS:
                        sample[k] = answer
            if t1 - start >= self.seconds:
                return t1 - start, failed

    def execute(self) -> dict:
        cuda = self.device == "cuda"
        import lammps_analysis_tpu_torch as lt

        lt.config.device = self.device
        t = self._phase("import", self.started)
        # made on the device, kept on the host only: the window's memory is the program's
        generated = self.cell.generator().generate(self.cell.config, self.seed, self.device)
        tensor = not isinstance(generated, Mapping)  # the reference is handed this form
        host = {name: array.cpu().numpy()
                for name, array in ({"Positions": generated} if tensor else generated).items()}
        del generated
        t = self._phase("generate", t)
        tmp = tempfile.TemporaryDirectory(prefix="portbench-")
        try:
            return self._run(host, tensor, tmp.name, t, cuda)
        finally:
            tmp.cleanup()

    def _run(self, host, tensor, root, t, cuda) -> dict:
        traffic = self.cell.traffic
        exp = ingest(root, self.cell.config, host)
        t = self._phase("ingest", t)
        self._call(exp, force=False)  # builds the kernels at first use; runs dependencies
        t = self._phase("first_call", t)
        for _ in range(WARMUP_CALLS):
            self._call(exp, force=True)
        if cuda and not self.trace:  # the profiler's first use arms it: set-up, not window
            for _ in range(CLOCK_WARMUPS):
                with tracing.DeviceClock() as warm:
                    self._call(exp, force=True)
                if warm.busy_us() > 0:
                    break
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t = self._phase("warmup", t)
        setup_s = t - self.started

        rng = random.Random(self.seed)
        sample, attempted, failed, walls = [], 0, 0, []
        trace = None
        if self.trace:
            def one():
                sample.append(self._call(exp, force=True))
            trace = tracing.profile_calls(one, traffic["trace_calls"])
            attempted = trace.n_calls
            window_s = trace.window_us / 1e6
        else:
            clock = tracing.DeviceClock() if cuda else contextlib.nullcontext()
            with clock:
                start = time.perf_counter()
                window_s, failed = self._window(exp, rng, sample, walls, start)
            attempted = len(walls)
            device_ms = clock.busy_us() / 1e3 / attempted if cuda else 0.0

        peak = 0
        if cuda:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        stored = self._call(exp, force=False)  # the answer as the results DB holds it
        answers = [stored] + sample
        del exp, sample, stored
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        inputs = {name: torch.from_numpy(array).to(self.device) for name, array in host.items()}
        reference = self.cell.reference()
        ref_answer, work = reference.compute(inputs["Positions"] if tensor else inputs,
                                             self.cell.config, traffic["args"])
        numbers = {}
        for answer in answers:
            for name, value in reference.judge(answer.data_dict, ref_answer, work).items():
                numbers[name] = max(numbers.get(name, 0.0), value)
        reference_s = time.perf_counter() - t_ref
        # a number the judge did not give reads as the largest float
        checks = {name: {"value": min(numbers.get(name, sys.float_info.max), sys.float_info.max),
                         "limit": limit}
                  for name, limit in self.cell.limits.items()}
        correct = (failed == 0 and len(answers) > 1
                   and all(c["value"] <= c["limit"] for c in checks.values()))

        metrics, breakdown = {}, None
        if self.trace:
            ctx = {"work": work, "positions": inputs["Positions"], "config": self.cell.config}
            for metric in self.cell.per_layer:
                value = spec.load_module("metrics", metric["name"]).read(trace, ctx)
                if value is not None:
                    metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
            breakdown = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
            bound_by = ctx.get("bound_by")
        else:
            stats = call_stats(walls, window_s)
            stats["device_ms_per_call"] = device_ms
            stats["peak_device_MiB"] = peak / 2**20
            stats["setup_s"] = setup_s
            for metric in self.cell.end_to_end:
                metrics[metric["name"]] = {"value": stats[metric["name"]], "unit": metric["unit"]}

        device = device_info(self.cell.chips, peak) if cuda else {"platform": "cpu"}
        if self.trace and cuda:
            device["busy_s"] = trace.busy_us() / 1e6
            device["window_s"] = window_s
        result = {
            "correct": bool(correct),
            "attempted": attempted,
            "failed": failed,
            "metrics": metrics,
            "device": device,
        }
        if breakdown is not None:
            result["breakdown"] = breakdown
            result["roofline_set_by"] = bound_by
        if len(walls) > 1:
            q1, q2, q3 = statistics.quantiles(walls, n=4, method="inclusive")
            half = len(walls) // 2
            result["walls_ms"] = {
                "q1": 1e3 * q1, "median": 1e3 * q2, "q3": 1e3 * q3,
                "p95": call_stats(walls, window_s)["call_p95_ms"], "max": 1e3 * max(walls),
                "first_half_mean": 1e3 * statistics.fmean(walls[:half or 1]),
                "second_half_mean": 1e3 * statistics.fmean(walls[half:]),
            }
        result["setup_phases_s"] = self.phases
        result["reference_s"] = reference_s
        result["bytes_written"] = bytes_written()
        result["checks"] = checks
        return result


def device_info(chips: int, peak: int) -> dict:
    import subprocess

    info = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": int(peak),
    }
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout.strip()
        info["power_limit_w"] = float(out)
    except (OSError, subprocess.SubprocessError, ValueError):
        info["power_limit_w"] = None
    return info
