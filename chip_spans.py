"""A traced run of a benchmark cell with the program's spans on, and the
per-layer readings of its spans and counters.

    python3 chip_spans.py --workload <cell> --seed <n>

From the root of a checkout, on a machine with a CUDA card. Runs the cell's
``--trace 1`` run (``portbench/harness.py``) with its traced calls inside
``utils.profiling.tracing()`` and prints the run's result line with a
``"spans"`` object beside it:

* ``db_ms_per_call``: the union of the main thread's ``db.*`` spans, per call;
* ``load_wait_ms_per_call``: the union of ``prefetch.wait`` spans, per call;
* ``loaded_MiB_per_call``: the counter ``store.bytes`` per call, in MiB;
* ``idle_unattributed_pct``: the share of the device's idle time in the
  window in which the main thread's innermost span is ``call`` or none;
* ``k1_layouts_per_call``: K1's launches per call by the layout they took
  (the counters ``k1.layout.<layout>``: ``c8`` ... ``c1``, ``global``);
* ``rdf_batches_per_call``: the counter ``rdf.batches`` per call, the RDF's
  frame batches;
* ``k1_pair_rows_per_launch``: the counter ``k1.pair_rows`` over
  ``k1.launches``, the species-pair rows of a K1 launch (``None`` without
  a launch);
* ``k1_general_sweeps_per_call``: K1's j-chunk sweeps that took the general
  sequences (``ops/rdf_kernel.py::general_sweeps``, a word on the device,
  read before and after the traced calls as ``k1.general_sweeps``) per call
  (``None`` without a K1 launch);
* ``k1_unfolded_sweeps_per_call``: K1's j-chunk sweeps that took the in-box
  sequences without the fold (``ops/rdf_kernel.py::unfolded_sweeps``, read
  as ``k1.unfolded_sweeps`` alike) per call (``None`` without a K1 launch).
* ``acf_windows_per_call``, ``acf_batches_per_call``,
  ``acf_sequences_per_call``: the counters ``acf.windows``, ``acf.batches``
  and ``acf.sequences`` per call, the windowed FFT ACF's windows, FFT
  batches and sequences (windows x particles x components);
* ``acf_batch_ms_per_call``: the union of ``acf.batch`` spans per call, the
  host's time in the ACF's FFT batches;
* ``gk_integrate_ms_per_call``: the union of ``gk.integrate`` spans per
  call, the GK calculators' host integrals and SEM;
* ``trafo_frames_per_call``: the counter ``trafo.frames`` per call, frames
  a transformation appended (0 where the calls find their inputs stored).

The spans are mapped onto the profiler's clock by the ``call`` spans'
``record_function`` twins among the profiler's events. With spans on, each
live span's range is also a GPU user annotation among the profiler's CUDA
events: the device's busy time here leaves those out, the harness's own
readings in the result line count them in.

``portbench/`` does not read the program's spans yet; once its readers do
(``portbench/metrics/``), this script and ``tests/test_torch_spans_readings.py``
go.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from portbench.trace import Trace  # noqa: E402


def union_us(intervals, window) -> float:
    """The length (us) of the union of ``(start, end)`` intervals inside
    ``window``."""
    device = sorted((start, end, "") for start, end in intervals)
    return Trace(n_calls=0, window=window, device=device, launches=0).busy_us()


def offset_us(log, events) -> float:
    """The profiler's clock less ``perf_counter``'s, in us: the median gap
    from each main-thread ``call`` span's start to its ``record_function``
    twin's. The profiler holds the last attempt alone, whose calls are the
    log's last."""
    from torch.autograd import DeviceType

    main = threading.main_thread().ident
    ours = sorted(s.start_ns / 1e3 for s in log if s.name == "call" and s.thread == main)
    twins = sorted(e.time_range.start for e in events
                   if e.name == "call" and e.device_type == DeviceType.CPU)
    if not twins or len(ours) < len(twins):
        raise ValueError(f"{len(ours)} call spans against {len(twins)} profiled twins")
    gaps = sorted(t - s for s, t in zip(ours[-len(twins):], twins))
    return gaps[len(gaps) // 2]


def readings(trace, log, events, delta, n_calls: int, attempts: int = 1) -> dict:
    """The readings of the traced window's ``n_calls`` calls; ``delta``, the
    counters' change, covers every attempt of the profiler."""
    offset = offset_us(log, events)
    main = threading.main_thread().ident
    spans = [(s.start_ns / 1e3 + offset, s.end_ns / 1e3 + offset, s.name) for s in log
             if s.thread == main]
    names = {s.name for s in log}
    busy = [(start, end) for start, end, name in trace.device if name not in names]
    idle_us = trace.window_us - union_us(busy, trace.window)
    covered_us = union_us(busy + [(s, e) for s, e, name in spans if name != "call"],
                          trace.window)

    def ms_per_call(keep):
        return union_us([(s, e) for s, e, name in spans if keep(name)], trace.window) / 1e3 / n_calls

    return {
        "db_ms_per_call": ms_per_call(lambda name: name.startswith("db.")),
        "load_wait_ms_per_call": ms_per_call(lambda name: name == "prefetch.wait"),
        "loaded_MiB_per_call": delta["store.bytes"] / n_calls / attempts / 2**20,
        "idle_unattributed_pct":
            100.0 * (trace.window_us - covered_us) / idle_us if idle_us else None,
        "k1_layouts_per_call": {
            name.removeprefix("k1.layout."): n / n_calls / attempts
            for name, n in sorted(delta.items()) if name.startswith("k1.layout.")
        },
        "rdf_batches_per_call": delta["rdf.batches"] / n_calls / attempts,
        "k1_pair_rows_per_launch":
            delta["k1.pair_rows"] / delta["k1.launches"] if delta["k1.launches"] else None,
        "k1_general_sweeps_per_call":
            delta["k1.general_sweeps"] / n_calls / attempts if delta["k1.launches"] else None,
        "k1_unfolded_sweeps_per_call":
            delta["k1.unfolded_sweeps"] / n_calls / attempts if delta["k1.launches"] else None,
        **{f"acf_{what}_per_call": delta[f"acf.{what}"] / n_calls / attempts
           for what in ("windows", "batches", "sequences")},
        "acf_batch_ms_per_call": ms_per_call(lambda name: name == "acf.batch"),
        "gk_integrate_ms_per_call": ms_per_call(lambda name: name == "gk.integrate"),
        "trafo_frames_per_call": delta["trafo.frames"] / n_calls / attempts,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    args = parser.parse_args(argv)

    from lammps_analysis_tpu_torch.ops import rdf_kernel
    from lammps_analysis_tpu_torch.utils import profiling
    from portbench import harness, spec, trace as pbtrace

    seen = {}
    profile_calls, device_intervals = pbtrace.profile_calls, pbtrace.device_intervals

    def keep_events(events):
        seen["events"] = events
        return device_intervals(events)

    def traced(call, n_calls, attempts=3):
        made = []

        def counted():
            made.append(1)
            call()

        before = profiling.counters.copy()
        general, unfolded = rdf_kernel.general_sweeps(), rdf_kernel.unfolded_sweeps()
        with profiling.tracing() as log:
            trace = profile_calls(counted, n_calls, attempts)
        delta = profiling.counters - before
        delta["k1.general_sweeps"] = rdf_kernel.general_sweeps() - general
        delta["k1.unfolded_sweeps"] = rdf_kernel.unfolded_sweeps() - unfolded
        seen.update(trace=trace, log=list(log), delta=delta,
                    n_calls=n_calls, attempts=len(made) // n_calls)
        return trace

    pbtrace.profile_calls, pbtrace.device_intervals = traced, keep_events
    result = harness.Run(spec.find_cell(args.workload), args.seed, 10.0, True,
                         started=STARTED).execute()
    result["spans"] = readings(seen["trace"], seen["log"], seen["events"], seen["delta"],
                               seen["n_calls"], seen["attempts"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
