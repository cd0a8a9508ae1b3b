"""A traced run of a benchmark cell with the program's spans on, and the five
per-layer readings of its spans and counters.

    python3 chip_spans.py --workload <cell> --seed <n>

From the root of a checkout, on a machine with a CUDA card. Runs the cell's
``--trace 1`` run (``portbench/harness.py``) with its traced calls inside
``utils.profiling.tracing()`` and prints the run's result line with a
``"spans"`` object beside it:

* ``db_ms_per_call``: the union of the main thread's ``db.*`` spans, per call;
* ``db_connections_per_call``: the counter ``db.connections`` per call;
* ``load_wait_ms_per_call``: the union of ``prefetch.wait`` spans, per call;
* ``loaded_MiB_per_call``: the counter ``store.bytes`` per call, in MiB;
* ``idle_unattributed_pct``: the share of the device's idle time in the
  window in which the main thread's innermost span is ``call`` or none.

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
    """The five readings of the traced window's ``n_calls`` calls; ``delta``,
    the counters' change, covers every attempt of the profiler."""
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
        "db_connections_per_call": delta["db.connections"] / n_calls / attempts,
        "load_wait_ms_per_call": ms_per_call(lambda name: name == "prefetch.wait"),
        "loaded_MiB_per_call": delta["store.bytes"] / n_calls / attempts / 2**20,
        "idle_unattributed_pct":
            100.0 * (trace.window_us - covered_us) / idle_us if idle_us else None,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    args = parser.parse_args(argv)

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
        with profiling.tracing() as log:
            trace = profile_calls(counted, n_calls, attempts)
        seen.update(trace=trace, log=list(log), delta=profiling.counters - before,
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
