"""``chip_spans.py``'s readings of the program's spans and counters, on a
hand-built trace of two calls: the DB's time and connections, the wait on
the load, the bytes loaded, the device's idle time that no span but
``call`` covers, the GPU user annotations of live spans left out of the
device's busy time, and the spans' offset set by the ``call`` spans'
``record_function`` twins."""

import collections
import threading
import types

import pytest
from torch.autograd import DeviceType

import chip_spans
from portbench.trace import Trace

MAIN = threading.main_thread().ident


def _event(name, start_us, device=DeviceType.CPU):
    return types.SimpleNamespace(name=name, device_type=device,
                                 time_range=types.SimpleNamespace(start=start_us))


def _span(name, start_us, end_us, thread=MAIN):
    return types.SimpleNamespace(name=name, start_ns=int(start_us * 1e3),
                                 end_ns=int(end_us * 1e3), thread=thread)


#: (name, start, end) us of the main thread's spans, perf_counter = profiler + 7000 us
SPANS = [("call", 5, 450), ("db.find_computation", 10, 60), ("prefetch.wait", 60, 110),
         ("k1", 110, 120), ("call", 505, 950), ("db.get_attribute", 520, 580),
         ("prefetch.wait", 600, 640), ("adf.feed", 700, 720)]
SHIFT = 7000.0


def test_readings_of_a_hand_built_trace():
    trace = Trace(n_calls=2, window=(0.0, 1000.0), launches=0, device=[
        (100.0, 200.0, "rdf_histogram_kernel"), (150.0, 300.0, "rdf_histogram_kernel"),
        (600.0, 700.0, "adf.feed"),  # a live span's GPU user annotation
    ])
    log = [_span(name, s + SHIFT, e + SHIFT) for name, s, e in SPANS]
    log.append(_span("db.get_attribute", 800 + SHIFT, 900 + SHIFT, thread=MAIN + 1))  # a worker's
    events = [_event("call", 5.0), _event("call", 505.0)]  # the call spans' twins
    delta = collections.Counter({"db.connections": 44, "store.bytes": 2 * 2**20})
    r = chip_spans.readings(trace, log, events, delta, n_calls=2)
    assert r["db_ms_per_call"] == pytest.approx((50 + 60) / 1e3 / 2)
    assert r["db_connections_per_call"] == 22
    assert r["load_wait_ms_per_call"] == pytest.approx((50 + 40) / 1e3 / 2)
    assert r["loaded_MiB_per_call"] == 1
    # busy 100-300 (the annotation left out); idle 0-100 and 300-1000, of
    # which 0-10 and 300-1000 less 520-580, 600-640, 700-720 lie in no span but call
    assert r["idle_unattributed_pct"] == pytest.approx(100 * (10 + 580) / 800)
    # three profiler attempts: the counters cover all six calls
    r = chip_spans.readings(trace, log, events, delta, n_calls=2, attempts=3)
    assert r["db_connections_per_call"] == pytest.approx(44 / 6)


@pytest.mark.parametrize("lags, expected", [
    ([3.0, 3.0, 4.0], 3.0),  # entering the record_function range costs a few us
    ([2.0, 3.0, 90.0], 3.0),  # one twin entered late does not move the offset
])
def test_spans_map_onto_their_twins(lags, expected):
    """Each ``call`` span lands within 50 us of its ``record_function``
    twin; an earlier attempt's calls, which the profiler did not keep, are
    passed over."""
    starts = [100.0, 600.0, 1100.0]
    log = [_span("call", SHIFT - 400.0, SHIFT - 300.0)]  # the earlier attempt's call
    log += [_span("call", s + SHIFT, s + SHIFT + 400.0) for s in starts]
    log.append(_span("call", SHIFT, SHIFT + 50.0, thread=MAIN + 1))  # not the main thread's
    events = [_event("call", s + lag) for s, lag in zip(starts, lags)]
    events.append(_event("call", 0.0, DeviceType.CUDA))  # a GPU user annotation
    offset = chip_spans.offset_us(log, events)
    assert offset == pytest.approx(expected - SHIFT)
    assert max(abs(s + SHIFT + offset - (s + lag)) for s, lag in zip(starts, lags)
               if lag < 50) < 50
