"""``chip_spans.py``'s readings of the program's spans and counters, on a
hand-built trace of two calls: the DB's time, the wait on
the load, the bytes loaded, the device's idle time that no span but
``call`` covers, the GPU user annotations of live spans left out of the
device's busy time, the spans' offset set by the ``call`` spans'
``record_function`` twins, the RDF's frame batches a call and K1's pair
rows a launch, K1's sweeps by the general sequences a call, the GK path's
ACF counters and spans a call; and ``k1.pair_rows``, the counter the last reads, on the
card (``cuda``). ``rdf.batches`` is counted by the streaming test
(``test_torch_rdf_streaming.py``)."""

import collections
import threading
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

import chip_spans
from lammps_analysis_tpu_torch.ops import rdf_kernel
from lammps_analysis_tpu_torch.ops.rdf import build_species_layout
from lammps_analysis_tpu_torch.utils import profiling
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
    delta = collections.Counter({"store.bytes": 2 * 2**20})
    r = chip_spans.readings(trace, log, events, delta, n_calls=2)
    assert r["db_ms_per_call"] == pytest.approx((50 + 60) / 1e3 / 2)
    assert r["load_wait_ms_per_call"] == pytest.approx((50 + 40) / 1e3 / 2)
    assert r["loaded_MiB_per_call"] == 1
    # busy 100-300 (the annotation left out); idle 0-100 and 300-1000, of
    # which 0-10 and 300-1000 less 520-580, 600-640, 700-720 lie in no span but call
    assert r["idle_unattributed_pct"] == pytest.approx(100 * (10 + 580) / 800)
    # three profiler attempts: the counters cover all six calls
    r = chip_spans.readings(trace, log, events, delta, n_calls=2, attempts=3)
    assert r["loaded_MiB_per_call"] == pytest.approx(2 / 6)


def test_k1_layouts_per_call():
    """K1's launches by layout, per call over every profiler attempt; no
    launch, no entry."""
    trace = Trace(n_calls=2, window=(0.0, 1000.0), launches=0, device=[])
    log = [_span(name, s + SHIFT, e + SHIFT) for name, s, e in SPANS]
    events = [_event("call", 5.0), _event("call", 505.0)]
    delta = collections.Counter({"k1.launches": 6, "k1.layout.c1": 6, "k1.plain": 1})
    r = chip_spans.readings(trace, log, events, delta, n_calls=2, attempts=3)
    assert r["k1_layouts_per_call"] == {"c1": 1}
    r = chip_spans.readings(trace, log, events, collections.Counter(), n_calls=2)
    assert r["k1_layouts_per_call"] == {}


def test_rdf_batches_per_call_and_k1_pair_rows_per_launch():
    """The RDF's batches per call and K1's pair rows per launch, over every
    profiler attempt; no launch reads ``None``, no batch 0."""
    trace = Trace(n_calls=2, window=(0.0, 1000.0), launches=0, device=[])
    log = [_span(name, s + SHIFT, e + SHIFT) for name, s, e in SPANS]
    events = [_event("call", 5.0), _event("call", 505.0)]
    delta = collections.Counter({"rdf.batches": 24, "k1.launches": 24, "k1.pair_rows": 72})
    r = chip_spans.readings(trace, log, events, delta, n_calls=2, attempts=3)
    assert (r["rdf_batches_per_call"], r["k1_pair_rows_per_launch"]) == (4, 3)
    r = chip_spans.readings(trace, log, events, collections.Counter({"k1.plain": 2}), n_calls=2)
    assert (r["rdf_batches_per_call"], r["k1_pair_rows_per_launch"]) == (0, None)


def test_acf_counters_and_gk_spans_per_call():
    """The windowed ACF's windows, batches and sequences and a
    transformation's frames per call over every profiler attempt; the host's
    time in ``acf.batch`` and ``gk.integrate`` spans per call."""
    trace = Trace(n_calls=2, window=(0.0, 1000.0), launches=0, device=[])
    spans = SPANS + [("acf.batch", 120, 170), ("acf.batch", 170, 200),
                     ("gk.integrate", 300, 330), ("gk.integrate", 900, 910)]
    log = [_span(name, s + SHIFT, e + SHIFT) for name, s, e in spans]
    events = [_event("call", 5.0), _event("call", 505.0)]
    delta = collections.Counter({"acf.windows": 3612, "acf.batches": 132,
                                 "acf.sequences": 3612 * 48000})
    r = chip_spans.readings(trace, log, events, delta, n_calls=2, attempts=3)
    assert (r["acf_windows_per_call"], r["acf_batches_per_call"]) == (602, 22)
    assert r["acf_sequences_per_call"] == 602 * 48000
    assert r["acf_batch_ms_per_call"] == pytest.approx(80 / 1e3 / 2)
    assert r["gk_integrate_ms_per_call"] == pytest.approx(40 / 1e3 / 2)
    assert r["trafo_frames_per_call"] == 0
    delta = collections.Counter({"trafo.frames": 2000})
    r = chip_spans.readings(trace, log, events, delta, n_calls=2)
    assert (r["trafo_frames_per_call"], r["acf_batches_per_call"]) == (1000, 0)


def test_k1_general_sweeps_per_call():
    """K1's sweeps by the general sequences per call over every profiler
    attempt; 0 where every sweep stayed in the box, ``None`` without a
    launch."""
    trace = Trace(n_calls=2, window=(0.0, 1000.0), launches=0, device=[])
    log = [_span(name, s + SHIFT, e + SHIFT) for name, s, e in SPANS]
    events = [_event("call", 5.0), _event("call", 505.0)]
    delta = collections.Counter({"k1.launches": 6, "k1.general_sweeps": 30})
    r = chip_spans.readings(trace, log, events, delta, n_calls=2, attempts=3)
    assert r["k1_general_sweeps_per_call"] == 5
    delta = collections.Counter({"k1.launches": 6, "k1.general_sweeps": 0})
    r = chip_spans.readings(trace, log, events, delta, n_calls=2, attempts=3)
    assert r["k1_general_sweeps_per_call"] == 0
    r = chip_spans.readings(trace, log, events, collections.Counter({"rdf.batches": 2}), n_calls=2)
    assert r["k1_general_sweeps_per_call"] is None


def test_k1_unfolded_sweeps_per_call():
    """K1's sweeps by the in-box sequences without the fold per call over
    every profiler attempt, beside the general ones; 0 where every sweep
    folded, ``None`` without a launch."""
    trace = Trace(n_calls=2, window=(0.0, 1000.0), launches=0, device=[])
    log = [_span(name, s + SHIFT, e + SHIFT) for name, s, e in SPANS]
    events = [_event("call", 5.0), _event("call", 505.0)]
    delta = collections.Counter({"k1.launches": 6, "k1.unfolded_sweeps": 42,
                                 "k1.general_sweeps": 6})
    r = chip_spans.readings(trace, log, events, delta, n_calls=2, attempts=3)
    assert (r["k1_unfolded_sweeps_per_call"], r["k1_general_sweeps_per_call"]) == (7, 1)
    delta = collections.Counter({"k1.launches": 6})
    r = chip_spans.readings(trace, log, events, delta, n_calls=2, attempts=3)
    assert (r["k1_unfolded_sweeps_per_call"], r["k1_general_sweeps_per_call"]) == (0, 0)
    r = chip_spans.readings(trace, log, events, collections.Counter({"rdf.batches": 2}), n_calls=2)
    assert r["k1_unfolded_sweeps_per_call"] is None


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


@pytest.mark.cuda
def test_k1_pair_rows_counts_each_launch_s_rows():
    """A K1 launch over 2 species adds their 3 pair rows, over 3 species 6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    box = (8.0, 8.0, 8.0)
    rng = np.random.default_rng(3)
    for counts, rows in (([100, 60], 3), ([50, 40, 30], 6)):
        sid, n_pad, _, _, _ = build_species_layout(counts, pad_to=8)
        pos = torch.from_numpy(rng.uniform(0, 8.0, (2, n_pad, 3)).astype(np.float32)).cuda()
        before = profiling.counters.copy()
        rdf_kernel.rdf_histogram(pos, torch.from_numpy(sid).cuda(), box, 3.9, 40, len(counts))
        torch.cuda.synchronize()
        delta = profiling.counters - before
        assert (delta["k1.launches"], delta["k1.pair_rows"]) == (1, rows)
