"""The trace's busy union, idle gaps and readers on a synthetic trace."""

import pytest

from portbench import spec, trace


def synthetic():
    # window 0..100 us; kernels overlap (10-30, 20-40), one hangs out of the window
    device = [(10, 30, "void rdf_histogram_kernel<1>(float*)"),
              (20, 40, "Memcpy HtoD (Pageable -> Device)"),
              (60, 70, "void adf_pairs_kernel(float const*)"),
              (95, 120, "void rdf_histogram_kernel<1>(float*)")]
    host = [(5, "database.results_db._connect"), (45, "pipeline.prefetch.load"),
            (50, "pipeline.prefetch.load"), (55, "database.results_db._connect"),
            (80, "database.results_db._connect")]
    return trace.Trace(n_calls=2, window=(0, 100), device=device, launches=7, host=host)


def test_busy_is_the_union_inside_the_window():
    t = synthetic()
    assert t.busy_intervals() == [[10, 40], [60, 70], [95, 100]]
    assert t.busy_us() == 45
    assert spec.load_module("metrics", "device_idle_pct").read(t, {}) == pytest.approx(55.0)


def test_launches_per_call():
    assert spec.load_module("metrics", "host_launches_per_call").read(synthetic(), {}) == 3.5


def test_kernel_time_by_name_is_clipped():
    t = synthetic()
    assert t.kernel_us("rdf_histogram_kernel") == 20 + 5
    assert t.kernel_us("adf_pairs_kernel", "nothing") == 10
    ops = dict(t.device_ops())
    assert ops["rdf_histogram_kernel"] == pytest.approx(45e-6)


def test_idle_gaps_are_named_by_the_host():
    gaps = dict(synthetic().idle_gaps())
    # gaps 0-10 (_connect), 40-60 (two prefetch samples, one _connect), 70-95 (_connect)
    assert gaps["database.results_db._connect"] == pytest.approx(35e-6)
    assert gaps["pipeline.prefetch.load"] == pytest.approx(20e-6)


def test_readers_read_nothing_where_their_kernel_did_not_run():
    t = trace.Trace(n_calls=1, window=(0, 10), device=[(0, 5, "elementwise_kernel")], launches=1)
    for name in ("k1_roofline_pct", "k2_roofline_pct", "k3_roofline_pct"):
        assert spec.load_module("metrics", name).read(t, {}) is None


def test_describe_names_the_innermost_function_of_the_program():
    import sys
    frame = sys._getframe()
    assert trace.describe(frame).endswith(":test_describe_names_the_innermost_function_of_the_program")
    assert trace.describe(None) == "(no frame)"


def test_device_clock_takes_the_union_of_every_interval():
    device = [(10, 30, "a"), (20, 40, "b"), (60, 70, "c"), (95, 120, "a")]
    assert trace.busy_us(device) == 30 + 10 + 25
    assert trace.busy_us([]) == 0.0


def test_call_wall_is_the_traced_window_over_the_calls():
    t = synthetic()
    assert spec.load_module("metrics", "call_wall_ms").read(t, {}) == pytest.approx(0.05)
    empty = trace.Trace(n_calls=0, window=(0, 0), device=[], launches=0)
    assert spec.load_module("metrics", "call_wall_ms").read(empty, {}) is None
