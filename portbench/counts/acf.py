"""Frozen work count of the windowed FFT autocorrelation
(``ops/correlation.py::windowed_acf_sum``), for one call.

It counts this estimator, the biased ACF of each window by a zero-padded
real FFT: for every sequence (a window of one particle's component, over
the series a call correlates) a forward real FFT of the padded length ``n``
(the power of two at least twice the window), 2.5 n log2 n operations, and
its power and sum, 3 (n/2 + 1) operations; the inverse transforms, once a
window after the sum over particles and components, are left out. Bytes: the
values read once (float32) and the per-window ACFs written once (float64).
A later change of estimator needs the count made again.
"""

import math

from portbench.peaks import bound_ms


def bound(work: dict) -> tuple[float, str]:
    """``(least ms a call, set by)`` from the reference's ``work``."""
    n = work["fft_len"]
    flops = work["sequences"] * (2.5 * n * math.log2(n) + 3 * (n // 2 + 1))
    n_bytes = work["values_read"] * 4 + work["acf_written"] * 8
    return bound_ms(flops, n_bytes)
