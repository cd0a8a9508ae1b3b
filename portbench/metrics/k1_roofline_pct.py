"""``k1_roofline_pct``: K1's least time on the card (``counts/k1``) over
the device time of ``rdf_histogram_kernel`` in the traced calls (layer:
kernels). Nothing read where the kernel did not run."""

from portbench.spec import load_module


def read(trace, ctx):
    kernel_us = trace.kernel_us("rdf_histogram_kernel")
    if kernel_us <= 0:
        return None
    ms, bound_by = load_module("counts", "k1").bound(ctx["work"])
    ctx.setdefault("bound_by", {})["k1"] = bound_by
    return 100.0 * ms * trace.n_calls * 1e3 / kernel_us
