"""``k3_roofline_pct``: the angle histogram's least time on the card
(``counts/k3``) over the device time of ``adf_pairs_kernel`` in the traced
calls (layer: kernels). Nothing read where the kernel did not run."""

from portbench.spec import load_module


def read(trace, ctx):
    kernel_us = trace.kernel_us("adf_pairs_kernel")
    if kernel_us <= 0:
        return None
    ms, bound_by = load_module("counts", "k3").bound(ctx["work"])
    ctx.setdefault("bound_by", {})["k3"] = bound_by
    return 100.0 * ms * trace.n_calls * 1e3 / kernel_us
