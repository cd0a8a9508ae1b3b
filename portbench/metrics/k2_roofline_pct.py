"""``k2_roofline_pct``: the neighbor extract's least time on the card
(``counts/k2``) over the device time of K2's kernels in the traced calls,
whichever route ran (the cell lists' ``bin_atoms``, ``scan_counts``,
``scatter_atoms``, ``cells_extract``, or the sweep's
``neighbor_extract_kernel``) (layer: kernels). Nothing read where none ran."""

from portbench.spec import load_module

KERNELS = ("bin_atoms", "scan_counts", "scatter_atoms", "cells_extract",
           "neighbor_extract_kernel")


def read(trace, ctx):
    kernel_us = trace.kernel_us(*KERNELS)
    if kernel_us <= 0:
        return None
    ms, bound_by = load_module("counts", "k2").bound(
        ctx["work"], ctx["positions"], float(ctx["config"]["box_length"]))
    ctx.setdefault("bound_by", {})["k2"] = bound_by
    return 100.0 * ms * trace.n_calls * 1e3 / kernel_us
