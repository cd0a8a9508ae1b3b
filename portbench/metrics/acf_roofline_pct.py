"""``acf_roofline_pct``: the windowed FFT ACF's least time on the card
(``counts/acf``) over the device time of every kernel in the traced calls
but copies and fills (layer: kernels). In a GK diffusion call the ACF's
padding, forward FFTs, power sums and inverse FFTs are the only compute.
Nothing read where no kernel ran."""

from portbench.spec import load_module


def read(trace, ctx):
    lo, hi = trace.window
    kernel_us = sum(min(end, hi) - max(start, lo) for start, end, name in trace.device
                    if not name.startswith(("Memcpy", "Memset")) and min(end, hi) > max(start, lo))
    if kernel_us <= 0:
        return None
    ms, bound_by = load_module("counts", "acf").bound(ctx["work"])
    ctx.setdefault("bound_by", {})["acf"] = bound_by
    return 100.0 * ms * trace.n_calls * 1e3 / kernel_us
