"""``h2d_hidden_pct``: the share of the traced calls' host-to-device copy
time during which a kernel ran on the card (layer: store load): the union
of the copies inside the window, the part of it that the union of the
kernels covers, over the whole. A stream of several frame batches should
hide each batch's copy after the first under the kernels of the batch
before it. What it hides comes off ``device_ms_per_call`` only as far as
the copies' own share of the device's time. Nothing read where no
host-to-device copy ran."""

from portbench.trace import Trace


def union(trace, keep) -> list:
    """``[start, end]`` us: the union of ``trace``'s device intervals whose
    name ``keep`` takes, inside the window."""
    device = [iv for iv in trace.device if keep(iv[2])]
    return Trace(n_calls=0, window=trace.window, device=device, launches=0).busy_intervals()


def read(trace, ctx):
    copies = union(trace, lambda name: "HtoD" in name)
    copy_us = sum(end - start for start, end in copies)
    if copy_us <= 0:
        return None
    kernels = union(trace, lambda name: not name.startswith(("Memcpy", "Memset")))
    hidden_us = sum(max(0.0, min(end, hi) - max(start, lo))
                    for start, end in copies for lo, hi in kernels)
    return 100.0 * hidden_us / copy_us
