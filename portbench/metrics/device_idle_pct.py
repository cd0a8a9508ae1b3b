"""``device_idle_pct``: the share of the traced calls' wall in which no
kernel, copy or fill ran on the device (layer: device)."""


def read(trace, ctx):
    if trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us)
