"""``call_wall_ms``: the traced calls' wall on the host's clock over the
calls, each a whole forced call through the user's entry (layer: entry).
The window's own figure, which no bound holds on a shared host's
filesystem (PERF.md, section 2)."""


def read(trace, ctx):
    return trace.window_us / 1e3 / trace.n_calls if trace.n_calls else None
