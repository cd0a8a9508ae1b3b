"""``host_launches_per_call``: kernel launches the host made
(``cudaLaunchKernel``, ``cuLaunchKernel*``) per traced call (layer: host
dispatch)."""


def read(trace, ctx):
    return trace.launches / trace.n_calls if trace.n_calls else None
