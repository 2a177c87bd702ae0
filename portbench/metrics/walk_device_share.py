"""The share, in percent, of the stretch's kernel time spent in the port's
traversal kernels (`<family>_walk<...>`, closest hit and any hit)."""

from portbench.devtrace import kernel_percent, walk_kind


def read(ctx):
    if ctx.trace is None or not any(walk_kind(n) for n, _, _ in ctx.trace.kernels()):
        return None
    return kernel_percent(ctx.trace, lambda name: walk_kind(name) is not None)
