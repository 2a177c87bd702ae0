"""The device's idle share of the traced stretch, in percent: 1 less the
union of every device operation's interval (torch.profiler, CUPTI) over the
stretch's length."""

from portbench.devtrace import idle_percent


def read(ctx):
    return idle_percent(ctx.trace) if ctx.trace is not None else None
