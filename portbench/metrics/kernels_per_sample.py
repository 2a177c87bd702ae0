"""Device kernels of the traced stretch per sample in it (copies and sets
left out). It repeats exactly from run to run; fusing kernels lowers it."""


def read(ctx):
    if ctx.trace is None or not ctx.stretch_samples:
        return None
    return len(ctx.trace.kernels()) / ctx.stretch_samples
