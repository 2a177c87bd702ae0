"""Launches of the port's threefry kernel (both widths) per sample of the
traced stretch, from the port's own device-side launch counters
(`rpt_tpu_torch.kernels.launch_counts`) read before and after it."""


def read(ctx):
    if ctx.launches is None or not ctx.stretch_samples:
        return None
    n = ctx.launches.get("_threefry", 0) + ctx.launches.get("_threefry64", 0)
    return n / ctx.stretch_samples if n else None
