"""Launches of the port's fused scatter kernel (both types) per sample of the
traced stretch, from the port's own device-side launch counters
(`rpt_tpu_torch.kernels.launch_counts`) read before and after it: one a
depth below `max_bounces` where the wavefront takes the kernel, 0 where it
takes the plain torch version. A tree without the kernel has no such
counter, and then there is nothing to read."""


def read(ctx):
    if ctx.launches is None or not ctx.stretch_samples or "scatter" not in ctx.launches:
        return None
    return ctx.launches["scatter"] / ctx.stretch_samples
