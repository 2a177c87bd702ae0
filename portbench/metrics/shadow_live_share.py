"""The share, in percent, of the lanes handed to the shadow rays' any-hit
queries in the traced stretch that were live (their path had found a
surface), from the port's device-side lane counts (`shadow_lanes`,
`shadow_live_lanes` in `rpt_tpu_torch.kernels.launch_counts`) read before
and after it. None where the port keeps no such count or cast no shadow ray."""


def read(ctx):
    if not ctx.launches or not ctx.launches.get("shadow_lanes"):
        return None
    return 100.0 * ctx.launches.get("shadow_live_lanes", 0) / ctx.launches["shadow_lanes"]
