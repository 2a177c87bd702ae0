"""Millions of rays a second: every ray of the frames completed in the
window (`rays.frame_rays`) over the time from the window's start to the
last frame's end, by the host's clock."""


def read(ctx):
    if not ctx.frames:
        return None
    return ctx.rays_per_frame * len(ctx.frames) / (ctx.frames[-1].end - ctx.window_start) / 1e6
