"""The traversal kernels' share of their bandwidth bound, in percent: the
least time over the measured time, summed over every walk launch of the
traced stretch.

A launch's least time is the bytes its contract needs over the card's
published memory bandwidth (`peaks.json`): each ray of the wavefront read
once (origin, direction and its t range: 8 reals) and its answer written
once ((t, id): a real and an int32 for a closest hit; a bool for an any
hit). The scene's geometry is left out, since a walk reads only part of it,
and so is an operation bound, which would depend on the tree. Every launch
of the port's render walks the whole wavefront of width x height rays (the
lanes a sort or a mask leaves idle included)."""

from portbench.devtrace import walk_kind


def bytes_of(rays: int, any_hit: bool, real: int) -> int:
    return rays * (8 * real + (1 if any_hit else real + 4))


def read(ctx):
    if ctx.trace is None or ctx.peak is None:
        return None
    rays = ctx.spec.width * ctx.spec.height
    least = measured = 0.0
    for name, s, e in ctx.trace.kernels():
        kind = walk_kind(name)
        if kind is not None:
            least += bytes_of(rays, *kind) / ctx.peak["hbm_bytes_per_s"]
            measured += (e - s) * 1e-6
    return 100.0 * least / measured if measured else None
