"""The mean time, in milliseconds, of the port's scene compile over the
traced frame's calls (`rpt.scene.compile`: the scene's content digest and
the cache's lookup; once a frame in `render()`, once an update in
`iterative_render()`), from the spans the port records while the traced
stretch's profiler runs (`rpt_tpu_torch.profiling.spans()`). None where the
port records no such span."""


def traced_spans(ctx, name: str) -> list:
    """The port's spans named `name` that lie inside the traced frames."""
    if ctx.trace is None:
        return []
    from rpt_tpu_torch import profiling

    frames = [(f.start * 1e9, f.end * 1e9) for f in ctx.frames if f.k in ctx.traced]
    return [s for s in getattr(profiling, "spans", list)()
            if s.name == name and any(a <= s.start_ns and s.end_ns <= b for a, b in frames)]


def read(ctx):
    spans = traced_spans(ctx, "rpt.scene.compile")
    return sum(s.end_ns - s.start_ns for s in spans) / len(spans) / 1e6 if spans else None
