"""Milliseconds a traced frame spends in the port's host tone map of its
image (`rpt.image.tonemap`: `color_bytes`'s clip, gamma and rounding on the
host, after the image's copy), summed over the frame, from the spans the
port records while the traced stretch's profiler runs. None where the port
records no such span."""


def read(ctx):
    if ctx.trace is None:
        return None
    from rpt_tpu_torch import profiling

    frames = [(f.start * 1e9, f.end * 1e9) for f in ctx.frames if f.k in ctx.traced]
    spans = [s for s in getattr(profiling, "spans", list)()
             if s.name == "rpt.image.tonemap" and any(a <= s.start_ns and s.end_ns <= b for a, b in frames)]
    return sum(s.end_ns - s.start_ns for s in spans) / len(frames) / 1e6 if spans else None
