"""Megabytes (1e6 bytes) fed to the scene's content digest per digest of the
traced frame (`rpt.scene.digest`'s `bytes`: every mesh's vertices and
normals as float64, the environment map's bytes, and the tags and
materials' text), from the spans the port records while the traced
stretch's profiler runs. An exact count: a digest that skipped unchanged
content would take it towards 0. None where the port records no such span."""


def read(ctx):
    if ctx.trace is None:
        return None
    from rpt_tpu_torch import profiling

    frames = [(f.start * 1e9, f.end * 1e9) for f in ctx.frames if f.k in ctx.traced]
    spans = [s for s in getattr(profiling, "spans", list)()
             if s.name == "rpt.scene.digest" and any(a <= s.start_ns and s.end_ns <= b for a, b in frames)]
    return sum(s.attrs["bytes"] for s in spans) / len(spans) / 1e6 if spans else None
