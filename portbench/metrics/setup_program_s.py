"""Seconds of set-up spent in the port's rare events before the window: the
length of the union of the intervals of its `rpt.scene.build`,
`rpt.graph.capture` and `rpt.kernels.load` spans (a scene build, a CUDA
graph capture with its eager warm-up, a kernel library's load and build),
which the port records always. The part of `setup_s` the program owns,
apart from the process's start, `import torch` and the CUDA context. None
where the port records no such span."""

RARE = ("rpt.scene.build", "rpt.graph.capture", "rpt.kernels.load")


def read(ctx):
    if ctx.trace is None:
        return None
    from rpt_tpu_torch import profiling

    window = ctx.window_start * 1e9
    spans = sorted((s.start_ns, s.end_ns) for s in getattr(profiling, "spans", list)()
                   if s.name in RARE and s.end_ns <= window)
    total, last = 0, float("-inf")
    for start, end in spans:
        if end > last:
            total += end - max(start, last)
            last = end
    return total / 1e9 if spans else None
