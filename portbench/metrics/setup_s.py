"""Seconds from the process's start to the window's start: imports, the
CUDA context, the kernel libraries, the scene, the renderer and one warm
frame, which compiles the scene and captures the sample's graph."""


def read(ctx):
    return ctx.setup_s
