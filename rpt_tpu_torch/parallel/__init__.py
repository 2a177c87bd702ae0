"""Rendering with the ray wavefront sharded over several devices or
processes (`rpt_tpu/parallel`). Not imported by `rpt_tpu_torch` itself."""

from .sharding import (
    RayMesh,
    make_ray_mesh,
    make_sharded_diff_fn,
    make_sharded_render_fn,
    make_sharded_many_fn,
    render_distributed,
    render_pass_sharded,
)
from .multihost import (
    init_multihost,
    is_multihost,
    make_global_ray_mesh,
    render_multihost,
)

__all__ = [
    "RayMesh",
    "make_ray_mesh",
    "make_sharded_render_fn",
    "make_sharded_diff_fn",
    "render_pass_sharded",
    "make_sharded_many_fn",
    "render_distributed",
    "init_multihost",
    "is_multihost",
    "make_global_ray_mesh",
    "render_multihost",
]
