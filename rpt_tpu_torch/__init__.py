"""rpt_tpu_torch -- the rpt_tpu path tracer ported to PyTorch and CUDA.

A second package beside the JAX reference `rpt_tpu`, with the same module
layout and public names: scene building and compilation (analytic
primitives, monomial surfaces, baked and instanced meshes, solid and HDRI
environments), OBJ+MTL, STL and image IO, the masked and sorted wavefront
integrator, the many-sample renderer with checkpoints, profiling, and
animation (the `ode` subpackage's RK4 particle systems, and
`Renderer(dynamic=True)`, one CUDA graph per scene topology), and, in
the `parallel` subpackage, which is imported on its own, rendering with
the pixels sharded over several devices or processes.
Mesh traversal and the threefry PRNG run in hand-written CUDA
kernels for Hopper (`csrc/bvh8.cu`, `csrc/tlas8.cu`, `csrc/bvh2.cu`,
`csrc/tlas2.cu`, `csrc/threefry.cu`) on a CUDA card, where each sample pass
is one CUDA graph replay, and in their plain torch versions on the CPU.
Entry points run on the card unless the caller passes device="cpu".
"""

from .buffer import Buffer, Filter
from .camera import Camera
from .color import SRGB_GAMMA, color_bytes, hex_color
from .environment import Environment
from .io.obj import load_obj, load_obj_with_mtl
from .io.stl import load_stl
from .lights import AmbientLight, DirectionalLight, ObjectLight, PointLight
from .materials import Material
from .renderer import Renderer
from .scene import Object, Scene
from .shapes import (
    Cube,
    Group,
    KdTree,
    Mesh,
    MonomialSurface,
    Plane,
    Sphere,
    Transformed,
    cube,
    group,
    monomial_surface,
    plane,
    polygon,
    sphere,
    triangle_mesh,
)

__version__ = "0.1.0"

__all__ = [
    "Buffer",
    "Filter",
    "Camera",
    "SRGB_GAMMA",
    "color_bytes",
    "hex_color",
    "Environment",
    "AmbientLight",
    "DirectionalLight",
    "ObjectLight",
    "PointLight",
    "Material",
    "Renderer",
    "Object",
    "Scene",
    "Cube",
    "Group",
    "KdTree",
    "Mesh",
    "MonomialSurface",
    "Plane",
    "Sphere",
    "Transformed",
    "cube",
    "group",
    "monomial_surface",
    "plane",
    "polygon",
    "sphere",
    "triangle_mesh",
    "load_obj",
    "load_obj_with_mtl",
    "load_stl",
]
