"""Carry a compiled scene and a camera across from their array form.

A path tracer's state is its compiled scene. `scene_data_from_arrays` takes
the leaves of a compiled scene as a nested dict of numpy arrays keyed by the
field names of the JAX package's `SceneData` (materials, spheres, cubes,
planes, monomials, triangles, bvh, lights, environment), with the lights
as a list of dicts tagged with their class name under "type" and the
environment as a dict of its `color`, `hdri` and `hdri_quad` (the
reference's 12-column quad table, padded here to the port's 13; absent or
None for the 4-gather form), and rebuilds the port's
`SceneData` on a device. The kernels' layouts are packed afresh from the
given binary BVH, and from the given instanced meshes (the 16 fields of
`InstancedMeshes` under "instanced"), by the same decision as
`Scene.compile` (`scene.choose_bvh_pack`, `scene.choose_instanced_pack`), so
a converted scene takes the same kernels as a compiled one. TPU kernel
layouts in the dict are ignored. So both packages can be run on
the very same compiled scene, BVH and two-level tree. A scene compiled in
float64 (its material colors are float64) is carried in float64, every
float array at its own precision; one in float32 stays float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .environment import Environment, pad_quad
from .lights import (
    AmbientLightData,
    CubeLightData,
    DirectionalLightData,
    MeshLightData,
    MonomialLightData,
    PointLightData,
    SphereLightData,
)
from .camera import Camera
from .materials import MaterialTable
from .ode import ParticleState
from .ops.bvh import bvh_from_arrays
from .ops.tlas import instanced_from_arrays
from .scene import (
    MonomialArrays,
    PlaneArrays,
    PrimXf,
    SceneData,
    TriangleArrays,
    choose_bvh_pack,
    choose_instanced_pack,
)
from .utils.device import resolve_device

__all__ = ["scene_data_from_arrays", "camera_from_arrays", "particle_state_from_arrays"]

_LIGHTS = {
    cls.__name__: cls
    for cls in (PointLightData, AmbientLightData, DirectionalLightData, SphereLightData, CubeLightData, MeshLightData,
                MonomialLightData)
}


def _tensors(d: dict, device, dtype, ints=("mat_id",)) -> dict:
    return {
        k: torch.as_tensor(np.ascontiguousarray(v), dtype=torch.int32 if k in ints else dtype, device=device)
        for k, v in d.items()
    }


def scene_data_from_arrays(tree: dict, device=None) -> SceneData:
    """The port's SceneData from the array form of a compiled scene."""
    device = resolve_device(device)
    env = tree["environment"]
    dtype = torch.float64 if np.asarray(tree["materials"]["color"]).dtype == np.float64 else torch.float32

    def group(cls, key):
        return None if tree.get(key) is None else cls(**_tensors(tree[key], device, dtype))

    lights = []
    for spec in tree["lights"]:
        spec = dict(spec)
        lights.append(_LIGHTS[spec.pop("type")](**_tensors(spec, device, dtype, ints=())))

    bvh = mesh_pack = None
    if tree.get("bvh") is not None:
        bvh = bvh_from_arrays(tree["bvh"], device, dtype)
        mesh_pack = choose_bvh_pack(bvh, device=device)
    instanced = instance_pack = None
    if tree.get("instanced") is not None:
        instanced = instanced_from_arrays(tree["instanced"], device, dtype)
        instance_pack = choose_instanced_pack(instanced, device=device)
    hdri, quad = env.get("hdri"), env.get("hdri_quad")
    environment = Environment(color=np.asarray(env["color"], np.float32).reshape(3),
                              hdri=None if hdri is None else np.asarray(hdri, np.float32),
                              hdri_quad=None if quad is None else pad_quad(quad))
    env_color, env_hdri, env_quad = environment.tensors(device, dtype)
    return SceneData(
        materials=MaterialTable(**_tensors(tree["materials"], device, dtype, ints=())),
        spheres=group(PrimXf, "spheres"),
        cubes=group(PrimXf, "cubes"),
        planes=group(PlaneArrays, "planes"),
        monomials=group(MonomialArrays, "monomials"),
        triangles=group(TriangleArrays, "triangles"),
        bvh=bvh,
        mesh_pack=mesh_pack,
        instanced=instanced,
        instance_pack=instance_pack,
        lights=tuple(lights),
        environment=environment,
        env_color=env_color,
        device=device,
        env_hdri=env_hdri,
        env_quad=env_quad,
        digest=str(tree.get("digest", "")),
    )


def camera_from_arrays(arrays: dict) -> Camera:
    """A Camera from a dict of its fields (eye, direction, up, fov, aperture,
    focal_distance) as arrays."""
    return Camera(**{k: np.asarray(v, np.float32) for k, v in arrays.items()})


def particle_state_from_arrays(pos, vel, device=None):
    """An `ode.ParticleState` from arrays of positions and velocities, each
    (N, 3), on `device` (the CUDA card when None)."""
    return ParticleState.create(np.asarray(pos, np.float32), np.asarray(vel, np.float32), device=device)
