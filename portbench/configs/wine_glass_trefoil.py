"""The `wine_glass_trefoil` configuration's scene: upstream
`examples/wine_glass.rs` (through the JAX package's `examples/wine_glass.py`)
with its two assets replaced.

A clear glass mesh, `Material.clear(1.5, 0.0001)`, on a 10x10 floor polygon
at y = 0 in `diffuse(0x6F5D48)`, lit by one invisible emissive sphere of
radius 3 and emittance 200 at (11.15, 13.739, -4.9325), under the script's
solid environment (0.25, 0.25, 0.28) (it streams an HDRI otherwise), seen
by the script's camera. The mesh is the 120,000-triangle trefoil knot (the
glass is an asset). A frozen copy of the port's builders
(`rpt_tpu_torch/scenes.py` `build_wine_glass_trefoil_scene`,
`wine_glass_camera`); the knot is the `pegasus_trefoil` builder's.
"""

from __future__ import annotations

import os

import numpy as np

from portbench import registry
from portbench.spec import (CameraSpec, LightSpec, MaterialSpec, MeshSpec, ObjectSpec, SceneSpec, flat_normals,
                            hex_color, rotation, scaling, translation)

trefoil = registry._module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "pegasus_trefoil.py")).trefoil


def build(cfg: dict) -> SceneSpec:
    m = cfg["mesh"]
    verts, norms = trefoil(m["segments"], m["sides"], m["radius"])
    place = translation(m["translate"]) @ (rotation(m["rotate_y"], (0.0, 1.0, 0.0)) @ scaling([m["scale"]] * 3))
    glass, fl, light = cfg["glass"], cfg["floor"], cfg["light"]
    y, h = fl["y"], fl["half"]
    # The polygon (-h, -h), (-h, h), (h, h), (h, -h) fanned from its first corner.
    floor = np.array([[[-h, y, -h], [-h, y, h], [h, y, h]], [[-h, y, -h], [h, y, h], [h, y, -h]]], np.float64)
    cam = cfg["camera"]
    eye = np.asarray(cam["eye"], np.float64)
    center = eye + np.asarray(cam["direction"], np.float64)
    return SceneSpec(
        meshes=[MeshSpec(verts, norms), MeshSpec(floor, flat_normals(floor))],
        objects=[
            ObjectSpec(MaterialSpec(tuple(float(c) for c in glass["color"]), float(glass["index"]),
                                    float(glass["roughness"]), 0.0, 0.0, True), mesh=0, matrix=place),
            ObjectSpec(MaterialSpec(hex_color(int(fl["color"], 16)), 1.5, 1.0, 0.0, 0.0, False), mesh=1,
                       matrix=np.eye(4)),
        ],
        lights=[LightSpec("sphere", hex_color(int(light["color"], 16)),
                          matrix=translation(light["center"]) @ scaling([light["radius"]] * 3),
                          emittance=float(light["emittance"]))],
        camera=CameraSpec(tuple(eye.tolist()), tuple(center.tolist()), tuple(cam["up"]), float(cam["fov"])),
        width=cfg["width"], height=cfg["height"], spp=cfg["spp"], max_bounces=cfg["max_bounces"],
        exposure_value=cfg["exposure_value"], epsilon=cfg["epsilon"], env_color=tuple(cfg["env_color"]),
    )
