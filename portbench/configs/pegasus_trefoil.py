"""The `pegasus_trefoil` configuration's scene: upstream `examples/pegasus.rs`
(through the JAX package's `examples/pegasus.py`) with two assets replaced.

An ice mesh, `transparent_colored(0xF8F8FF, 1.31, 0.2)`, on a 4x4 floor
polygon at y = -0.01 in `diffuse(0xDDDDDD)`, under an equirectangular HDRI
and no light of any kind, seen by the script's camera at EV -1.5. The mesh
is the 120,000-triangle trefoil knot (the pegasus is an asset) and the map
the procedural sky (the HDRI is an asset). A frozen copy of the port's
builders (`rpt_tpu_torch/scenes.py` `trefoil_mesh`, `procedural_sky`,
`build_pegasus_scene`), so a later edit of the port cannot move the inputs.
"""

from __future__ import annotations

import numpy as np

from portbench.spec import (CameraSpec, MaterialSpec, MeshSpec, ObjectSpec, SceneSpec, flat_normals, hex_color,
                            rotation, scaling, translation)


def trefoil(segments: int, sides: int, radius: float):
    """(vertices, normals), each (2 * segments * sides, 3, 3): a trefoil
    torus knot of roughly unit size with smooth normals."""
    t = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    c = np.stack([np.sin(t) + 2.0 * np.sin(2.0 * t), np.cos(t) - 2.0 * np.cos(2.0 * t), -np.sin(3.0 * t)], -1) * 0.11
    c[:, 1] += 0.04
    dt = np.roll(c, -1, 0) - np.roll(c, 1, 0)
    tang = dt / np.linalg.norm(dt, axis=-1, keepdims=True)
    n1 = np.cross(tang, np.array([0.0, 0.0, 1.0]))
    n1 /= np.maximum(np.linalg.norm(n1, axis=-1, keepdims=True), 1e-12)
    n2 = np.cross(tang, n1)
    phi = np.linspace(0.0, 2.0 * np.pi, sides, endpoint=False)
    ring = np.cos(phi)[None, :, None] * n1[:, None, :] + np.sin(phi)[None, :, None] * n2[:, None, :]
    pts = c[:, None, :] + radius * ring
    idx = np.arange(segments * sides).reshape(segments, sides)
    i_next = np.roll(idx, -1, axis=0)
    quads = np.stack([idx.ravel(), i_next.ravel(), np.roll(i_next, -1, axis=1).ravel(),
                      np.roll(idx, -1, axis=1).ravel()], -1)
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    return pts.reshape(-1, 3)[tris], ring.reshape(-1, 3)[tris]


def procedural_sky(height: int, sun_azimuth: float, sun_polar: float, sun_intensity: float) -> np.ndarray:
    """Gradient sky, warm sun disk and dim ground, (H, 2H, 3) float32."""
    width = height * 2
    polar = (np.arange(height) + 0.5) / height * np.pi
    azim = (np.arange(width) + 0.5) / width * 2.0 * np.pi
    pol, az = np.meshgrid(polar, azim, indexing="ij")
    t = np.clip(np.cos(pol), 0.0, 1.0)[..., None]
    zenith = np.array([0.22, 0.38, 0.78])
    horizon = np.array([0.85, 0.82, 0.75])
    img = np.where((pol > np.pi / 2)[..., None], np.array([0.18, 0.15, 0.12]), horizon + (zenith - horizon) * t)
    cos_angle = np.sin(pol) * np.sin(sun_polar) * np.cos(az - sun_azimuth) + np.cos(pol) * np.cos(sun_polar)
    sun = np.exp((cos_angle - 1.0) * 1200.0)[..., None]
    return (img + sun * sun_intensity * np.array([1.0, 0.9, 0.75])).astype(np.float32)


def build(cfg: dict) -> SceneSpec:
    m = cfg["mesh"]
    verts, norms = trefoil(m["segments"], m["sides"], m["radius"])
    place = scaling([m["scale"]] * 3)
    if m.get("rotate_y"):
        place = rotation(m["rotate_y"], (0.0, 1.0, 0.0)) @ place
    place = translation(m["translate"]) @ place
    ice, fl = cfg["ice"], cfg["floor"]
    y, h = fl["y"], fl["half"]
    floor = np.array([[[h, y, h], [h, y, -h], [-h, y, -h]], [[h, y, h], [-h, y, -h], [-h, y, h]]], np.float64)
    sky = cfg["sky"]
    cam = cfg["camera"]
    return SceneSpec(
        meshes=[MeshSpec(verts, norms), MeshSpec(floor, flat_normals(floor))],
        objects=[
            ObjectSpec(MaterialSpec(hex_color(int(ice["color"], 16)), float(ice["index"]), float(ice["roughness"]),
                                    0.0, 0.0, True), mesh=0, matrix=place),
            ObjectSpec(MaterialSpec(hex_color(int(fl["color"], 16)), 1.5, 1.0, 0.0, 0.0, False), mesh=1,
                       matrix=np.eye(4)),
        ],
        lights=[],
        camera=CameraSpec(tuple(cam["eye"]), tuple(cam["center"]), tuple(cam["up"]), float(cam["fov"])),
        width=cfg["width"], height=cfg["height"], spp=cfg["spp"], max_bounces=cfg["max_bounces"],
        exposure_value=cfg["exposure_value"], epsilon=cfg["epsilon"],
        hdri=procedural_sky(sky["height"], sky["sun_azimuth"], sky["sun_polar"], sky["sun_intensity"]),
    )
