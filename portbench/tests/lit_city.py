"""A lit, instanced scene for the CPU tests: the reference's lights,
next-event estimation, shadow rays, instances and planes against the
port's, which no cell of the benchmark drives yet (the scripts that light
their scenes render assets absent here).

Studded-brick meshes (every (nx, nz, segments) combination), towers of
transformed instances drawn from them, drawn materials (metallic, clear
glass, specular), a diffuse ground plane, an invisible emissive sphere and
a point light, from `default_rng(cfg["scene"]["seed"])`.
"""

from __future__ import annotations

import math

import numpy as np

from portbench.spec import (CameraSpec, LightSpec, MaterialSpec, MeshSpec, ObjectSpec, SceneSpec, flat_normals,
                            rotation, scaling, translation)


def stud_brick(nx: int, nz: int, segments: int) -> np.ndarray:
    """(T, 3, 3) float64 triangles of an nx x nz studded brick at the origin."""
    tris = []

    def quad(a, b, c, d):
        tris.append([a, b, c])
        tris.append([a, c, d])

    h = 1.2
    v = [(x, y, z) for z in (0.0, float(nz)) for (x, y) in ((0.0, 0.0), (float(nx), 0.0), (float(nx), h), (0.0, h))]
    quad(v[0], v[3], v[2], v[1])
    quad(v[4], v[5], v[6], v[7])
    quad(v[0], v[1], v[5], v[4])
    quad(v[1], v[2], v[6], v[5])
    quad(v[2], v[3], v[7], v[6])
    quad(v[3], v[0], v[4], v[7])
    r, top = 0.3, h + 0.35
    for i in range(nx):
        for j in range(nz):
            cx, cz = i + 0.5, j + 0.5
            for k in range(segments):
                a0 = 2.0 * math.pi * k / segments
                a1 = 2.0 * math.pi * (k + 1) / segments
                p0 = (cx + r * math.cos(a0), h, cz + r * math.sin(a0))
                p1 = (cx + r * math.cos(a1), h, cz + r * math.sin(a1))
                q0 = (p0[0], top, p0[2])
                q1 = (p1[0], top, p1[2])
                quad(p0, p1, q1, q0)
                tris.append([(cx, top, cz), q0, q1])
    return np.asarray(tris, np.float64)


def build(cfg: dict) -> SceneSpec:
    sc = cfg["scene"]
    rng = np.random.default_rng(sc["seed"])
    shapes = [(nx, nz, seg) for nx in (1, 2, 3, 4) for nz in (1, 2) for seg in range(14, 38)]
    mats = []
    for m in range(sc["materials"]):
        col = tuple(float(c) for c in 0.25 + 0.7 * rng.random(3))
        if m % 7 == 0:
            mats.append(MaterialSpec(col, 1.5, float(0.2 + 0.3 * rng.random()), 1.0, 0.0, False))
        elif m % 11 == 0:
            mats.append(MaterialSpec((1.0, 1.0, 1.0), 1.5, 0.05, 0.0, 0.0, True))
        else:
            mats.append(MaterialSpec(col, 1.5, float(0.1 + 0.5 * rng.random()), 0.0, 0.0, False))

    mesh_slot: dict = {}
    meshes, objects = [], []
    n_instances, per_tower = sc["instances"], sc["per_tower"]
    idx = 0
    for t in range(max(1, n_instances // per_tower)):
        bx = (t % 4 - 1.5) * 8.0
        bz = (t // 4 - 1.5) * 8.0
        for row in range(12):
            for col in range(4):
                if idx >= n_instances:
                    break
                shape = shapes[rng.integers(len(shapes))]
                mat = mats[rng.integers(len(mats))]
                s = 0.45 + 0.15 * rng.random()
                angle = float(rng.random() * 0.3 - 0.15)
                offset = [bx + col * 2.0 + 0.2 * rng.random(), row * 0.8, bz + 0.2 * rng.random()]
                # Composed as the port's fluent transforms compose: each new
                # matrix on the left of the accumulated one.
                matrix = translation(offset) @ (rotation(angle, (0.0, 1.0, 0.0)) @ (scaling([s, s, s]) @ np.eye(4)))
                if shape not in mesh_slot:
                    mesh_slot[shape] = len(meshes)
                    tris = stud_brick(*shape)
                    meshes.append(MeshSpec(tris, flat_normals(tris)))
                objects.append(ObjectSpec(mat, mesh=mesh_slot[shape], matrix=matrix))
                idx += 1
    objects.append(ObjectSpec(MaterialSpec((0.6, 0.6, 0.62), 1.5, 1.0, 0.0, 0.0, False), normal=(0.0, 1.0, 0.0),
                              value=0.0))
    light = translation([10.0, 30.0, 20.0]) @ scaling([5.0, 5.0, 5.0])
    cam = cfg["camera"]
    return SceneSpec(
        meshes=meshes,
        objects=objects,
        lights=[LightSpec("sphere", (1.0, 1.0, 1.0), matrix=light, emittance=40.0),
                LightSpec("point", (30.0, 30.0, 30.0), position=(-12.0, 18.0, -8.0))],
        camera=CameraSpec(tuple(cam["eye"]), tuple(cam["center"]), tuple(cam["up"]), float(cam["fov"])),
        width=cfg["width"], height=cfg["height"], spp=cfg["spp"], max_bounces=cfg["max_bounces"],
        exposure_value=cfg["exposure_value"], epsilon=cfg["epsilon"],
    )
