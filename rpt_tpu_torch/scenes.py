"""The benchmark workloads' scenes, built from this package alone.

- `cornell`: a copy of `examples/cornell.py` (`build_scene`, `make_camera`)
  without the JAX imports: the literal Cornell box data, walls and the
  ceiling light as polygons (small brute-force triangle meshes), two
  transformed cubes, one emissive polygon as the only light. It runs no
  traversal kernel; the reference benchmarks it at ray offset 0.05
  (`bench.py`), `CORNELL_EPSILON`.
- `dragon`: a copy of `examples/dragon.py` (`trefoil_mesh`, `build_scene`
  and its camera) without the JAX imports: a procedural trefoil-knot
  stand-in for the 871k-triangle dragon (~120k triangles by default), a
  specular green mesh, a diffuse floor plane, an ambient light and two
  sphere area lights. `dragon871k` is the same scene at
  `target_tris=871_000`, the real dragon's triangle count.
- `lego`: a copy of `examples/lego.py`'s `build_brick_city` (the same
  `default_rng(seed)` draws, so the same scene) and `bench.py`'s camera for
  it: 768 instances of studded-brick meshes shared by many transforms,
  dozens of metallic, glass and specular materials, a ground plane, a
  sphere area light and a point light.
- `lego_toy`: a copy of `examples/lego.py`'s scene without `--zip`: a
  procedural toy brick plane written as OBJ + MTL text, loaded through
  `load_obj_with_mtl` (one object per `usemtl` run: 108 triangles, four
  materials, one of them transparent), scaled and moved as the example
  does, under one sphere area light, with the example's camera
  (`build_lego_scene` of the loaded objects, which `examples.lego` builds
  from a zip too).
- `monomial_glass`: a copy of `examples/monomial_glass.py`'s `build_scene`
  (a metallic monomial surface, a cube, two spheres, a plane, an ambient
  and a point light) under an HDRI, as the Rust original renders it: the
  map is a copy of `examples/_sky.py`'s `procedural_sky`, the asset-free
  stand-in for the downloaded one. The camera is `Camera()`.
- `monomial_light`: the scene of `tests/test_monomial_light.py`, an
  emissive monomial surface over a plane, and that test's camera.
- `dragon_orbit`: `dragon` with its large sphere light circling the
  trefoil, one frame per call; the mesh and so the scene's topology stay.
- `marbles`: a copy of `examples/marbles.py` (`initial_state`,
  `build_scene` and its camera): 25 marbles of radius 0.15 falling into a
  clear height-2 monomial glass on a table polygon, under the sphere light
  at y = 5 (or an ambient light in the example's test mode); the state
  advances by `ode.MarblesSystem(0.15)`.
- `pegasus_trefoil`: `examples/pegasus.py`'s scene (an ice mesh on a 4x4
  floor under a procedural sky, no light of any kind; EV -1.5) and camera,
  with the 120k-triangle trefoil in place of the pegasus mesh (an asset).
- `wine_glass_trefoil`: `examples/wine_glass.py`'s scene without an HDR
  (a clear mesh on a 10x10 floor, a solid environment, one sphere light)
  and camera, with the 120k-triangle trefoil in place of the glass (an
  asset).
- `fractal_spheres`: a copy of `examples/fractal_spheres.py` (and of
  `examples/_fractal.py`'s recursion): 937 specular spheres in five levels
  (1, 6, 30, 150, 750), a plane, an ambient, a directional and a point
  light, and the example's camera.
- `fractal_teapots_trefoil`: `examples/fractal_teapots.py`'s scene around
  the trefoil cut to the teapot's size (`TEAPOT_KNOT`, 2,256 triangles; the
  teapot is an asset): 937 instances of one mesh, so the two-level path.
- `compound`: a copy of `examples/compound.py` (`lamp`, `build_scene`,
  `make_camera`): five specular cubes turned by the magic angle about
  (1, 1, 1), three of them mirrored (a transform of negative determinant),
  on a white floor under three sphere lamps. It runs no traversal kernel.

Where an example reads its mesh from an asset, its scene is one function
here that takes the mesh (`build_pegasus_scene`, `build_wine_glass_scene`,
`build_fractal_teapots_scene`, `build_dragon_scene(mesh=...)`,
`build_lego_scene`): the example module (`rpt_tpu_torch.examples`) calls
it on the loaded mesh and the workload on the trefoil.
"""

from __future__ import annotations

import io
import math
from typing import Optional

import numpy as np

from .camera import Camera
from .color import hex_color
from .environment import Environment
from .lights import AmbientLight, DirectionalLight, ObjectLight, PointLight
from .materials import Material
from .ode import ParticleState
from .ode.particle import monomial_closest_point
from .scene import Object, Scene
from .shapes import Mesh, Transformed, cube, group, monomial_surface, plane, polygon, sphere, triangle_mesh

__all__ = [
    "build_cornell_scene",
    "cornell_camera",
    "CORNELL_EPSILON",
    "trefoil_mesh",
    "dragon_knot_size",
    "build_dragon_scene",
    "dragon_camera",
    "build_brick_city",
    "lego_camera",
    "TOY_MTL",
    "toy_plane_obj",
    "build_lego_scene",
    "build_toy_plane_scene",
    "toy_plane_camera",
    "procedural_sky",
    "build_monomial_glass_scene",
    "monomial_glass_camera",
    "build_monomial_light_scene",
    "monomial_light_camera",
    "build_dragon_orbit_scene",
    "marbles_initial_state",
    "marbles_camera",
    "build_marbles_scene",
    "PEGASUS_TREFOIL",
    "build_pegasus_scene",
    "build_pegasus_trefoil_scene",
    "pegasus_camera",
    "WINE_GLASS_TREFOIL",
    "build_wine_glass_scene",
    "build_wine_glass_trefoil_scene",
    "wine_glass_camera",
    "LEVEL_COLORS",
    "fractal_placements",
    "build_fractal_spheres_scene",
    "fractal_spheres_camera",
    "TEAPOT_KNOT",
    "build_fractal_teapots_scene",
    "compound_lamp",
    "build_compound_scene",
    "compound_camera",
    "scene_and_camera",
]


CORNELL_EPSILON = 0.05
_TWO_PI = 6.283185307179586


def build_cornell_scene() -> Scene:
    """The Cornell box of `examples/cornell.py`."""
    scene = Scene()
    white = Material.diffuse(hex_color(0xAAAAAA))
    red = Material.diffuse(hex_color(0xBC0000))
    green = Material.diffuse(hex_color(0x00BC00))
    light_mtl = Material.light(hex_color(0xFFFEFA), 100.0)
    floor = polygon([[0, 0, 0], [0, 0, 559.2], [556, 0, 559.2], [556, 0, 0]])
    ceiling = polygon([[0, 548.9, 0], [556, 548.9, 0], [556, 548.9, 559.2], [0, 548.9, 559.2]])
    light_rect = polygon([[343.0, 548.8, 227.0], [343.0, 548.8, 332.0], [213.0, 548.8, 332.0],
                          [213.0, 548.8, 227.0]])
    back_wall = polygon([[0, 0, 559.2], [0, 548.9, 559.2], [556, 548.9, 559.2], [556, 0, 559.2]])
    right_wall = polygon([[0, 0, 0], [0, 548.9, 0], [0, 548.9, 559.2], [0, 0, 559.2]])
    left_wall = polygon([[556, 0, 0], [556, 0, 559.2], [556, 548.9, 559.2], [556, 548.9, 0]])
    large_box = (cube().scale([165.0, 330.0, 165.0]).rotate_y(_TWO_PI * (-253.0 / 360.0))
                 .translate([368.0, 165.0, 351.0]))
    small_box = (cube().scale([165.0, 165.0, 165.0]).rotate_y(_TWO_PI * (-197.0 / 360.0))
                 .translate([185.0, 82.5, 169.0]))
    scene.add(Object(floor).material(white))
    scene.add(Object(ceiling).material(white))
    scene.add(Object(back_wall).material(white))
    scene.add(Object(left_wall).material(red))
    scene.add(Object(right_wall).material(green))
    scene.add(Object(large_box).material(white))
    scene.add(Object(small_box).material(white))
    scene.add(ObjectLight(Object(light_rect).material(light_mtl)))
    return scene


def cornell_camera() -> Camera:
    return Camera(eye=(278.0, 273.0, -800.0), direction=(0.0, 0.0, 1.0), fov=0.686)


def trefoil_mesh(segments: int = 600, sides: int = 100, radius: float = 0.09):
    """High-poly trefoil torus knot: 2*segments*sides triangles, smooth
    normals, roughly unit scale centered at the origin."""
    t = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    cx = np.sin(t) + 2.0 * np.sin(2.0 * t)
    cy = np.cos(t) - 2.0 * np.cos(2.0 * t)
    cz = -np.sin(3.0 * t)
    c = np.stack([cx, cy, cz], -1) * 0.11
    c[:, 1] += 0.04
    dt = np.roll(c, -1, 0) - np.roll(c, 1, 0)
    tang = dt / np.linalg.norm(dt, axis=-1, keepdims=True)
    ref = np.array([0.0, 0.0, 1.0])
    n1 = np.cross(tang, ref)
    n1 /= np.maximum(np.linalg.norm(n1, axis=-1, keepdims=True), 1e-12)
    n2 = np.cross(tang, n1)

    phi = np.linspace(0.0, 2.0 * np.pi, sides, endpoint=False)
    ring = np.cos(phi)[None, :, None] * n1[:, None, :] + np.sin(phi)[None, :, None] * n2[:, None, :]
    pts = c[:, None, :] + radius * ring

    S, K = segments, sides
    idx = np.arange(S * K).reshape(S, K)
    i_next = np.roll(idx, -1, axis=0)
    j_next = np.roll(idx, -1, axis=1)
    jn_in = np.roll(i_next, -1, axis=1)
    quads = np.stack([idx.ravel(), i_next.ravel(), jn_in.ravel(), j_next.ravel()], -1)
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    return triangle_mesh(pts.reshape(-1, 3)[tris], ring.reshape(-1, 3)[tris])


def dragon_knot_size(target_tris: int) -> tuple:
    """(segments, sides) of a trefoil with at least `target_tris` triangles,
    the ~6:1 aspect of the default knot, as `examples/dragon.py` maps it
    (871,000 gives 1,619 x 269, 871,022 triangles)."""
    sides = max(int(round((target_tris / 12.0) ** 0.5)), 8)
    return -(-target_tris // (2 * sides)), sides


def build_dragon_scene(segments: int = 600, sides: int = 100, target_tris: Optional[int] = None,
                       mesh: Optional[Mesh] = None, light_position=(0.0, 20.0, 3.0)) -> Scene:
    """The dragon scene; the default knot has 120,000 triangles, and
    `target_tris` sizes it instead (`dragon871k`: 871,000, the real
    dragon's count). `mesh` is a trefoil made before (`trefoil_mesh`), and
    `light_position` the large sphere light's center."""
    if target_tris:
        segments, sides = dragon_knot_size(target_tris)
    scene = Scene()
    if mesh is None:
        mesh = trefoil_mesh(segments=segments, sides=sides)
    scene.add(
        Object(mesh.scale([3.4, 3.4, 3.4]).rotate_y(math.pi / 2)).material(
            Material.specular(hex_color(0xB7CA79), 0.1)
        )
    )
    scene.add(Object(plane([0.0, 1.0, 0.0], -1.0)).material(Material.diffuse(hex_color(0xAAAAAA))))
    scene.add(AmbientLight((0.01, 0.01, 0.01)))
    scene.add(
        ObjectLight(
            Object(sphere().scale([2.0, 2.0, 2.0]).translate(list(light_position))).material(
                Material.light((1.0, 1.0, 1.0), 160.0)
            )
        )
    )
    scene.add(
        ObjectLight(
            Object(sphere().scale([0.05, 0.05, 0.05]).translate([-1.0, 0.71, 0.0])).material(
                Material.light(hex_color(0xFFAAAA), 400.0)
            )
        )
    )
    return scene


def dragon_camera() -> Camera:
    return Camera.look_at((-2.5, 4.0, 6.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), math.pi / 6)


def build_dragon_orbit_scene(frame: int, frames: int, mesh: Optional[Mesh] = None) -> Scene:
    """Frame `frame` of `frames` of the `dragon_orbit` animation: the dragon
    scene with its large sphere light moved from (0, 20, 3) to
    (3 sin t, 20, 3 cos t), t = 2 pi frame / frames. The trefoil (`mesh`,
    the default knot when None) is the same every frame, so every frame has
    one topology."""
    theta = _TWO_PI * frame / frames
    return build_dragon_scene(mesh=mesh, light_position=(3.0 * math.sin(theta), 20.0, 3.0 * math.cos(theta)))


MARBLE_COLORS = (0x264653, 0x2A9D8F, 0xE9C46A, 0xF4A261, 0xE76F51)
MARBLES = 25
MARBLE_RADIUS = 0.15


def marbles_initial_state(seed: int = 123, device=None):
    """The 25 marbles of `examples/marbles.py` above the glass, at rest: a 5
    x 5 grid in x and z, heights drawn from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    pos = np.stack([np.array([(i // 5) / 5.0 - 0.375, rng.uniform(4.0, 6.0), (i % 5) / 5.0 - 0.375])
                    for i in range(MARBLES)])
    return ParticleState.create(pos, device=device)


def marbles_camera() -> Camera:
    return Camera.look_at([0.0, 1.0, 6.0], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0], math.pi / 4).focus([0.0, 1.0, 0.0], 0.02)


def build_marbles_scene(state, test_mode: bool) -> Scene:
    """`examples/marbles.py`'s frame for a particle state: the height-2
    monomial glass (clear), one specular sphere per marble (pushed out of
    the glass to 1.05 radii and onto the table, as the example draws them),
    the table polygon, and an ambient light (`test_mode`) or the sphere
    light at y = 5. Every marble of the state is drawn (the example draws
    its 25)."""
    scene = Scene()
    if test_mode:
        scene.add(AmbientLight((0.01, 0.01, 0.01)))
    else:
        scene.add(ObjectLight(Object(sphere().scale([1.5] * 3).translate([0.0, 5.0, 0.0]))
                              .material(Material.light(hex_color(0xFFFFFF), 15.0))))
    scene.add(Object(monomial_surface(2.0, 4.0)).material(Material.clear(1.5, 0.0001)))

    pos = state.pos.detach().cpu().numpy()
    closest = monomial_closest_point(state.pos, 2.0, resolution=2001).cpu().numpy()
    R = MARBLE_RADIUS
    for i in range(pos.shape[0]):
        p = pos[i].copy()
        vec = p - closest[i]
        ln = np.linalg.norm(vec)
        if ln < R * 1.05 and ln > 0:
            p = closest[i] + vec / ln * R * 1.05
        p[1] = max(p[1], R - 0.06)
        scene.add(Object(sphere().scale([R] * 3).translate(p))
                  .material(Material.specular(hex_color(MARBLE_COLORS[i % len(MARBLE_COLORS)]), 0.1)))
    scene.add(Object(polygon([[20.0, -0.06, 20.0], [20.0, -0.06, -20.0], [-20.0, -0.06, -20.0],
                              [-20.0, -0.06, 20.0]])).material(Material.diffuse(hex_color(0xAAAAAA))))
    return scene


def _stud_brick_tris(nx, nz, segments):
    """(T, 3, 3) float64 triangles for an nx x nz studded brick at the
    origin (unit stud pitch). Distinct (nx, nz, segments) give
    content-distinct meshes, each with its own BLAS."""
    tris = []

    def quad(a, b, c, d):
        tris.append([a, b, c])
        tris.append([a, c, d])

    def box(x0, y0, z0, x1, y1, z1):
        v = [
            (x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
            (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1),
        ]
        quad(v[0], v[3], v[2], v[1])
        quad(v[4], v[5], v[6], v[7])
        quad(v[0], v[1], v[5], v[4])
        quad(v[1], v[2], v[6], v[5])
        quad(v[2], v[3], v[7], v[6])
        quad(v[3], v[0], v[4], v[7])

    h = 1.2
    box(0.0, 0.0, 0.0, float(nx), h, float(nz))
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


def build_brick_city(n_instances: int = 768, seed: int = 0) -> Scene:
    """The `lego` workload's instanced scene: 192 studded-brick meshes (all
    (nx, nz, segments) combinations), towers of transformed instances drawn
    from them, 48 drawn materials (metallic, clear glass, specular), a
    ground plane, a sphere area light and a point light."""
    rng = np.random.default_rng(seed)
    meshes = [
        Mesh(_stud_brick_tris(nx, nz, seg))
        for nx in (1, 2, 3, 4)
        for nz in (1, 2)
        for seg in range(14, 38)
    ]
    mats = []
    for m in range(48):
        col = tuple(0.25 + 0.7 * rng.random(3))
        if m % 7 == 0:
            mats.append(Material.metallic_mat(col, 0.2 + 0.3 * rng.random()))
        elif m % 11 == 0:
            mats.append(Material.clear(1.5, 0.05))
        else:
            mats.append(Material.specular(col, 0.1 + 0.5 * rng.random()))

    scene = Scene()
    # Brick-wall towers on a grid: stacked rows with per-instance transforms.
    per_tower = 48
    n_towers = max(1, n_instances // per_tower)
    idx = 0
    for t in range(n_towers):
        bx = (t % 4 - 1.5) * 8.0
        bz = (t // 4 - 1.5) * 8.0
        for row in range(12):
            for col in range(4):
                if idx >= n_instances:
                    break
                mesh = meshes[rng.integers(len(meshes))]
                mat = mats[rng.integers(len(mats))]
                s = 0.45 + 0.15 * rng.random()
                node = (
                    Transformed(mesh, np.eye(4))
                    .scale([s, s, s])
                    .rotate_y(float(rng.random() * 0.3 - 0.15))
                    .translate([bx + col * 2.0 + 0.2 * rng.random(), row * 0.8, bz + 0.2 * rng.random()])
                )
                scene.add(Object(node, mat))
                idx += 1
    scene.add(Object(plane([0.0, 1.0, 0.0], 0.0)).material(Material.diffuse((0.6, 0.6, 0.62))))
    scene.add(
        ObjectLight(
            Object(sphere().scale([5.0, 5.0, 5.0]).translate([10.0, 30.0, 20.0])).material(
                Material.light((1.0, 1.0, 1.0), 40.0)
            )
        )
    )
    scene.add(PointLight((30.0, 30.0, 30.0), [-12.0, 18.0, -8.0]))
    return scene


def lego_camera() -> Camera:
    return Camera.look_at((18.0, 14.0, 26.0), (0.0, 4.0, 0.0), (0.0, 1.0, 0.0), math.pi / 5)


TOY_MTL = """
newmtl red_brick
Kd 0.8 0.1 0.1
Ks 0.5 0.5 0.5
Ns 96
newmtl white_brick
Kd 0.9 0.9 0.9
Ks 0.4 0.4 0.4
Ns 250
newmtl window
Kd 0.9 0.95 1.0
Ni 1.5
d 0.2
newmtl gray_metal
Kd 0.6 0.6 0.65
Ks 0.9 0.9 0.9
Ns 600
"""


def _box_obj(lines, x0, y0, z0, x1, y1, z1, base):
    """Append an axis-aligned box to OBJ text; returns the next vertex base."""
    vs = [
        (x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
        (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1),
    ]
    for v in vs:
        lines.append(f"v {v[0]} {v[1]} {v[2]}")
    for f in ((1, 4, 3, 2), (5, 6, 7, 8), (1, 2, 6, 5), (2, 3, 7, 6), (3, 4, 8, 7), (4, 1, 5, 8)):
        lines.append("f " + " ".join(str(base + i) for i in f))
    return base + 8


def toy_plane_obj() -> str:
    """OBJ text of a blocky toy airplane: fuselage, wings, tail, windows,
    engines, in four `usemtl` runs."""
    lines = ["# procedural toy brick plane"]
    b = 0
    lines.append("usemtl red_brick")
    b = _box_obj(lines, -120, 80, -40, 280, 160, 40, b)      # fuselage
    b = _box_obj(lines, 240, 120, -30, 330, 200, 30, b)      # nose/cockpit top
    lines.append("usemtl white_brick")
    b = _box_obj(lines, -40, 120, -300, 120, 150, 300, b)    # main wing
    b = _box_obj(lines, -160, 150, -110, -90, 180, 110, b)   # tail wing
    b = _box_obj(lines, -160, 150, -15, -100, 280, 15, b)    # tail fin
    lines.append("usemtl window")
    b = _box_obj(lines, 150, 130, -45, 230, 170, 45, b)      # canopy
    lines.append("usemtl gray_metal")
    b = _box_obj(lines, 10, 90, -210, 110, 130, -150, b)     # engine L
    b = _box_obj(lines, 10, 90, 150, 110, 130, 210, b)       # engine R
    b = _box_obj(lines, -20, 40, -60, 40, 85, 60, b)         # landing gear
    return "\n".join(lines)


def build_lego_scene(objects) -> Scene:
    """`examples/lego.py`'s `build_scene` from the objects its OBJ+MTL
    loader returned (`load_obj_with_mtl`): each scaled by 0.002 and moved
    as the example does, and one sphere area light."""
    scene = Scene()
    for obj in objects:
        scene.add(Object(obj.shape.scale([0.002, 0.002, 0.002]).translate([-0.720, -0.243, -0.770]), obj.mat))
    scene.add(
        ObjectLight(
            Object(sphere().scale([6.0, 6.0, 6.0]).translate([0.0, 20.0, 30.0])).material(
                Material.light((1.0, 1.0, 1.0), 25.0)
            )
        )
    )
    return scene


def build_toy_plane_scene() -> Scene:
    """`build_lego_scene` of the toy plane loaded through the OBJ+MTL path."""
    from .io.obj import load_obj_with_mtl

    return build_lego_scene(load_obj_with_mtl(io.StringIO(toy_plane_obj()), io.StringIO(TOY_MTL)))


def toy_plane_camera() -> Camera:
    return Camera.look_at((2.5, 2.0, 1.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), math.pi / 6)


def procedural_sky(height: int = 256, sun_azimuth: float = 1.9, sun_polar: float = 1.1,
                   sun_intensity: float = 40.0) -> np.ndarray:
    """Gradient sky, warm sun disk and dim ground as an equirectangular
    map, (H, 2H, 3) float32 (`examples/_sky.py`)."""
    width = height * 2
    polar = (np.arange(height) + 0.5) / height * np.pi  # 0 = up
    azim = (np.arange(width) + 0.5) / width * 2.0 * np.pi
    pol, az = np.meshgrid(polar, azim, indexing="ij")

    # Sky gradient: zenith blue to horizon haze.
    t = np.clip(np.cos(pol), 0.0, 1.0)[..., None]
    zenith = np.array([0.22, 0.38, 0.78])
    horizon = np.array([0.85, 0.82, 0.75])
    sky = horizon + (zenith - horizon) * t

    # Ground: dim brown below the horizon.
    ground = np.array([0.18, 0.15, 0.12])
    img = np.where((pol > np.pi / 2)[..., None], ground, sky)

    # Sun disk with a soft falloff.
    cos_angle = np.sin(pol) * np.sin(sun_polar) * np.cos(az - sun_azimuth) + np.cos(pol) * np.cos(sun_polar)
    sun = np.exp((cos_angle - 1.0) * 1200.0)[..., None]
    img = img + sun * sun_intensity * np.array([1.0, 0.9, 0.75])
    return img.astype(np.float32)


def build_monomial_glass_scene(sky_height: int = 256, environment: Optional[Environment] = None) -> Scene:
    """`examples/monomial_glass.py`'s scene under `environment`, or, when
    None, under `procedural_sky(sky_height)`, as the Rust original renders
    it under an HDRI."""
    scene = Scene()
    scene.set_environment(environment if environment is not None
                          else Environment.from_hdri(procedural_sky(sky_height)))
    scene.add(Object(monomial_surface(2.0, 4.0).translate([0.0, -1.0, 0.0]))
              .material(Material.metallic_mat(hex_color(0xFFFFFF), 0.0001)))
    scene.add(Object(cube().rotate_y(math.pi / 6.0).scale([0.5, 0.3, 0.4]).translate([0.4, -0.8, 4.0]))
              .material(Material.specular(hex_color(0xFF00FF), 0.5)))
    scene.add(Object(sphere().scale([0.5] * 3).translate([1.5, -0.5, 1.0]))
              .material(Material.specular(hex_color(0x0000FF), 0.1)))
    scene.add(Object(sphere().scale([0.5] * 3).translate([-1.5, -0.5, 1.0]))
              .material(Material.specular(hex_color(0x00FF00), 0.1)))
    scene.add(Object(plane([0.0, 1.0, 0.0], -1.0)).material(Material.specular(hex_color(0xAAAAAA), 0.5)))
    scene.add(AmbientLight((0.01, 0.01, 0.01)))
    scene.add(PointLight((100.0, 100.0, 100.0), (0.0, 5.0, 5.0)))
    return scene


def monomial_glass_camera() -> Camera:
    return Camera()


def build_monomial_light_scene() -> Scene:
    """An emissive monomial surface (height 2, raised by 3) over a diffuse
    plane (`tests/test_monomial_light.py`)."""
    scene = Scene()
    scene.add(Object(plane([0.0, 1.0, 0.0], 0.0)).material(Material.diffuse(hex_color(0xAAAAAA))))
    scene.add(ObjectLight(Object(monomial_surface(2.0, 4.0).translate([0.0, 3.0, 0.0]))
                          .material(Material.light((1.0, 1.0, 1.0), 50.0))))
    return scene


def monomial_light_camera() -> Camera:
    return Camera.look_at([0.0, 2.0, 8.0], [0.0, 0.5, 0.0], [0.0, 1.0, 0.0], math.pi / 4)


# The trefoil's place in the two asset scenes: (uniform scale, rotation
# about y in radians, translation), applied in that order. The default
# knot spans x +-0.39, y -0.38..0.357, z +-0.2 (in the xy plane).
# `pegasus`: scaled 2.6 and raised by 1.0, it stands just above the floor
# (its lowest point at y = 0.012, the floor at -0.01) and is centered near
# the camera's target (0, 1, 0), facing the camera.
PEGASUS_TREFOIL = (2.6, 0.0, (0.0, 1.0, 0.0))
# `wine_glass`: scaled 3.0, turned a quarter of pi to face the camera and
# raised by 1.15, it stands on the floor (its lowest point at y = 0.01) at
# the origin, where the glass stands.
WINE_GLASS_TREFOIL = (3.0, math.pi / 4, (0.0, 1.15, 0.0))


def _placed(mesh, placement):
    """`mesh` scaled, turned about y and moved by `placement`; any
    package's mesh (the JAX package's in its tests)."""
    scale, angle, offset = placement
    out = mesh.scale([scale] * 3)
    if angle:
        out = out.rotate_y(angle)
    return out.translate(list(offset))


def build_pegasus_scene(ice, environment: Environment) -> Scene:
    """`examples/pegasus.py`'s `build_scene` around the ice shape `ice` (the
    loaded mesh, scaled and placed): `transparent_colored(0xF8F8FF, 1.31,
    0.2)` on it, the 4x4 floor polygon at y = -0.01 in `diffuse(0xDDDDDD)`,
    `environment` and no light of any kind, so a render casts no shadow
    ray. Render it at EV -1.5 (`pegasus_camera`)."""
    scene = Scene()
    scene.set_environment(environment)
    ice_mat = Material.transparent_colored(hex_color(0xF8F8FF), 1.31, 0.2)
    scene.add(Object(ice).material(ice_mat))
    scene.add(Object(polygon([[2.0, -0.01, 2.0], [2.0, -0.01, -2.0], [-2.0, -0.01, -2.0], [-2.0, -0.01, 2.0]]))
              .material(Material.diffuse(hex_color(0xDDDDDD))))
    return scene


def build_pegasus_trefoil_scene(mesh: Optional[Mesh] = None, sky_height: int = 256) -> Scene:
    """`build_pegasus_scene` without the example's assets: the sky is
    `procedural_sky(sky_height)` (the example's fallback; 256 is its default
    height), and the ice is the trefoil (`mesh`, the 120,000-triangle knot
    when None) placed by `PEGASUS_TREFOIL` where the example scales its
    pegasus by 1.4."""
    if mesh is None:
        mesh = trefoil_mesh()
    return build_pegasus_scene(_placed(mesh, PEGASUS_TREFOIL), Environment.from_hdri(procedural_sky(sky_height)))


def pegasus_camera() -> Camera:
    """`examples/pegasus.py`'s camera; its renderer takes EV -1.5, 8
    bounces, 1200x1200."""
    return Camera.look_at((0.0, 1.5, 3.1), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0), math.pi / 4)


def build_wine_glass_scene(glass, environment: Environment) -> Scene:
    """`examples/wine_glass.py`'s `build_scene` around the glass shape
    `glass`: `Material.clear(1.5, 0.0001)` on it, the 10x10 floor in
    `diffuse(0x6F5D48)`, `environment`, and the radius-3 sphere light of
    emittance 200 at (11.15, 13.739, -4.9325)."""
    scene = Scene()
    scene.set_environment(environment)
    scene.add(Object(glass).material(Material.clear(1.5, 0.0001)))
    scene.add(Object(polygon([[-5.0, 0.0, -5.0], [-5.0, 0.0, 5.0], [5.0, 0.0, 5.0], [5.0, 0.0, -5.0]]))
              .material(Material.diffuse(hex_color(0x6F5D48))))
    scene.add(ObjectLight(Object(sphere().scale([3.0] * 3).translate([11.15, 13.739, -4.9325]))
                          .material(Material.light(hex_color(0xFFFFFF), 200.0))))
    return scene


def build_wine_glass_trefoil_scene(mesh: Optional[Mesh] = None) -> Scene:
    """`build_wine_glass_scene` without an HDR (the example's solid
    environment (0.25, 0.25, 0.28)), the glass mesh replaced by the trefoil
    (`mesh`, the 120,000-triangle knot when None) placed by
    `WINE_GLASS_TREFOIL`."""
    if mesh is None:
        mesh = trefoil_mesh()
    return build_wine_glass_scene(_placed(mesh, WINE_GLASS_TREFOIL), Environment.from_color((0.25, 0.25, 0.28)))


def wine_glass_camera() -> Camera:
    """`examples/wine_glass.py`'s camera; its renderer takes 6 bounces,
    1920x1080."""
    eye = np.array([5.530, 4.375, 5.384])
    return Camera.look_at(eye, eye + np.array([-0.6962, -0.3754, -0.6119]), [0.0, 1.0, 0.0], 0.6911)


LEVEL_COLORS = [0x264653, 0x2A9D8F, 0xE9C46A, 0xF4A261, 0xE76F51]


def fractal_placements(levels: int = 5):
    """Per level, a list of (position, radius) (`examples/_fractal.py`): a
    root at radius 1 spawns six children at radius 2/5, displaced by 7/5 r
    along each axis, skipping the direction back at the parent; five levels
    give 1 + 6 + 30 + 150 + 750 = 937 placements."""
    out = [[] for _ in range(levels)]

    def gen(p, rad, depth, last_dir):
        out[depth].append((tuple(p), rad))
        if depth == levels - 1:
            return
        disp = rad * 7.0 / 5.0
        dirs = [(disp, 0.0, 0.0), (-disp, 0.0, 0.0), (0.0, disp, 0.0), (0.0, -disp, 0.0), (0.0, 0.0, disp),
                (0.0, 0.0, -disp)]
        for i, dv in enumerate(dirs):
            if last_dir is None or i != (last_dir ^ 1):
                gen((p[0] + dv[0], p[1] + dv[1], p[2] + dv[2]), rad * 2.0 / 5.0, depth + 1, i)

    gen((0.0, 0.0, 0.0), 1.0, 0, None)
    return out


def build_fractal_spheres_scene(levels: int = 5) -> Scene:
    """`examples/fractal_spheres.py`'s scene: one group of specular spheres
    per level (`LEVEL_COLORS`), the plane z = -6, an ambient, a directional
    and a point light. With 5 levels the compiled scene holds 937 spheres,
    which the sphere test takes in chunks of `scene.PRIM_CHUNK`."""
    scene = Scene()
    for i, level in enumerate(fractal_placements(levels)):
        shapes = [sphere().scale([rad] * 3).translate(list(p)) for p, rad in level]
        scene.add(Object(group(shapes)).material(Material.specular(hex_color(LEVEL_COLORS[i]), 0.25)))
    scene.add(Object(plane([0.0, 0.0, 1.0], -6.0)).material(Material.diffuse(hex_color(0xFFCCCC))))
    scene.add(AmbientLight((0.02, 0.02, 0.02)))
    d = np.array([0.0, -0.65, -1.0])
    scene.add(DirectionalLight((0.6, 0.6, 0.6), tuple(d / np.linalg.norm(d))))
    scene.add(PointLight((100.0, 100.0, 100.0), (0.0, 5.0, 5.0)))
    return scene


def fractal_spheres_camera() -> Camera:
    """`examples/fractal_spheres.py`'s camera (800x600, 0 bounces, 1 spp)."""
    direction = np.array([-0.285714, -0.5, -1.0])
    up = np.array([0.0, 1.0, -0.5])
    return Camera(eye=(2.0, 3.5, 7.0), direction=tuple(direction / np.linalg.norm(direction)),
                  up=tuple(up / np.linalg.norm(up)), fov=math.pi / 6)


# The trefoil cut to about the teapot's 2.2k triangles (`bench.py`'s
# `teapot` row): (segments, sides), 2,256 triangles.
TEAPOT_KNOT = (47, 24)


def build_fractal_teapots_scene(teapot: Mesh, levels: int = 5) -> Scene:
    """`examples/fractal_teapots.py`'s scene around one mesh, `teapot`,
    shared by every placement of `fractal_placements(levels)` (scaled 0.5,
    then by the placement's radius, then moved): one group per level in
    `LEVEL_COLORS`, so the compile takes the two-level path (937 instances
    at 5 levels), the plane z = -6, an ambient, a directional and a point
    light. Its camera is `fractal_spheres_camera`, as in the example."""
    scene = Scene()
    for i, level in enumerate(fractal_placements(levels)):
        shapes = [teapot.scale([0.5, 0.5, 0.5]).scale([rad] * 3).translate(list(p)) for p, rad in level]
        scene.add(Object(group(shapes)).material(Material.specular(hex_color(LEVEL_COLORS[i]), 0.25)))
    scene.add(Object(plane([0.0, 0.0, 1.0], -6.0)).material(Material.diffuse(hex_color(0xFFCCCC))))
    scene.add(AmbientLight((0.02, 0.02, 0.02)))
    d = np.array([0.0, -0.65, -1.0])
    scene.add(DirectionalLight((0.6, 0.6, 0.6), tuple(d / np.linalg.norm(d))))
    scene.add(PointLight((100.0, 100.0, 100.0), (0.0, 5.0, 5.0)))
    return scene


def compound_lamp(x, y, z, r, e) -> ObjectLight:
    """A white sphere lamp of radius `r` and emittance `e` at (x, y, z)
    (`examples/compound.py`'s `lamp`)."""
    return ObjectLight(Object(sphere().scale([r, r, r]).translate([x, y, z])).material(Material.light((1.0, 1.0, 1.0), e)))


def build_compound_scene() -> Scene:
    """`examples/compound.py`'s scene: five cubes, three of them mirrored,
    a white floor and three sphere lamps."""
    scene = Scene()
    magic_angle = math.acos((3.0 * math.sqrt(5.0) - 1.0) / 8.0)

    c_central = cube()
    c_green = cube().rotate(-magic_angle, [1.0, 1.0, 1.0])
    c_red = cube().rotate(-magic_angle, [1.0, 1.0, 1.0]).scale([-1.0, 1.0, 1.0])
    c_blue = cube().rotate(-magic_angle, [1.0, 1.0, 1.0]).scale([1.0, -1.0, 1.0])
    c_orange = cube().rotate(-magic_angle, [1.0, 1.0, 1.0]).scale([-1.0, 1.0, 1.0]).scale([1.0, -1.0, 1.0])

    scene.add(Object(c_central).material(Material.specular(hex_color(0xC144EB), 0.4)))
    scene.add(Object(c_green).material(Material.specular(hex_color(0x45E542), 0.4)))
    scene.add(Object(c_red).material(Material.specular(hex_color(0xF55142), 0.4)))
    scene.add(Object(c_blue).material(Material.specular(hex_color(0x4275F5), 0.4)))
    scene.add(Object(c_orange).material(Material.specular(hex_color(0xF5BF42), 0.4)))
    scene.add(Object(plane([0.0, 1.0, 0.0], -0.80902)).material(Material.diffuse(hex_color(0xFFFFFF))))

    scene.add(compound_lamp(-2.0, 3.5, 0.5, 0.5, 60.0))
    scene.add(compound_lamp(0.0, 0.5, 5.0, 1.0, 2.0))
    scene.add(compound_lamp(2.0, 1.0, -5.0, 0.6, 10.0))
    return scene


def compound_camera() -> Camera:
    return Camera.look_at([-0.9, 1.2, 2.4], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], math.pi / 4)


def scene_and_camera(name: str):
    """(scene, camera, ray offset) of a scene by name: `cornell`, `dragon`,
    `dragon871k`, `lego`, `monomial_glass`, `pegasus_trefoil`,
    `wine_glass_trefoil`, `fractal_spheres`, `compound`,
    `fractal_teapots_trefoil` (`examples.fractal_teapots`' 937 instances of
    the trefoil cut to the teapot's size, `TEAPOT_KNOT`), and `lego_toy` for
    any other name; the ray offset of the reference's `bench.py` rows, the
    renderer's default for the examples."""
    if name == "cornell":
        return build_cornell_scene(), cornell_camera(), CORNELL_EPSILON
    if name == "dragon":
        return build_dragon_scene(), dragon_camera(), 1e-3
    if name == "dragon871k":
        return build_dragon_scene(target_tris=871_000), dragon_camera(), 1e-3
    if name == "lego":
        return build_brick_city(), lego_camera(), 1e-3
    if name == "monomial_glass":
        return build_monomial_glass_scene(sky_height=1024), monomial_glass_camera(), 1e-3
    if name == "pegasus_trefoil":
        return build_pegasus_trefoil_scene(), pegasus_camera(), 1e-3
    if name == "wine_glass_trefoil":
        return build_wine_glass_trefoil_scene(), wine_glass_camera(), 1e-3
    if name == "fractal_spheres":
        return build_fractal_spheres_scene(), fractal_spheres_camera(), 1e-3
    if name == "compound":
        return build_compound_scene(), compound_camera(), 1e-3
    if name == "fractal_teapots_trefoil":
        return build_fractal_teapots_scene(trefoil_mesh(*TEAPOT_KNOT)), fractal_spheres_camera(), 1e-3
    return build_toy_plane_scene(), toy_plane_camera(), 1e-3
