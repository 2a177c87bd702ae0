"""Declarative scene model + compiler to flat device tensors (`rpt_tpu/scene.py`).

`Scene` / `Object` are the host-side builder. `Scene.compile` lowers the
shape tree once into struct-of-arrays tensors grouped by primitive type on
one device, so intersection is a handful of batched operations instead of
per-object calls. `SceneData.intersect` is the scene-level closest hit, the
running min over per-type closest hits; `SceneData.occluded` is the shadow
query, boolean-equal to `intersect(...).t <= t_max`.

Meshes take the reference's layout decision. When every mesh is used once
and the bake stays under BAKE_TRI_LIMIT triangles, they are baked into
world-space triangles: fewer than BVH_THRESHOLD go to the brute-force batch,
the rest into one SAH BVH. Shared geometry, or a larger bake, goes through
the two-level instanced BVH (`ops/tlas.py`).

Which kernels walk a tree is the reference's choice too, made once at
compile time by `choose_bvh_pack` / `choose_instanced_pack` (which
`convert.py` calls as well) from the module globals `_BVH_KERNEL`
(env `RPT_BVH_KERNEL`, "wide" or "binary") and `WIDE_KERNEL_MIN_TRIS` (env
`RPT_WIDE_MIN_TRIS`), and made nowhere else: the choice is the type of the
one pack each level holds, `SceneData.mesh_pack` for the BVH and
`instance_pack` for the instanced meshes. A BVH of at least
WIDE_KERNEL_MIN_TRIS triangle rows gets a wide pack (`ops/bvh8.Bvh8Pack`)
under "wide", any other a binary one (`ops/bvh2.Bvh2Pack`); instanced
meshes get a two-level wide pack (`ops/tlas8.Tlas8Pack`) under "wide", else
a binary two-level one (`ops/tlas2.Tlas2Pack`). A wide pack that refuses a
tree falls back to the binary one with a warning, as the reference does.
The reference's TPU budgets (SMEM and node-count eligibility) are not
carried over: the binary two-level kernels take every scene, where the
reference falls back to its XLA loop. Whatever its type, a pack is walked
through `ops/walk.py`: its kernels on the card, their plain versions on the
CPU.

Monomial surfaces are analytic primitives like spheres and cubes,
intersected by the fixed Newton-and-bisection root find of
`ops.intersect.intersect_monomials` (plain torch, as the reference's is
XLA code); their shadow query compares the closest hit with t_max, as the
reference's does. An HDRI environment's map and quad table are copied to
the device once, here, so the pass reads them without a host copy.

A scene compiles in float32 or float64 (`Scene.compile(dtype)`), as the
reference's does: every float array of the compiled scene is in that type
(the environment color keeps its float32 values, and an HDRI's texels stay
float32, as in the reference), and
the packs are too (their node boxes stay float32, rounded outward in a
float64 pack). The kernel choice does not look at the type.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import warnings
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from . import profiling
from .environment import Environment, lookup
from .lights import (
    AmbientLight,
    AmbientLightData,
    CubeLightData,
    DirectionalLight,
    DirectionalLightData,
    MeshLightData,
    MonomialLightData,
    ObjectLight,
    PointLight,
    PointLightData,
    SphereLightData,
)
from .materials import Material, MaterialTable
from .native import hash128
from .ops import intersect as ops
from .ops.bvh import BvhData, build_bvh
from .ops.bvh2 import Bvh2Pack, pack_bvh2
from .ops.bvh8 import Bvh8Pack, WidePackRefused, pack_bvh8
from .ops.tlas import InstancedMeshes, build_instanced
from .ops.tlas2 import Tlas2Pack, pack_tlas2
from .ops.tlas8 import Tlas8Pack, pack_tlas8
from .shapes import Cube, Group, Mesh, MonomialSurface, Plane, Shape, Sphere, Transformed, unwrap_transform
from .utils.device import resolve_device
from .utils.vmath import numpy_real

__all__ = ["Object", "Scene", "SceneData", "MonomialArrays", "compile_scene", "choose_bvh_pack",
           "choose_instanced_pack"]

# Meshes with at least this many triangles get a BVH; smaller ones are
# brute-forced.
BVH_THRESHOLD = 64
# Analytic primitive batches larger than this are intersected in chunks so
# the (N rays x P prims) broadcast stays memory-bounded.
PRIM_CHUNK = 256
# Above this many baked triangles the reference switches to instancing.
BAKE_TRI_LIMIT = 2_000_000
# Mesh traversal kernels: "wide" (default) walks a BVH of at least
# WIDE_KERNEL_MIN_TRIS triangle rows, and every instanced scene, with the
# 8-ary kernels; "binary" sends every mesh through the binary kernels
# (the reference's A/B switch, read at compile time).
_BVH_KERNEL = os.environ.get("RPT_BVH_KERNEL", "wide")
WIDE_KERNEL_MIN_TRIS = int(os.environ.get("RPT_WIDE_MIN_TRIS", "16384"))


class Object:
    """A shape with a material."""

    def __init__(self, shape: Shape, material: Optional[Material] = None):
        self.shape = shape
        self._material = material if material is not None else Material.default()

    def material(self, material: Material) -> "Object":
        """Builder-style material setter."""
        return Object(self.shape, material)

    @property
    def mat(self) -> Material:
        return self._material


class Scene:
    """A scene: objects + lights + environment."""

    def __init__(self):
        self.objects: List[Object] = []
        self.lights: List[Union[PointLight, AmbientLight, DirectionalLight, ObjectLight]] = []
        self.environment: Environment = Environment.black()
        self._compiled: Dict[tuple, tuple] = {}  # (device, dtype) -> ((digest, kernel choice), data)

    def add(self, node) -> None:
        self._compiled = {}
        if isinstance(node, Object):
            self.objects.append(node)
        elif isinstance(node, (PointLight, AmbientLight, DirectionalLight, ObjectLight)):
            self.lights.append(node)
        else:
            raise TypeError(f"Cannot add {type(node)} to a Scene")

    def set_environment(self, env: Environment) -> None:
        self._compiled = {}
        self.environment = env

    def compile(self, dtype=torch.float32, device=None) -> "SceneData":
        """Compile in `dtype` (float32 or float64) onto `device` (the CUDA
        card when None; raises without one). Cached per device and dtype (the
        reference keys its cache on the dtype too) on a content digest of the
        scene and on the kernel choice (`_BVH_KERNEL`, `WIDE_KERNEL_MIN_TRIS`),
        so in-place edits and a changed choice recompile."""
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"a scene compiles in float32 or float64, not {dtype}")
        device = resolve_device(device)
        with profiling.span("rpt.scene.compile") as span:
            digest = _scene_digest(self)
            key = (digest, _BVH_KERNEL, WIDE_KERNEL_MIN_TRIS)
            slot = (str(device), dtype)
            cached = self._compiled.get(slot)
            hit = cached is not None and cached[0] == key
            span.set(hit=hit)
            if hit:
                return cached[1]
            with profiling.rare_span("rpt.scene.build"):
                data = compile_scene(self, device, digest=digest, dtype=dtype)
            self._compiled[slot] = (key, data)
            return data


# ---------------------------------------------------------------------------
# Content digest for the compile cache
# ---------------------------------------------------------------------------


def _fp_bytes(h, arr) -> None:
    h.update(np.ascontiguousarray(arr, np.float64).tobytes())


def _fp_shape(h, shape: Shape, mesh_slots: dict) -> None:
    """Feed a shape's full content into the digest; mesh geometry is hashed
    once per object and re-referenced by slot, so sharing is in the key."""
    if isinstance(shape, Transformed):
        h.update(b"T")
        _fp_bytes(h, shape.matrix)
        _fp_shape(h, shape.base, mesh_slots)
    elif isinstance(shape, Group):
        h.update(b"G%d:" % len(shape.shapes))
        for child in shape.shapes:
            _fp_shape(h, child, mesh_slots)
    elif isinstance(shape, Sphere):
        h.update(b"S")
    elif isinstance(shape, Cube):
        h.update(b"C")
    elif isinstance(shape, Plane):
        h.update(b"P")
        _fp_bytes(h, shape.normal)
        _fp_bytes(h, shape.value)
    elif isinstance(shape, MonomialSurface):
        h.update(b"M")
        _fp_bytes(h, (shape.height, shape.exp))
    elif isinstance(shape, Mesh):
        slot = mesh_slots.get(id(shape))
        if slot is None:
            slot = len(mesh_slots)
            mesh_slots[id(shape)] = slot
            h.update(b"m%d:" % slot)
            h.leaf(np.ascontiguousarray(shape.vertices, np.float64))
            h.leaf(np.ascontiguousarray(shape.normals, np.float64))
        else:
            h.update(b"r%d:" % slot)
    else:
        raise TypeError(f"Unsupported shape type: {type(shape)}")


class _CountedHash:
    """blake2b, counting the bytes fed to it. A large leaf goes through the
    native 128-bit hash, read in place, and its 16 bytes into blake2b in the
    leaf's place: `bytes` counts every byte read, the leaves' own included,
    and `leaf_bytes` the leaves' alone."""

    def __init__(self):
        self._h = hashlib.blake2b(digest_size=16)
        self.bytes = 0
        self.leaf_bytes = 0

    def update(self, data) -> None:
        self.bytes += memoryview(data).nbytes
        self._h.update(data)

    def leaf(self, arr: np.ndarray) -> None:
        self.bytes += arr.nbytes
        self.leaf_bytes += arr.nbytes
        self._h.update(hash128(arr))

    def hexdigest(self) -> str:
        return self._h.hexdigest()


def _scene_digest(scene: "Scene") -> str:
    with profiling.span("rpt.scene.digest") as span:
        h = _CountedHash()
        mesh_slots: dict = {}
        for obj in scene.objects:
            h.update(b"O")
            _fp_shape(h, obj.shape, mesh_slots)
            h.update(repr(obj.mat).encode())
        for light in scene.lights:
            if isinstance(light, ObjectLight):
                h.update(b"LO")
                _fp_shape(h, light.object.shape, mesh_slots)
                h.update(repr(light.object.mat).encode())
            else:
                h.update(repr(light).encode())
        env = scene.environment
        h.update(b"E")
        _fp_bytes(h, env.color)
        if env.hdri is not None:
            h.leaf(np.ascontiguousarray(env.hdri))  # the map's bytes, uncopied
        span.set(bytes=h.bytes, leaf_bytes=h.leaf_bytes)
        return h.hexdigest()


# ---------------------------------------------------------------------------
# Compiled scene
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PrimXf:
    """Analytic primitives intersected in local space (sphere / cube)."""

    inv_tf: torch.Tensor  # (P, 3, 4)
    nmat: torch.Tensor  # (P, 3, 3) inverse-transpose linear
    mat_id: torch.Tensor  # (P,) int32


@dataclasses.dataclass(frozen=True)
class PlaneArrays:
    normal: torch.Tensor  # (P, 3)
    value: torch.Tensor  # (P,)
    mat_id: torch.Tensor  # (P,)


@dataclasses.dataclass(frozen=True)
class TriangleArrays:
    verts: torch.Tensor  # (T, 3, 3) world space
    norms: torch.Tensor  # (T, 3, 3)
    mat_id: torch.Tensor  # (T,)


@dataclasses.dataclass(frozen=True)
class MonomialArrays:
    inv_tf: torch.Tensor  # (P, 3, 4)
    nmat: torch.Tensor  # (P, 3, 3)
    height: torch.Tensor  # (P,)
    mat_id: torch.Tensor  # (P,)


@dataclasses.dataclass(frozen=True)
class SceneData:
    """A compiled scene on one device."""

    materials: MaterialTable
    spheres: Optional[PrimXf]
    cubes: Optional[PrimXf]
    planes: Optional[PlaneArrays]
    monomials: Optional[MonomialArrays]
    triangles: Optional[TriangleArrays]  # small meshes, brute force
    bvh: Optional[BvhData]  # large meshes: triangle data for finalize_hit
    mesh_pack: Optional[Union[Bvh8Pack, Bvh2Pack]]  # the kernels' layout of `bvh` (`choose_bvh_pack`)
    instanced: Optional[InstancedMeshes]  # shared meshes: two-level BVH
    instance_pack: Optional[Union[Tlas8Pack, Tlas2Pack]]  # the layout of `instanced` (`choose_instanced_pack`)
    lights: tuple
    environment: Environment
    env_color: torch.Tensor  # (3,): the environment's (float32) color on `device`, in the scene's type
    device: torch.device
    env_hdri: Optional[torch.Tensor] = None  # (H, W, 3) float32: the HDRI map on `device`, or None
    env_quad: Optional[torch.Tensor] = None  # (H*W, 13) float32: its quad table, or None (4-gather form)
    digest: str = ""

    @property
    def dtype(self) -> torch.dtype:
        """The scene's real type, float32 or float64 (the reference reads
        it off the material table too)."""
        return self.materials.color.dtype

    def to_device(self) -> "SceneData":
        """The scene with every leaf on the device (the reference lifts its
        host numpy leaves here): a compiled scene of the port already holds
        device tensors, so it is returned as it is."""
        return self

    def environment_color(self, d: torch.Tensor) -> torch.Tensor:
        """The environment's radiance for directions d (N, 3), read from
        this scene's device tensors (`Environment.get_color`)."""
        return lookup(d, self.env_color, self.env_hdri, self.env_quad)

    @property
    def packs(self) -> tuple:
        """The traversal packs the scene holds, the mesh pack first."""
        return tuple(pack for _, pack in self._walks())

    def _walks(self):
        """(geometry, pack) of each level that holds a pack."""
        return [(g, p) for g, p in ((self.bvh, self.mesh_pack), (self.instanced, self.instance_pack)) if p is not None]

    def intersect(self, o: torch.Tensor, d: torch.Tensor, t_min, active=None) -> ops.Hit:
        """Closest hit of N rays against the whole scene. Lanes with
        `active=False` never walk the BVH and come back as misses."""
        hit = self._analytic_hit(o, d, t_min)
        for geometry, pack in self._walks():
            hit = ops.merge_hits(hit, pack.closest_hit(geometry, o, d, t_min, active=active))
        if active is not None:
            hit = ops.Hit(
                t=torch.where(active, hit.t, torch.full_like(hit.t, ops.INF)),
                normal=hit.normal,
                mat_id=hit.mat_id,
            )
        return hit

    def occluded(self, o, d, t_min, t_max, active=None) -> torch.Tensor:
        """True per ray iff some surface lies within [t_min, t_max] (closed
        at t_min, as intersect() is); the mesh walk stops at the first hit."""
        t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=o.dtype, device=o.device), (o.shape[0],))
        occ = self._analytic_occluded(o, d, t_min, t_max)
        for geometry, pack in self._walks():
            occ = occ | pack.occluded(geometry, o, d, t_min, t_max, active=active)
        if active is not None:
            occ = occ & active
        return occ

    def _analytic_occluded(self, o, d, t_min, t_max) -> torch.Tensor:
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        if self.spheres is not None:
            occ = occ | _maybe_chunked_occl(
                ops.occluded_spheres, (self.spheres.inv_tf, self.spheres.nmat, self.spheres.mat_id),
                o, d, t_min, t_max,
            )
        if self.cubes is not None:
            occ = occ | _maybe_chunked_occl(
                ops.occluded_cubes, (self.cubes.inv_tf, self.cubes.nmat, self.cubes.mat_id),
                o, d, t_min, t_max,
            )
        if self.planes is not None:
            occ = occ | _maybe_chunked_occl(
                ops.occluded_planes, (self.planes.normal, self.planes.value, self.planes.mat_id),
                o, d, t_min, t_max,
            )
        if self.monomials is not None:
            occ = occ | (_maybe_chunked(ops.intersect_monomials, self._monomial_arrays(), o, d, t_min).t <= t_max)
        if self.triangles is not None:
            occ = occ | _maybe_chunked_occl(
                ops.occluded_triangles,
                (self.triangles.verts, self.triangles.norms, self.triangles.mat_id),
                o, d, t_min, t_max,
            )
        return occ

    def _analytic_hit(self, o, d, t_min) -> ops.Hit:
        hit = ops.no_hit(o.shape[0], o.dtype, o.device)
        if self.spheres is not None:
            hit = ops.merge_hits(hit, _maybe_chunked(
                ops.intersect_spheres, (self.spheres.inv_tf, self.spheres.nmat, self.spheres.mat_id),
                o, d, t_min,
            ))
        if self.cubes is not None:
            hit = ops.merge_hits(hit, _maybe_chunked(
                ops.intersect_cubes, (self.cubes.inv_tf, self.cubes.nmat, self.cubes.mat_id),
                o, d, t_min,
            ))
        if self.planes is not None:
            hit = ops.merge_hits(hit, _maybe_chunked(
                ops.intersect_planes, (self.planes.normal, self.planes.value, self.planes.mat_id),
                o, d, t_min,
            ))
        if self.monomials is not None:
            hit = ops.merge_hits(hit, _maybe_chunked(ops.intersect_monomials, self._monomial_arrays(), o, d, t_min))
        if self.triangles is not None:
            hit = ops.merge_hits(hit, _maybe_chunked(
                ops.intersect_triangles,
                (self.triangles.verts, self.triangles.norms, self.triangles.mat_id),
                o, d, t_min,
            ))
        return hit

    def _monomial_arrays(self) -> tuple:
        m = self.monomials
        return m.inv_tf, m.nmat, m.height, m.mat_id


def _maybe_chunked(intersect_fn, prim_arrays: tuple, o, d, t_min, chunk: int = PRIM_CHUNK):
    """Intersect N rays against P primitives in chunks of `chunk`, so the
    (N, P) broadcast never materializes whole. (The reference pads the last
    chunk with copies of primitive 0, which never changes the running min.)"""
    P = prim_arrays[0].shape[0]
    if P <= chunk:
        return intersect_fn(o, d, t_min, *prim_arrays)
    hit = ops.no_hit(o.shape[0], o.dtype, o.device)
    for s in range(0, P, chunk):
        hit = ops.merge_hits(hit, intersect_fn(o, d, t_min, *(a[s:s + chunk] for a in prim_arrays)))
    return hit


def _maybe_chunked_occl(occl_fn, prim_arrays: tuple, o, d, t_min, t_max, chunk: int = PRIM_CHUNK):
    """Any-hit analog of _maybe_chunked: OR over primitive chunks."""
    P = prim_arrays[0].shape[0]
    if P <= chunk:
        return occl_fn(o, d, t_min, t_max, *prim_arrays)
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for s in range(0, P, chunk):
        occ = occ | occl_fn(o, d, t_min, t_max, *(a[s:s + chunk] for a in prim_arrays))
    return occ


# ---------------------------------------------------------------------------
# Compiler
# ---------------------------------------------------------------------------


def choose_bvh_pack(bvh: BvhData, device=None) -> Union[Bvh8Pack, Bvh2Pack]:
    """The BVH's pack: the wide pack for a BVH of at least
    WIDE_KERNEL_MIN_TRIS triangle rows under RPT_BVH_KERNEL=wide, else the
    binary pack; also the binary pack, with a warning, where the wide pack
    refuses the tree (the reference's decision, `rpt_tpu/scene.py:736-754`)."""
    if _BVH_KERNEL == "wide" and bvh.num_tris >= WIDE_KERNEL_MIN_TRIS:
        try:
            return pack_bvh8(bvh, device=device)
        except WidePackRefused as e:
            warnings.warn(f"{e}; falling back to the binary BVH kernels", stacklevel=2)
    return pack_bvh2(bvh, device=device)


def choose_instanced_pack(im: InstancedMeshes, device=None) -> Union[Tlas8Pack, Tlas2Pack]:
    """The instanced meshes' pack: the two-level wide pack under
    RPT_BVH_KERNEL=wide, else the binary one; also the binary one, with a
    warning, where the wide pack refuses the scene (as the reference's
    `pack_tlas8_for_pallas` falls back to its binary two-level kernel)."""
    if _BVH_KERNEL == "wide":
        try:
            return pack_tlas8(im, device=device)
        except WidePackRefused as e:
            warnings.warn(f"{e}; falling back to the binary two-level kernels", stacklevel=2)
    return pack_tlas2(im, device=device)



def _affine_parts(matrix: np.ndarray):
    inv = np.linalg.inv(matrix)
    inv_tf = inv[:3, :4]
    lin = matrix[:3, :3]
    nmat = np.linalg.inv(lin).T
    det = float(np.linalg.det(lin))
    return inv_tf, lin, matrix[:3, 3], nmat, det


def _bake_mesh(mesh: Mesh, matrix: np.ndarray):
    """Bake a transform into world-space triangles (exactly equivalent to
    local-space intersection with the inverse-transpose normal fix-up)."""
    lin = matrix[:3, :3]
    trans = matrix[:3, 3]
    nmat = np.linalg.inv(lin).T
    return mesh.vertices @ lin.T + trans, mesh.normals @ nmat.T


def _flatten_shapes(shape: Shape, matrix: np.ndarray):
    """Yield (base shape, world matrix), flattening nested Groups."""
    base, m = unwrap_transform(shape)
    m = matrix @ m
    if isinstance(base, Group):
        for child in base.shapes:
            yield from _flatten_shapes(child, m)
    else:
        yield base, m


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def compile_scene(scene: Scene, device=None, digest: str = "", dtype=torch.float32) -> SceneData:
    device = resolve_device(device)
    if not digest:
        digest = _scene_digest(scene)
    real, i32 = dtype, torch.int32
    np_real = numpy_real(dtype)
    materials: List[Material] = []
    mat_index = {}

    def mat_id(m: Material) -> int:
        if m not in mat_index:
            mat_index[m] = len(materials)
            materials.append(m)
        return mat_index[m]

    sphere_rows, cube_rows, plane_rows, mono_rows, mesh_uses = [], [], [], [], []
    flat = []
    for obj in scene.objects:
        mid = mat_id(obj.mat)
        for base, matrix in _flatten_shapes(obj.shape, np.eye(4)):
            flat.append((base, matrix, mid))

    for base, matrix, mid in flat:
        if isinstance(base, Sphere):
            inv_tf, _, _, nmat, _ = _affine_parts(matrix)
            sphere_rows.append((inv_tf, nmat, mid))
        elif isinstance(base, Cube):
            inv_tf, _, _, nmat, _ = _affine_parts(matrix)
            cube_rows.append((inv_tf, nmat, mid))
        elif isinstance(base, MonomialSurface):
            if abs(base.exp - 4.0) > 1e-9:
                raise ValueError("MonomialSurface only supports exp=4 (as the reference)")
            inv_tf, _, _, nmat, _ = _affine_parts(matrix)
            mono_rows.append((inv_tf, nmat, base.height, mid))
        elif isinstance(base, Plane):
            # An affine image of a plane is a plane: n' = A^-T n, v' = v + n'.b.
            lin = matrix[:3, :3]
            n_new = np.linalg.inv(lin).T @ base.normal
            plane_rows.append((n_new, base.value + float(n_new @ matrix[:3, 3]), mid))
        elif isinstance(base, Mesh):
            mesh_uses.append((base, matrix, mid))
        else:
            raise TypeError(f"Unsupported shape type: {type(base)}")

    # Mesh layout decision: bake transforms into world-space triangles when
    # every mesh is used once and the total stays small; shared geometry or
    # very large bakes go through the instanced TLAS + BLAS.
    tri_verts, tri_norms, tri_mats = [], [], []
    instanced = instance_pack = None
    if mesh_uses:
        shared = len({id(m) for m, _, _ in mesh_uses}) < len(mesh_uses)
        if shared or sum(m.num_triangles for m, _, _ in mesh_uses) > BAKE_TRI_LIMIT:
            uniq: List[Mesh] = []
            slot = {}
            for m, _, _ in mesh_uses:
                if id(m) not in slot:
                    slot[id(m)] = len(uniq)
                    uniq.append(m)
            instances = [(slot[id(m)], matrix, mid) for m, matrix, mid in mesh_uses]
            instanced = build_instanced(uniq, instances, device=device, dtype=dtype)
            instance_pack = choose_instanced_pack(instanced, device=device)
        else:
            for m, matrix, mid in mesh_uses:
                verts, norms = _bake_mesh(m, matrix)
                tri_verts.append(verts)
                tri_norms.append(norms)
                tri_mats.append(np.full(verts.shape[0], mid, np.int32))

    def pack_primxf(rows) -> Optional[PrimXf]:
        if not rows:
            return None
        return PrimXf(
            inv_tf=_t(np.stack([r[0] for r in rows]).astype(np_real), real, device),
            nmat=_t(np.stack([r[1] for r in rows]).astype(np_real), real, device),
            mat_id=_t(np.asarray([r[2] for r in rows], np.int32), i32, device),
        )

    planes = None
    if plane_rows:
        planes = PlaneArrays(
            normal=_t(np.stack([r[0] for r in plane_rows]).astype(np_real), real, device),
            value=_t(np.asarray([r[1] for r in plane_rows], np_real), real, device),
            mat_id=_t(np.asarray([r[2] for r in plane_rows], np.int32), i32, device),
        )

    monomials = None
    if mono_rows:
        monomials = MonomialArrays(
            inv_tf=_t(np.stack([r[0] for r in mono_rows]).astype(np_real), real, device),
            nmat=_t(np.stack([r[1] for r in mono_rows]).astype(np_real), real, device),
            height=_t(np.asarray([r[2] for r in mono_rows], np_real), real, device),
            mat_id=_t(np.asarray([r[3] for r in mono_rows], np.int32), i32, device),
        )

    triangles = bvh = mesh_pack = None
    if tri_verts:
        verts = np.concatenate(tri_verts)
        norms = np.concatenate(tri_norms)
        mats = np.concatenate(tri_mats)
        if verts.shape[0] >= BVH_THRESHOLD:
            bvh = build_bvh(verts, norms, mats, device=device, dtype=dtype)
            mesh_pack = choose_bvh_pack(bvh, device=device)
        else:
            triangles = TriangleArrays(
                verts=_t(verts.astype(np_real), real, device),
                norms=_t(norms.astype(np_real), real, device),
                mat_id=_t(mats.astype(np.int32), i32, device),
            )

    env_color, env_hdri, env_quad = scene.environment.tensors(device, dtype)
    return SceneData(
        materials=MaterialTable.pack(materials, device=device, dtype=dtype),
        spheres=pack_primxf(sphere_rows),
        cubes=pack_primxf(cube_rows),
        planes=planes,
        monomials=monomials,
        triangles=triangles,
        bvh=bvh,
        mesh_pack=mesh_pack,
        instanced=instanced,
        instance_pack=instance_pack,
        lights=tuple(_compile_light(l, device, dtype) for l in scene.lights),
        environment=scene.environment,
        env_color=env_color,
        device=device,
        env_hdri=env_hdri,
        env_quad=env_quad,
        digest=f"{str(dtype).removeprefix('torch.')}:{digest}",
    )


def _compile_light(light, device, dtype=torch.float32):
    np_real = numpy_real(dtype)

    def f(a):
        return _t(np.asarray(a, np_real), dtype, device)

    if isinstance(light, PointLight):
        return PointLightData(color=f(light.color), position=f(light.position))
    if isinstance(light, AmbientLight):
        return AmbientLightData(color=f(light.color))
    if isinstance(light, DirectionalLight):
        return DirectionalLightData(color=f(light.color), direction=f(light.direction))
    if isinstance(light, ObjectLight):
        obj = light.object
        m = obj.mat
        emitted = f((np.asarray(m.color) * m.emittance).astype(np_real))
        base, matrix = unwrap_transform(obj.shape)
        if isinstance(base, Sphere):
            inv_tf, lin, trans, nmat, det = _affine_parts(matrix)
            return SphereLightData(
                inv_tf=f(inv_tf), l2w_lin=f(lin), l2w_trans=f(trans), nmat=f(nmat),
                det=f(np_real(det)), emitted=emitted,
            )
        if isinstance(base, Cube):
            _, lin, trans, nmat, det = _affine_parts(matrix)
            return CubeLightData(
                l2w_lin=f(lin), l2w_trans=f(trans), nmat=f(nmat), det=f(np_real(det)), emitted=emitted,
            )
        if isinstance(base, MonomialSurface):
            if abs(base.exp - 4.0) > 1e-9:
                raise ValueError("MonomialSurface lights support exp=4 only")
            inv_tf, lin, trans, nmat, det = _affine_parts(matrix)
            return MonomialLightData(
                inv_tf=f(inv_tf), l2w_lin=f(lin), l2w_trans=f(trans), nmat=f(nmat), det=f(np_real(det)),
                height=f(np_real(base.height)), emitted=emitted,
            )
        if isinstance(base, Mesh):
            verts, norms = _bake_mesh(base, matrix)
            e1 = verts[:, 1] - verts[:, 0]
            e2 = verts[:, 2] - verts[:, 0]
            areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
            return MeshLightData(verts=f(verts), norms=f(norms), areas=f(areas), emitted=emitted)
        raise TypeError(f"Unsupported area-light shape: {type(base)}")
    raise TypeError(f"Unknown light type: {type(light)}")
