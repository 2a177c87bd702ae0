"""Binary SAH BVH over triangle meshes (`rpt_tpu/ops/bvh.py`).

The tree is built on the host by the native binned-SAH builder (a copy of
the JAX package's, so both packages build array-identical trees), flattened
in DFS preorder with skip links: on a box hit a walk advances to node i+1,
on a miss it jumps to skip[i]. Triangles are permuted so each leaf's
triangles are contiguous and 8-aligned, which is what the wide-BVH kernels
(`ops/bvh8.py`) rely on; triangle ids are indices into that permuted order.

The binary tree is walked by the child-pair kernels of `ops/bvh2.py` or,
collapsed, by the wide kernels of `ops/bvh8.py`, each with a plain torch
version; `finalize_hit` turns a walk's (t, triangle id) into a `Hit` with
the smooth interpolated normal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..native import build_bvh_sah
from ..utils.vmath import cross, dot, normalize, numpy_real, signed_full
from .intersect import INF, Hit

__all__ = ["BvhData", "build_bvh", "bvh_closest_hit", "finalize_hit", "finish_closest", "refuse_ray_grad", "outward",
           "widen", "LEAF_SIZE"]

LEAF_SIZE = 8


@dataclasses.dataclass(frozen=True)
class BvhData:
    """A built BVH in the scene's real type (float32 or float64, as the
    reference builds it): node boxes (the float32 values of the SAH build),
    triangles and normals in that type, indices int32."""

    node_min: torch.Tensor  # (M, 3)
    node_max: torch.Tensor  # (M, 3)
    is_leaf: torch.Tensor  # (M,) int32 {0,1}
    skip: torch.Tensor  # (M,) int32: next node on a box miss / after a leaf
    leaf_tris: torch.Tensor  # (M, LEAF_SIZE) int32 triangle ids, -1 padded
    leaf_start: torch.Tensor  # (M,) int32 first triangle of a leaf (0 if internal)
    leaf_count: torch.Tensor  # (M,) int32 triangles in a leaf (0 if internal)
    verts: torch.Tensor  # (T, 3, 3) world space, leaf-contiguous order
    norms: torch.Tensor  # (T, 3, 3)
    mat_id: torch.Tensor  # (T,) int32

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]

    @property
    def num_tris(self) -> int:
        return self.verts.shape[0]


def bvh_from_arrays(arrays: dict, device=None, dtype=torch.float32) -> BvhData:
    """BvhData from host arrays keyed by field name, its floats in `dtype`."""
    dt = {f.name: (dtype if f.name in ("node_min", "node_max", "verts", "norms") else torch.int32)
          for f in dataclasses.fields(BvhData)}
    return BvhData(**{
        k: torch.as_tensor(np.ascontiguousarray(arrays[k]), dtype=dt[k], device=device) for k in dt
    })


def build_bvh(verts: np.ndarray, norms: np.ndarray, mats: np.ndarray, dtype=torch.float32,
              device=None) -> BvhData:
    """Host-side SAH build over world-space triangles (T, 3, 3); the
    triangles and normals are kept in `dtype`, the node boxes are the
    SAH build's float32 values in it (as the reference keeps them)."""
    np_dtype = numpy_real(dtype)
    verts = np.asarray(verts)
    tri_min = verts.min(axis=1)
    tri_max = verts.max(axis=1)
    node_min, node_max, is_leaf, skip, leaf_start, leaf_count, perm = build_bvh_sah(
        tri_min, tri_max, LEAF_SIZE
    )
    M = node_min.shape[0]
    leaf_tris = np.full((M, LEAF_SIZE), -1, np.int32)
    leaves = np.flatnonzero(is_leaf)
    cols = np.arange(LEAF_SIZE)[None, :]
    ids = leaf_start[leaves][:, None] + cols
    mask = cols < leaf_count[leaves][:, None]
    rows = leaf_tris[leaves]
    rows[mask] = ids[mask].astype(np.int32)
    leaf_tris[leaves] = rows
    return bvh_from_arrays(
        dict(
            node_min=node_min, node_max=node_max, is_leaf=is_leaf, skip=skip,
            leaf_tris=leaf_tris, leaf_start=leaf_start, leaf_count=leaf_count,
            verts=verts[perm].astype(np_dtype),
            norms=np.asarray(norms)[perm].astype(np_dtype),
            mat_id=np.asarray(mats)[perm].astype(np.int32),
        ),
        device,
        dtype,
    )


def outward(lo: np.ndarray, hi: np.ndarray):
    """float64 boxes lo-hi as float32 boxes that hold them: each bound
    rounded down (lo) or up (hi)."""
    lo32 = np.asarray(lo).astype(np.float32)
    hi32 = np.asarray(hi).astype(np.float32)
    lo32 = np.where(lo32.astype(np.float64) > lo, np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32.astype(np.float64) < hi, np.nextafter(hi32, np.float32(np.inf)), hi32)
    return lo32, hi32


def widen(lo: np.ndarray, hi: np.ndarray):
    """The SAH build's float32 boxes lo-hi widened one float32 ulp each way,
    for a float64 pack. The SAH build rounds each float64 triangle's bounds to
    the nearest float32, so its box can lie half an ulp inside a float64
    triangle and prune that triangle's hit; one ulp out, it holds it."""
    lo32 = np.asarray(lo).astype(np.float32)
    hi32 = np.asarray(hi).astype(np.float32)
    return np.nextafter(lo32, np.float32(-np.inf)), np.nextafter(hi32, np.float32(np.inf))


def _tri_hit_t(o, d, v0, v1, v2, t_min):
    """Hit times for per-ray triangle bundles: o, d (N,1,3) or (N,3);
    v* (N,K,3) or (N,3). Returns (t with INF on a miss, (u, v, w))."""
    e1 = v1 - v0
    e2 = v2 - v0
    pn = normalize(cross(e1, e2))
    cos = dot(pn, d)
    cos_safe = torch.where(torch.abs(cos) > 1e-8, cos, torch.full_like(cos, 1e-8))
    t = dot(pn, v0 - o) / cos_safe
    p = o + t[..., None] * d
    dd = p - v0
    d00 = dot(e1, e1)
    d01 = dot(e1, e2)
    d11 = dot(e2, e2)
    d20 = dot(dd, e1)
    d21 = dot(dd, e2)
    denom = d00 * d11 - d01 * d01
    denom_safe = torch.where(torch.abs(denom) > 1e-20, denom, torch.full_like(denom, 1e-20))
    v = (d11 * d20 - d01 * d21) / denom_safe
    w = (d00 * d21 - d01 * d20) / denom_safe
    u = 1.0 - v - w
    ok = (torch.abs(cos) >= 1e-8) & (t >= t_min) & (u >= 0.0) & (v >= 0.0) & (w >= 0.0)
    return torch.where(ok, t, torch.full_like(t, INF)), (u, v, w)


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(d) > 1e-20, d, signed_full(d < 0, 1e-20, d))



def refuse_ray_grad(walk: str, o: torch.Tensor, d: torch.Tensor) -> None:
    """Raise if rays that require grad would enter a traversal under
    autograd. The walks (kernel and plain) give a hit time with no gradient,
    so a gradient through `o + t d` would silently lose dt/d(ray); the
    reference cannot differentiate its walk either (reverse mode through
    `lax.while_loop` raises), so a camera gradient exists only for scenes
    without a BVH. Material gradients never see this: their rays do not
    depend on the materials."""
    if torch.is_grad_enabled() and (o.requires_grad or d.requires_grad):
        raise ValueError(
            f"{walk}: rays that require grad cannot go through a BVH walk (its hit time carries no gradient); "
            "differentiate the camera of a scene without a BVH, or the materials"
        )


def finalize_hit(bvh: BvhData, o, d, t_min, t_best, best_tri) -> Hit:
    """Recompute the barycentrics of each ray's winning triangle for the
    smooth interpolated normal; the material id rides along. Every
    traversal returns only (t, triangle id) from its hot loop."""
    tri = best_tri.long()
    tv = bvh.verts[tri]
    tn = bvh.norms[tri]
    _, (u, v, w) = _tri_hit_t(o, d, tv[:, 0], tv[:, 1], tv[:, 2], t_min)
    n = normalize(u[:, None] * tn[:, 0] + v[:, None] * tn[:, 1] + w[:, None] * tn[:, 2])
    found = torch.isfinite(t_best)
    return Hit(
        t=torch.where(found, t_best, torch.full_like(t_best, INF)),
        normal=n,
        mat_id=bvh.mat_id[tri],
    )


def finish_closest(bvh: BvhData, o, d, t_min, t_raw, tri, active) -> Hit:
    """The Hit of a one-level walk's (t_raw, triangle id): t = inf on a miss
    and on an inactive lane, the id clamped into the triangle table, then
    `finalize_hit` for the smooth normal and the material."""
    t_best = torch.where(t_raw >= 1.0e38, torch.full_like(t_raw, INF), t_raw)
    if active is not None:
        t_best = torch.where(active, t_best, torch.full_like(t_best, INF))
    tri = torch.clamp(tri, 0, bvh.num_tris - 1)
    return finalize_hit(bvh, o, d, t_min, t_best, tri)


def bvh_closest_hit(bvh: BvhData, o, d, t_min, active=None) -> Hit:
    """Closest hit of N rays against the BVH's triangles, as the reference's
    XLA loop (`rpt_tpu/ops/bvh.py` `bvh_closest_hit`) answers it: the
    nearest triangle in [t_min, inf), among equal t the first leaf in
    preorder; t = inf on a miss and on an inactive lane. It runs the binary
    walk's plain version (`ops/bvh2.py`) on the rays' device, over a pack
    made for the call; a scene compiles its pack once and calls the
    kernels' wrappers instead."""
    from .bvh2 import bvh2_closest_plain, pack_bvh2
    from .walk import check_dtype

    pack = pack_bvh2(bvh, device=o.device)
    check_dtype(pack, o, d)
    t_raw, tri = bvh2_closest_plain(pack, o, d, t_min, active)
    return finish_closest(bvh, o, d, t_min, t_raw, tri, active)
