"""The reference's geometry: every mesh instance baked into world-space
triangles, closest hits and shadow queries answered by testing every
triangle whose cluster's box the ray enters.

Clusters are runs of `CLUSTER` triangles in the Morton order of their
centroids, each with its float64 box widened by a margin; a ray is tested
against every triangle of every cluster whose widened box it enters, so the
answer is the brute-force answer over all triangles. Nothing here reads a
tree or a pack of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.spec import SceneSpec

CLUSTER = 32
# Rays per block: bounds the (rays x clusters) box tests held at once.
RAY_BLOCK = 2048
INF = float("inf")
_PAR_EPS = 1e-8


@dataclasses.dataclass
class Geometry:
    verts: torch.Tensor  # (T, 3, 3) world space, in the reference's type
    norms: torch.Tensor  # (T, 3, 3) world-space shading normals (unnormalized)
    tri_mat: torch.Tensor  # (T,) int64 material row
    box_lo: torch.Tensor  # (C, 3) float64 cluster boxes, widened
    box_hi: torch.Tensor
    planes: list  # [(normal (3,) tensor, value, material row)]
    materials: dict  # column -> (M, k) tensor


def _morton(p: np.ndarray) -> np.ndarray:
    lo, hi = p.min(0), p.max(0)
    q = np.clip((p - lo) / np.maximum(hi - lo, 1e-30) * 1023.0, 0, 1023).astype(np.uint64)
    code = np.zeros(p.shape[0], np.uint64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> np.uint64(bit)) & np.uint64(1)) << np.uint64(3 * bit + axis)
    return code


def prepare(spec: SceneSpec, device, dtype) -> Geometry:
    """World triangles, their clusters and the material table of `spec`."""
    mats, mat_row = [], {}

    def row(m):
        if m not in mat_row:
            mat_row[m] = len(mats)
            mats.append(m)
        return mat_row[m]

    verts, norms, tri_mat, planes = [], [], [], []
    for o in spec.objects:
        r = row(o.material)
        if o.mesh is None:
            planes.append((np.asarray(o.normal, np.float64), float(o.value), r))
            continue
        mesh = spec.meshes[o.mesh]
        lin, trans = o.matrix[:3, :3], o.matrix[:3, 3]
        verts.append(mesh.vertices @ lin.T + trans)
        norms.append(mesh.normals @ np.linalg.inv(lin))
        tri_mat.append(np.full(mesh.vertices.shape[0], r, np.int64))
    v = np.concatenate(verts)
    order = np.argsort(_morton(v.mean(1)), kind="stable")
    v, n, tm = v[order], np.concatenate(norms)[order], np.concatenate(tri_mat)[order]
    pad = (-v.shape[0]) % CLUSTER
    # Pad with copies of the last triangle: a repeat never changes a closest hit.
    vp = np.concatenate([v, np.repeat(v[-1:], pad, 0)]).reshape(-1, CLUSTER, 3, 3)
    margin = 1e-4 * float(np.abs(v).max() + 1.0)
    as_t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)  # noqa: E731
    cols = {
        "color": [m.color for m in mats], "index": [m.index for m in mats], "roughness": [m.roughness for m in mats],
        "metallic": [m.metallic for m in mats], "emittance": [m.emittance for m in mats],
        "transparent": [1.0 if m.transparent else 0.0 for m in mats],
    }
    return Geometry(
        verts=as_t(np.concatenate([v, np.repeat(v[-1:], pad, 0)]).astype(np.float32), dtype),
        norms=as_t(np.concatenate([n, np.repeat(n[-1:], pad, 0)]).astype(np.float32), dtype),
        tri_mat=as_t(np.concatenate([tm, np.repeat(tm[-1:], pad, 0)]), torch.int64),
        box_lo=as_t(vp.min(axis=(1, 2)) - margin, torch.float64),
        box_hi=as_t(vp.max(axis=(1, 2)) + margin, torch.float64),
        planes=[(as_t(nrm.astype(np.float32), dtype), float(np.float32(val)), r) for nrm, val, r in planes],
        materials={k: as_t(np.asarray(c, np.float32), dtype) for k, c in cols.items()},
    )


def dot(a, b):
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v, eps: float = 1e-20):
    n2 = dot(v, v)
    ok = n2 > eps
    inv = torch.where(ok, torch.rsqrt(torch.where(ok, n2, torch.ones_like(n2))), torch.zeros_like(n2))
    return v * inv[..., None]


def tri_hit(o, d, t_min, v0, v1, v2):
    """Hit times of rays o, d (..., 3) against triangles v* (..., 3): the
    plane of the triangle, then the barycentric inside test. Returns (t,
    INF on a miss; u, v, w)."""
    e1, e2 = v1 - v0, v2 - v0
    pn = normalize(cross(e1, e2))
    cos = dot(pn, d)
    cos_safe = torch.where(torch.abs(cos) > _PAR_EPS, cos, torch.full_like(cos, _PAR_EPS))
    t = dot(pn, v0 - o) / cos_safe
    dd = (o + t[..., None] * d) - v0
    d00, d01, d11 = dot(e1, e1), dot(e1, e2), dot(e2, e2)
    d20, d21 = dot(dd, e1), dot(dd, e2)
    denom = d00 * d11 - d01 * d01
    denom = torch.where(torch.abs(denom) > 1e-20, denom, torch.full_like(denom, 1e-20))
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w
    ok = (torch.abs(cos) >= _PAR_EPS) & (t >= t_min) & (u >= 0.0) & (v >= 0.0) & (w >= 0.0)
    return torch.where(ok, t, torch.full_like(t, INF)), (u, v, w)


def _blocks(g: Geometry, o, d, t_min):
    """For each block of `RAY_BLOCK` rays: (first ray, ray index in the
    block, triangle index, hit time) of every triangle in a cluster whose
    widened box the ray enters at t >= t_min less a margin."""
    o64, d64 = o.double(), d.double()
    inv = 1.0 / torch.where(d64.abs() > 1e-300, d64, torch.full_like(d64, 1e-300))
    lanes = torch.arange(CLUSTER, device=o.device)
    for s in range(0, o.shape[0], RAY_BLOCK):
        ob, ib = o64[s:s + RAY_BLOCK, None, :], inv[s:s + RAY_BLOCK, None, :]
        t1 = (g.box_lo[None] - ob) * ib
        t2 = (g.box_hi[None] - ob) * ib
        near = torch.minimum(t1, t2).amax(-1)
        far = torch.maximum(t1, t2).amin(-1)
        # Written so that a NaN slab (a zero direction component on a box face)
        # keeps the cluster: the cull may only ever keep too much.
        r, c = torch.nonzero(~((near > far) | (far < t_min - 1e-3)), as_tuple=True)
        r = r[:, None].expand(-1, CLUSTER).reshape(-1)
        k = (c[:, None] * CLUSTER + lanes[None]).reshape(-1)
        tv = g.verts[k]
        t, _ = tri_hit(o[s:s + RAY_BLOCK][r], d[s:s + RAY_BLOCK][r], t_min, tv[:, 0], tv[:, 1], tv[:, 2])
        yield s, r, k, t


def _plane_t(nrm, value, o, d, t_min):
    cos = dot(nrm, d)
    cos_safe = torch.where(torch.abs(cos) > _PAR_EPS, cos, torch.full_like(cos, _PAR_EPS))
    t = (value - dot(nrm, o)) / cos_safe
    ok = (torch.abs(cos) >= _PAR_EPS) & (t >= t_min)
    return torch.where(ok, t, torch.full_like(t, INF)), cos


def _tri_closest(g: Geometry, o, d, t_min):
    """(t, triangle) of each ray's nearest triangle, the lowest index among
    equal times; t = INF and triangle -1 on a miss."""
    n = o.shape[0]
    t_best = torch.full((n,), INF, dtype=o.dtype, device=o.device)
    big = torch.iinfo(torch.int64).max
    winner = torch.full((n,), big, dtype=torch.int64, device=o.device)
    for s, r, k, t in _blocks(g, o, d, t_min):
        m = min(RAY_BLOCK, n - s)
        tb = torch.full((m,), INF, dtype=o.dtype, device=o.device).scatter_reduce(0, r, t, "amin")
        at = torch.isfinite(t) & (t == tb[r])
        wb = torch.full((m,), big, dtype=torch.int64, device=o.device).scatter_reduce(0, r[at], k[at], "amin")
        t_best[s:s + m] = tb
        winner[s:s + m] = wb
    return t_best, torch.where(winner < big, winner, torch.full_like(winner, -1))


def closest(g: Geometry, o, d, t_min, active):
    """(t (N,), unit normal (N, 3), material row (N,)) of the nearest
    surface at t >= t_min; t = INF on a miss and on an inactive lane.
    Planes first; a triangle replaces a plane only when strictly nearer."""
    n_rays = o.shape[0]
    t_best = torch.full((n_rays,), INF, dtype=o.dtype, device=o.device)
    normal = torch.zeros_like(o)
    mat = torch.zeros(n_rays, dtype=torch.int64, device=o.device)
    for nrm, value, row in g.planes:
        t, cos = _plane_t(nrm, value, o, d, t_min)
        take = t < t_best
        t_best = torch.where(take, t, t_best)
        normal = torch.where(take[:, None], -normalize(nrm) * torch.sign(cos)[:, None], normal)
        mat = torch.where(take, torch.full_like(mat, row), mat)
    lanes = torch.nonzero(active, as_tuple=True)[0]
    if lanes.numel():
        ol, dl = o[lanes], d[lanes]
        t_tri, tri = _tri_closest(g, ol, dl, t_min)
        win = tri.clamp(min=0)
        tv, tn = g.verts[win], g.norms[win]
        _, (u, v, w) = tri_hit(ol, dl, t_min, tv[:, 0], tv[:, 1], tv[:, 2])
        n_t = normalize(u[:, None] * tn[:, 0] + v[:, None] * tn[:, 1] + w[:, None] * tn[:, 2])
        take = (tri >= 0) & (t_tri < t_best[lanes])
        t_best[lanes] = torch.where(take, t_tri, t_best[lanes])
        normal[lanes] = torch.where(take[:, None], n_t, normal[lanes])
        mat[lanes] = torch.where(take, g.tri_mat[win], mat[lanes])
    t_best = torch.where(active, t_best, torch.full_like(t_best, INF))
    return t_best, normal, mat


def occluded(g: Geometry, o, d, t_min, t_max, active):
    """True where the lane is active and some surface lies at t in
    [t_min, t_max]."""
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for nrm, value, _ in g.planes:
        occ = occ | (_plane_t(nrm, value, o, d, t_min)[0] <= t_max)
    lanes = torch.nonzero(active, as_tuple=True)[0]
    if lanes.numel():
        ol, dl, tl = o[lanes], d[lanes], t_max[lanes]
        blocked = torch.zeros(lanes.numel(), dtype=torch.bool, device=o.device)
        for s, r, _, t in _blocks(g, ol, dl, t_min):
            blocked[s + r[t <= tl[s + r]]] = True
        occ[lanes] = occ[lanes] | blocked
    return occ & active
