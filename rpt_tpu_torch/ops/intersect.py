"""Batched ray-primitive intersection (`rpt_tpu/ops/intersect.py`).

Every function intersects N rays against P primitives of one type as one
(N, P) broadcast and reduces to the closest hit per ray; the scene-level
closest hit is the running min across primitive types (`merge_hits`).

Conventions kept from the reference: hit times are in the original ray
parameterization even for transformed primitives (local rays keep the
unnormalized transformed direction); normals go through the
inverse-transpose and are normalized; a miss is t = +inf. The winner's
attributes are picked with a gather where the reference uses one-hot
reductions (the TPU has no fast per-lane gather); both give the same values.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.vmath import cross, dot, normalize, safe_sqrt, signed_full

__all__ = [
    "Hit",
    "no_hit",
    "merge_hits",
    "intersect_spheres",
    "intersect_planes",
    "intersect_cubes",
    "intersect_triangles",
    "intersect_monomials",
    "triangles_hit_t",
    "occluded_spheres",
    "occluded_planes",
    "occluded_cubes",
    "occluded_triangles",
]

INF = float("inf")
_PAR_EPS = 1e-8  # parallel-ray guard


@dataclasses.dataclass(frozen=True)
class Hit:
    """Closest-hit record for a batch of rays."""

    t: torch.Tensor  # (N,) hit time, +inf on a miss
    normal: torch.Tensor  # (N, 3) world-space unit normal (garbage on a miss)
    mat_id: torch.Tensor  # (N,) int32 material index (0 on a miss)

    @property
    def valid(self) -> torch.Tensor:
        return torch.isfinite(self.t)


def no_hit(n: int, dtype=torch.float32, device=None) -> Hit:
    return Hit(
        t=torch.full((n,), INF, dtype=dtype, device=device),
        normal=torch.zeros((n, 3), dtype=dtype, device=device),
        mat_id=torch.zeros((n,), dtype=torch.int32, device=device),
    )


def merge_hits(a: Hit, b: Hit) -> Hit:
    """Keep the closer hit per ray; on a tie the first (`a`) wins."""
    take_b = b.t < a.t
    return Hit(
        t=torch.where(take_b, b.t, a.t),
        normal=torch.where(take_b[..., None], b.normal, a.normal),
        mat_id=torch.where(take_b, b.mat_id, a.mat_id),
    )


def _local_rays(o, d, inv_tf):
    """Rays in each primitive's local frame, (N, P, 3) each. Directions are
    not normalized, so local hit times equal world hit times."""
    A = inv_tf[:, :, :3]
    b = inv_tf[:, :, 3]
    o_l = torch.einsum("pij,nj->npi", A, o) + b[None, :, :]
    d_l = torch.einsum("pij,nj->npi", A, d)
    return o_l, d_l


def _world_normal(nmat, n_local):
    return normalize(torch.einsum("...ij,...j->...i", nmat, n_local))


def _winner(t_pairs, t_min):
    """(t_best (N,), best (N,) index of the closest valid primitive; the
    first one on ties, primitive 0 when every primitive misses)."""
    t_pairs = torch.where(t_pairs >= t_min, t_pairs, torch.full_like(t_pairs, INF))
    best = torch.argmin(t_pairs, dim=1)
    t_best = torch.gather(t_pairs, 1, best[:, None])[:, 0]
    return t_best, best


def _sel(best, x):
    """The winning primitive's value of x, (N, P) -> (N,) or (N, P, k) -> (N, k)."""
    if x.dim() == 2:
        return torch.gather(x, 1, best[:, None])[:, 0]
    idx = best[:, None, None].expand(-1, 1, x.shape[2])
    return torch.gather(x, 1, idx)[:, 0]


def _safe_div_dir(d_l):
    return torch.where(torch.abs(d_l) > 1e-20, d_l, signed_full(d_l < 0, 1e-20, d_l))


# Sphere: unit sphere in local space ------------------------------------------


def _sphere_t(o_l, d_l, t_min):
    a = dot(d_l, d_l)
    b = dot(d_l, o_l)
    c = dot(o_l, o_l) - 1.0
    disc = b * b - a * c
    ok = disc >= 0.0
    sq = safe_sqrt(disc)
    a_safe = torch.where(torch.abs(a) > 1e-20, a, torch.full_like(a, 1e-20))
    t_minus = (-b - sq) / a_safe
    t_plus = (-b + sq) / a_safe
    t = torch.where(t_minus >= t_min, t_minus, t_plus)
    return torch.where(ok & (t >= t_min), t, torch.full_like(t, INF))


def intersect_spheres(o, d, t_min, inv_tf, nmat, mat_ids) -> Hit:
    o_l, d_l = _local_rays(o, d, inv_tf)
    t = _sphere_t(o_l, d_l, t_min)
    t_best, best = _winner(t, t_min)
    # Misses evaluate the normal at t = 0 so no inf enters the arithmetic.
    t_eval = torch.where(torch.isfinite(t_best), t_best, torch.zeros_like(t_best))
    p_local = _sel(best, o_l) + t_eval[:, None] * _sel(best, d_l)
    n_world = _world_normal(nmat[best], normalize(p_local))
    return Hit(t=t_best, normal=n_world, mat_id=mat_ids[best])


# Plane: x . normal = value, world space --------------------------------------


def _plane_t(o, d, t_min, normals, values):
    cos = torch.einsum("pj,nj->np", normals, d)
    cos_safe = torch.where(torch.abs(cos) > _PAR_EPS, cos, torch.full_like(cos, _PAR_EPS))
    t = (values[None, :] - torch.einsum("pj,nj->np", normals, o)) / cos_safe
    ok = (torch.abs(cos) >= _PAR_EPS) & (t >= t_min)
    return torch.where(ok, t, torch.full_like(t, INF)), cos


def intersect_planes(o, d, t_min, normals, values, mat_ids) -> Hit:
    t, cos = _plane_t(o, d, t_min, normals, values)
    t_best, best = _winner(t, t_min)
    # Normal flipped toward the ray.
    n = normalize(normals[best])
    n_world = -n * torch.sign(_sel(best, cos))[:, None]
    return Hit(t=t_best, normal=n_world, mat_id=mat_ids[best])


# Cube: unit cube slab test in local space ------------------------------------


def _cube_slabs(o_l, d_l):
    d_safe = _safe_div_dir(d_l)
    t1 = (-0.5 - o_l) / d_safe
    t2 = (0.5 - o_l) / d_safe
    return torch.minimum(t1, t2), torch.maximum(t1, t2)


def intersect_cubes(o, d, t_min, inv_tf, nmat, mat_ids) -> Hit:
    o_l, d_l = _local_rays(o, d, inv_tf)
    lo, hi = _cube_slabs(o_l, d_l)
    start, start_axis = torch.max(lo, dim=-1)
    end, end_axis = torch.min(hi, dim=-1)

    miss = (start > end) | (end < t_min)
    use_end = start < t_min
    t = torch.where(use_end, end, start)
    t = torch.where(miss | (t < t_min), torch.full_like(t, INF), t)

    t_best, best = _winner(t, t_min)
    axis = _sel(best, torch.where(use_end, end_axis, start_axis))
    use_end_b = _sel(best, use_end)
    d_sel = _sel(best, d_l)
    d_axis = torch.gather(d_sel, 1, axis[:, None])[:, 0]
    # Entry face normal points against the ray, exit face along it.
    sign = torch.where(use_end_b, torch.sign(d_axis), -torch.sign(d_axis))
    n_local = torch.nn.functional.one_hot(axis, 3).to(o.dtype) * sign[:, None]
    n_world = _world_normal(nmat[best], n_local)
    return Hit(t=t_best, normal=n_world, mat_id=mat_ids[best])


# Triangle: plane hit + barycentric inside test --------------------------------


def triangles_hit_t(o, d, t_min, v0, v1, v2):
    """Hit times of N rays against T world-space triangles, (N, T), plus
    the barycentrics (u, v, w)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pn = normalize(cross(e1, e2))
    cos = torch.einsum("tj,nj->nt", pn, d)
    cos_safe = torch.where(torch.abs(cos) > _PAR_EPS, cos, torch.full_like(cos, _PAR_EPS))
    t = (dot(pn, v0)[None, :] - torch.einsum("tj,nj->nt", pn, o)) / cos_safe

    p = o[:, None, :] + t[..., None] * d[:, None, :]
    d2 = p - v0[None, :, :]
    d00 = dot(e1, e1)
    d01 = dot(e1, e2)
    d11 = dot(e2, e2)
    d20 = torch.einsum("ntj,tj->nt", d2, e1)
    d21 = torch.einsum("ntj,tj->nt", d2, e2)
    denom = d00 * d11 - d01 * d01
    denom_safe = torch.where(torch.abs(denom) > 1e-20, denom, torch.full_like(denom, 1e-20))
    v = (d11 * d20 - d01 * d21) / denom_safe
    w = (d00 * d21 - d01 * d20) / denom_safe
    u = 1.0 - v - w

    inside = (u >= 0.0) & (v >= 0.0) & (w >= 0.0)
    ok = (torch.abs(cos) >= _PAR_EPS) & (t >= t_min) & inside
    return torch.where(ok, t, torch.full_like(t, INF)), (u, v, w)


def intersect_triangles(o, d, t_min, verts, norms, mat_ids) -> Hit:
    """Brute-force closest hit against T triangles (large meshes go through
    the BVH in `rpt_tpu_torch.ops.bvh8`)."""
    t, (u, v, w) = triangles_hit_t(o, d, t_min, verts[:, 0], verts[:, 1], verts[:, 2])
    t_best, best = _winner(t, t_min)
    ub, vb, wb = _sel(best, u), _sel(best, v), _sel(best, w)
    nb = norms[best]
    n_interp = ub[:, None] * nb[:, 0] + vb[:, None] * nb[:, 1] + wb[:, None] * nb[:, 2]
    return Hit(t=t_best, normal=normalize(n_interp), mat_id=mat_ids[best])


# Monomial surface y = h (x^2 + z^2)^2, x^2 + z^2 <= 1, in local space:
# Newton steps to bracket the root, then bisection (the reference's fixed
# 10 and 60 steps, so the loops unroll into a fixed sequence of launches
# that a CUDA graph captures). Only exp = 4 exists, as in the reference.

_NEWTON_STEPS = 10
_BISECT_STEPS = 60


def _bbox_interval(o_l, d_l, p_min, p_max):
    d_safe = _safe_div_dir(d_l)
    t1 = (p_min - o_l) / d_safe
    t2 = (p_max - o_l) / d_safe
    return torch.amax(torch.minimum(t1, t2), dim=-1), torch.amin(torch.maximum(t1, t2), dim=-1)


def intersect_monomials(o, d, t_min, inv_tf, nmat, heights, mat_ids) -> Hit:
    o_l, d_l = _local_rays(o, d, inv_tf)  # (N, P, 3)
    h = heights[None, :]  # (1, P)

    one, zero = torch.ones_like(heights), torch.zeros_like(heights)
    p_min = torch.stack([-one, zero, -one], -1)
    p_max = torch.stack([one, heights, one], -1)
    b_min, b_max = _bbox_interval(o_l, d_l, p_min[None], p_max[None])  # (N, P)
    gate = torch.clamp(b_min, min=t_min) <= b_max

    ox, oy, oz = o_l[..., 0], o_l[..., 1], o_l[..., 2]
    dx, dy, dz = d_l[..., 0], d_l[..., 1], d_l[..., 2]

    def dist(t):
        x = ox + t * dx
        y = oy + t * dy
        z = oz + t * dz
        r2 = x * x + z * z
        return y - h * r2 * r2

    coef0 = ox * ox + oz * oz
    coef1 = 2.0 * (ox * dx + oz * dz)
    coef2 = dx * dx + dz * dz

    def deriv(t):
        dq = (
            2.0 * coef0 * coef1
            + 2.0 * t * (coef1 * coef1 + 2.0 * coef0 * coef2)
            + 6.0 * t * t * coef1 * coef2
            + 4.0 * t * t * t * coef2 * coef2
        )
        return dy - h * dq

    def deriv2(t):
        dq = 2.0 * (coef1 * coef1 + 2.0 * coef0 * coef2) + 12.0 * t * coef1 * coef2 + 12.0 * t * t * coef2 * coef2
        return -h * dq

    maximize = dist(t_min) < 0.0

    # Newton bracketing: walk toward the surface's maximum along the ray,
    # stopping the lanes where dist > 0.
    cur = (b_min + b_max) / 2.0
    for _ in range(_NEWTON_STEPS):
        stop = dist(cur) > 0.0
        der2 = deriv2(cur)
        step = deriv(cur) / torch.where(torch.abs(der2) > 1e-20, der2, torch.full_like(der2, 1e-20))
        cur = torch.where(stop, cur, cur - step)
    t_max = torch.where(maximize, cur, torch.full_like(cur, 10000.0))
    bad_bracket = maximize & (t_max < t_min)

    sign_change = (dist(t_min) < 0.0) != (dist(t_max) < 0.0)

    lo, hi = torch.full_like(t_max, t_min), t_max
    for _ in range(_BISECT_STEPS):
        m = (lo + hi) / 2.0
        go_right = (dist(m) >= 0.0) == maximize
        lo, hi = torch.where(go_right, lo, m), torch.where(go_right, m, hi)
    r = hi

    pos_x = ox + r * dx
    pos_z = oz + r * dz
    in_disk = pos_x * pos_x + pos_z * pos_z <= 1.0

    ok = gate & (~bad_bracket) & sign_change & in_disk & (r >= t_min)
    t = torch.where(ok, r, torch.full_like(r, INF))

    t_best, best = _winner(t, t_min)
    px = _sel(best, pos_x)
    pz = _sel(best, pos_z)
    hb = heights[best]
    r2 = px * px + pz * pz
    n_local = normalize(torch.stack([hb * 4.0 * px * r2, -torch.ones_like(px), hb * 4.0 * pz * r2], -1))
    # Two-sided: the normal is flipped toward the ray.
    flip = dot(n_local, _sel(best, d_l)) > 0.0
    n_local = torch.where(flip[:, None], -n_local, n_local)
    return Hit(t=t_best, normal=_world_normal(nmat[best], n_local), mat_id=mat_ids[best])


# Any-hit shadow queries: the same per-primitive hit times as the closest-hit
# twins, min-reduced and compared once, so each is boolean-equal to
# `intersect_*(...).t <= t_max`.


def occluded_spheres(o, d, t_min, t_max, inv_tf, nmat, mat_ids) -> torch.Tensor:
    o_l, d_l = _local_rays(o, d, inv_tf)
    return torch.amin(_sphere_t(o_l, d_l, t_min), dim=1) <= t_max


def occluded_planes(o, d, t_min, t_max, normals, values, mat_ids) -> torch.Tensor:
    t, _ = _plane_t(o, d, t_min, normals, values)
    return torch.amin(t, dim=1) <= t_max


def occluded_cubes(o, d, t_min, t_max, inv_tf, nmat, mat_ids) -> torch.Tensor:
    o_l, d_l = _local_rays(o, d, inv_tf)
    lo, hi = _cube_slabs(o_l, d_l)
    start = torch.amax(lo, dim=-1)
    end = torch.amin(hi, dim=-1)
    t = torch.where(start < t_min, end, start)
    t = torch.where((start <= end) & (end >= t_min) & (t >= t_min), t, torch.full_like(t, INF))
    return torch.amin(t, dim=1) <= t_max


def occluded_triangles(o, d, t_min, t_max, verts, norms, mat_ids) -> torch.Tensor:
    t, _ = triangles_hit_t(o, d, t_min, verts[:, 0], verts[:, 1], verts[:, 2])
    return torch.amin(t, dim=1) <= t_max
