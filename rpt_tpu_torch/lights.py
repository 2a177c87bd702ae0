"""Lights: point / ambient / directional / emissive-object area lights.

Counterpart of `rpt_tpu/lights.py`. Host-side specs compile to small
dataclasses of tensors whose `illuminate(key, pos)` returns, for N shading
points, (intensity (N,3), dir_to_light (N,3), dist_to_light (N,)). Area
lights sample the sphere, cube and triangle mesh as the reference does,
drawing in the type of `pos` (float64 and int64 draws in a float64 render,
as the reference's default-typed draws under `jax_enable_x64`), and the
monomial surface as the reference samples it: a point of its rim and a
two-sided normal. The clamps differentiate as the reference's
`jnp.maximum` (`utils.vmath.maximum`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import random as rnd
from .sampling import uniform_disk, uniform_triangle_barycentric
from .utils.vmath import cross, dot, maximum, normalize, safe_sqrt

__all__ = [
    "PointLight",
    "AmbientLight",
    "DirectionalLight",
    "ObjectLight",
    "PointLightData",
    "AmbientLightData",
    "DirectionalLightData",
    "SphereLightData",
    "CubeLightData",
    "MeshLightData",
    "MonomialLightData",
]


# ---------------------------------------------------------------------------
# Host-side specs (what users put into a Scene)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PointLight:
    color: tuple
    position: tuple

    def __init__(self, color, position):
        object.__setattr__(self, "color", tuple(np.asarray(color, float).reshape(3)))
        object.__setattr__(self, "position", tuple(np.asarray(position, float).reshape(3)))


@dataclasses.dataclass(frozen=True)
class AmbientLight:
    color: tuple

    def __init__(self, color):
        object.__setattr__(self, "color", tuple(np.asarray(color, float).reshape(3)))


@dataclasses.dataclass(frozen=True)
class DirectionalLight:
    color: tuple
    direction: tuple

    def __init__(self, color, direction):
        object.__setattr__(self, "color", tuple(np.asarray(color, float).reshape(3)))
        object.__setattr__(self, "direction", tuple(np.asarray(direction, float).reshape(3)))


class ObjectLight:
    """Light from an invisible emissive object: sampled for next-event
    estimation, never intersected by visibility rays."""

    def __init__(self, obj):
        self.object = obj


# ---------------------------------------------------------------------------
# Compiled lights
# ---------------------------------------------------------------------------


def _int_of(pos: torch.Tensor) -> torch.dtype:
    """The integer type of the render's draws: int32 in a float32 render,
    int64 in a float64 one (JAX's default int under `jax_enable_x64`)."""
    return torch.int32 if pos.dtype == torch.float32 else torch.int64


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(3,3) matrix times (..., 3) vectors."""
    return torch.einsum("ij,...j->...i", m, v)


@dataclasses.dataclass(frozen=True)
class PointLightData:
    color: torch.Tensor  # (3,)
    position: torch.Tensor  # (3,)

    def illuminate(self, key, pos):
        disp = self.position - pos
        ln = torch.linalg.vector_norm(disp, dim=-1)
        ln_safe = maximum(ln, 1e-12)
        intensity = self.color / (ln_safe * ln_safe)[..., None]
        return intensity, disp / ln_safe[..., None], ln


@dataclasses.dataclass(frozen=True)
class AmbientLightData:
    """Handled by the integrator: adds color * albedo, no shadow ray."""

    color: torch.Tensor  # (3,)


@dataclasses.dataclass(frozen=True)
class DirectionalLightData:
    color: torch.Tensor  # (3,)
    direction: torch.Tensor  # (3,)

    def illuminate(self, key, pos):
        n = pos.shape[0]
        wi = torch.broadcast_to(-normalize(self.direction), (n, 3))
        intensity = torch.broadcast_to(self.color, (n, 3))
        return intensity, wi, torch.full((n,), math.inf, dtype=pos.dtype, device=pos.device)


def _object_light_intensity(v, n, p, emitted, world_pos):
    """Geometric term shared by the emissive-object lights."""
    disp = v - world_pos
    ln = torch.linalg.vector_norm(disp, dim=-1)
    ln_safe = maximum(ln, 1e-12)
    cosine = maximum(-dot(disp, n), 0.0) / ln_safe
    surface_area = maximum(cosine, 0.0) / (ln_safe * ln_safe)
    p_safe = maximum(p, 1e-20)
    intensity = emitted * (surface_area / p_safe)[..., None]
    return intensity, disp / ln_safe[..., None], ln


def _transform_sample(l2w_lin, l2w_trans, nmat, det, v_local, n_local, p_local):
    """Map a local-space light sample to world space and rescale its pdf."""
    v = _mv(l2w_lin, v_local) + l2w_trans
    n = normalize(_mv(nmat, n_local))
    ph = dot(_mv(l2w_lin, n_local), n)
    base = det / torch.where(torch.abs(ph) > 1e-20, ph, torch.full_like(ph, 1e-20))
    return v, n, p_local / base


@dataclasses.dataclass(frozen=True)
class SphereLightData:
    """Emissive (possibly transformed) unit sphere."""

    inv_tf: torch.Tensor  # (3,4) world->local affine
    l2w_lin: torch.Tensor  # (3,3)
    l2w_trans: torch.Tensor  # (3,)
    nmat: torch.Tensor  # (3,3) inverse-transpose linear
    det: torch.Tensor  # () determinant of the linear part
    emitted: torch.Tensor  # (3,) color * emittance

    def illuminate(self, key, pos):
        # Cosine-weighted hemisphere facing the local-space target.
        tgt = _mv(self.inv_tf[:, :3], pos) + self.inv_tf[:, 3]
        n = normalize(tgt)
        nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
        use_x = torch.abs(nx) > 1e-12
        zero = torch.zeros_like(nx)
        t_a = torch.stack([ny, -nx, zero], -1)
        t_b = torch.stack([zero, -nz, ny], -1)
        n1 = normalize(torch.where(use_x[..., None], t_a, t_b))
        n2 = cross(n1, n)
        xy = uniform_disk(key, tuple(pos.shape[:-1]), device=pos.device, dtype=pos.dtype)
        z = safe_sqrt(1.0 - torch.sum(xy * xy, -1))
        p_local = xy[..., 0:1] * n1 + xy[..., 1:2] * n2 + z[..., None] * n
        pdf = z / math.pi
        v, nrm, pdf = _transform_sample(
            self.l2w_lin, self.l2w_trans, self.nmat, self.det, p_local, p_local, pdf
        )
        return _object_light_intensity(v, nrm, pdf, self.emitted, pos)


@dataclasses.dataclass(frozen=True)
class CubeLightData:
    """Emissive (possibly transformed) unit cube; uniform face choice, pdf 1/6."""

    l2w_lin: torch.Tensor
    l2w_trans: torch.Tensor
    nmat: torch.Tensor
    det: torch.Tensor
    emitted: torch.Tensor

    def illuminate(self, key, pos):
        shape = tuple(pos.shape[:-1])
        dev = pos.device
        k1, k2, k3 = rnd.split(key, 3)
        a = rnd.uniform(k1, shape, dtype=pos.dtype, device=dev) - 0.5
        b = rnd.uniform(k2, shape, dtype=pos.dtype, device=dev) - 0.5
        face = rnd.randint(k3, shape, 0, 6, dtype=_int_of(pos), device=dev).long()
        half = torch.full_like(a, 0.5)
        zero = torch.zeros_like(a)
        one = torch.ones_like(a)
        vs = torch.stack(
            [
                torch.stack([a, b, half], -1),
                torch.stack([a, b, -half], -1),
                torch.stack([a, half, b], -1),
                torch.stack([a, -half, b], -1),
                torch.stack([half, a, b], -1),
                torch.stack([-half, a, b], -1),
            ],
            dim=-2,
        )  # (..., 6, 3)
        ns = torch.stack(
            [
                torch.stack([zero, zero, one], -1),
                torch.stack([zero, zero, -one], -1),
                torch.stack([zero, one, zero], -1),
                torch.stack([zero, -one, zero], -1),
                torch.stack([one, zero, zero], -1),
                torch.stack([-one, zero, zero], -1),
            ],
            dim=-2,
        )
        sel = face[..., None, None].expand(*shape, 1, 3)
        v_local = torch.gather(vs, -2, sel)[..., 0, :]
        n_local = torch.gather(ns, -2, sel)[..., 0, :]
        pdf = torch.full(shape, 1.0 / 6.0, dtype=pos.dtype, device=dev)
        v, nrm, pdf = _transform_sample(
            self.l2w_lin, self.l2w_trans, self.nmat, self.det, v_local, n_local, pdf
        )
        return _object_light_intensity(v, nrm, pdf, self.emitted, pos)


@dataclasses.dataclass(frozen=True)
class MeshLightData:
    """Emissive world-space triangle mesh: uniform triangle choice, then a
    uniform point in the triangle with pdf 1/area."""

    verts: torch.Tensor  # (T, 3, 3)
    norms: torch.Tensor  # (T, 3, 3)
    areas: torch.Tensor  # (T,)
    emitted: torch.Tensor  # (3,)

    def illuminate(self, key, pos):
        shape = tuple(pos.shape[:-1])
        dev = pos.device
        k1, k2 = rnd.split(key)
        num = self.verts.shape[0]
        tri = rnd.randint(k1, shape, 0, num, dtype=_int_of(pos), device=dev).long()
        uv = uniform_triangle_barycentric(k2, shape, device=dev, dtype=pos.dtype)
        u, v_ = uv[..., 0], uv[..., 1]
        w = 1.0 - u - v_
        tv = self.verts[tri]  # (..., 3, 3)
        tn = self.norms[tri]
        point = u[..., None] * tv[..., 0, :] + v_[..., None] * tv[..., 1, :] + w[..., None] * tv[..., 2, :]
        nrm = normalize(
            u[..., None] * tn[..., 0, :] + v_[..., None] * tn[..., 1, :] + w[..., None] * tn[..., 2, :]
        )
        pdf = 1.0 / (maximum(self.areas[tri], 1e-20) * num)
        return _object_light_intensity(point, nrm, pdf, self.emitted, pos)


@dataclasses.dataclass(frozen=True)
class MonomialLightData:
    """Emissive (possibly transformed) monomial surface, exp = 4: a uniform
    point of the rim circle (x, h, z) with x^2 + z^2 = 1, the analytic
    normal flipped with probability 1/2 (the surface is two-sided), and pdf
    1 / (2 AREA) with the reference's one-sided area of the height-2 glass."""

    AREA = 6.3406654362

    inv_tf: torch.Tensor  # (3,4) world->local affine (unused; kept as the reference keeps it)
    l2w_lin: torch.Tensor  # (3,3)
    l2w_trans: torch.Tensor  # (3,)
    nmat: torch.Tensor  # (3,3)
    det: torch.Tensor  # ()
    height: torch.Tensor  # ()
    emitted: torch.Tensor  # (3,)

    def illuminate(self, key, pos):
        shape = tuple(pos.shape[:-1])
        dev = pos.device
        k1, k2 = rnd.split(key)
        theta = rnd.uniform(k1, shape, dtype=pos.dtype, minval=0.0, maxval=2.0 * math.pi, device=dev)
        x = torch.cos(theta)
        z = torch.sin(theta)
        h = self.height
        p_local = torch.stack([x, torch.broadcast_to(h, shape), z], -1)
        r2 = x * x + z * z  # 1 on the rim, kept as the reference's formula has it
        n_local = normalize(torch.stack([h * 4.0 * x * r2, -torch.ones_like(x), h * 4.0 * z * r2], -1))
        flip = rnd.bernoulli(k2, 0.5, shape, dtype=pos.dtype, device=dev)
        n_local = torch.where(flip[..., None], -n_local, n_local)
        pdf = torch.full(shape, 1.0 / (2.0 * self.AREA), dtype=pos.dtype, device=dev)
        v, nrm, pdf = _transform_sample(
            self.l2w_lin, self.l2w_trans, self.nmat, self.det, p_local, n_local, pdf
        )
        return _object_light_intensity(v, nrm, pdf, self.emitted, pos)
