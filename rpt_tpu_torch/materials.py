"""Physically-based materials: Cook-Torrance/Beckmann BSDF and sampling.

Counterpart of `rpt_tpu/materials.py`. Materials live in a struct-of-arrays
`MaterialTable` gathered by material id per hit; `bsdf` evaluates the
reflection and refraction branches branch-free with guarded denominators,
and `sample_f` draws lobe, Beckmann half-vector, cosine hemisphere and
refraction from threefry keys (`sample_draws`, which the fused scatter
kernel of `ops/scatter.py` reads too), returning (wi, pdf, valid). The f32
hardening (cross-product sin^2, log-space D and pdf, clamped exponents) is
kept as in the reference. Every clamp against a constant, and every |x|
that enters a value, differentiates as the reference's
`jnp.maximum` / `jnp.minimum` / `jnp.clip` / `jnp.abs` do (`utils.vmath`
`maximum`, `minimum`, `clip`, `absolute`: half the gradient at a tie, +1
at |0|); the values are torch.clamp's and torch.abs's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import random as rnd
from .sampling import disk_point
from .utils.vmath import (absolute, clip, cross, dot, from_local, maximum, minimum, normalize, numpy_real, safe_sqrt,
                          signed_full)

__all__ = [
    "Material", "MaterialTable", "MatParams", "SampleDraws", "bsdf", "sample_draws", "sample_f", "sample_f_drawn",
]

_PI = float(np.pi)
_TINY = 1e-9


@dataclasses.dataclass(frozen=True)
class Material:
    """Host-side material spec; packed into a `MaterialTable` at compile time."""

    color: tuple = (1.0, 0.0, 0.0)
    index: float = 1.5
    roughness: float = 0.5
    metallic: float = 0.0
    emittance: float = 0.0
    transparent: bool = False

    @staticmethod
    def _color(c) -> tuple:
        arr = np.asarray(c, dtype=np.float64).reshape(3)
        return tuple(float(v) for v in arr)

    @classmethod
    def default(cls) -> "Material":
        from .color import hex_color

        return cls.specular(hex_color(0xFF0000), 0.5)

    @classmethod
    def diffuse(cls, color) -> "Material":
        return cls(cls._color(color), 1.5, 1.0, 0.0, 0.0, False)

    @classmethod
    def specular(cls, color, roughness: float) -> "Material":
        return cls(cls._color(color), 1.5, float(roughness), 0.0, 0.0, False)

    @classmethod
    def clear(cls, index: float, roughness: float) -> "Material":
        return cls((1.0, 1.0, 1.0), float(index), float(roughness), 0.0, 0.0, True)

    @classmethod
    def transparent_colored(cls, color, index: float, roughness: float) -> "Material":
        return cls(cls._color(color), float(index), float(roughness), 0.0, 0.0, True)

    @classmethod
    def metallic_mat(cls, color, roughness: float) -> "Material":
        return cls(cls._color(color), 1.5, float(roughness), 1.0, 0.0, False)

    @classmethod
    def light(cls, color, emittance: float) -> "Material":
        return cls(cls._color(color), 1.0, 1.0, 0.0, float(emittance), False)


@dataclasses.dataclass(frozen=True)
class MatParams:
    """Per-hit material parameters (leading axes broadcast)."""

    color: torch.Tensor  # (..., 3)
    index: torch.Tensor  # (...,)
    roughness: torch.Tensor
    metallic: torch.Tensor
    emittance: torch.Tensor
    transparent: torch.Tensor  # float flag in {0, 1}


# Rows per block of a gathered column's backward (`_RowGather`).
_ONE_HOT_ROWS = 64


class _RowGather(torch.autograd.Function):
    """table[ids], whose backward sums each row's gradient over the hits
    that read it as the reference's one-hot matmul does: onehot(ids)^T @ g,
    in blocks of _ONE_HOT_ROWS rows, with no atomics. torch's own index
    backward sorts the ids and adds a row's hits one by one, which took
    0.73 s of a 0.77 s `dragon` step on an H100 (4 materials, 518,400
    hits a gather; `chip_smoke.py` `[grad]`)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat = g.reshape(g.shape[0], -1)
        blocks = []
        for lo in range(0, ctx.rows, _ONE_HOT_ROWS):
            rows = torch.arange(lo, min(lo + _ONE_HOT_ROWS, ctx.rows), device=ids.device)
            blocks.append((rows[:, None] == ids[None, :]).to(g.dtype) @ flat)
        return torch.cat(blocks).reshape((ctx.rows,) + tuple(g.shape[1:])), None


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """Struct-of-arrays material storage, gathered by material id per hit."""

    color: torch.Tensor  # (M, 3)
    index: torch.Tensor  # (M,)
    roughness: torch.Tensor
    metallic: torch.Tensor
    emittance: torch.Tensor
    transparent: torch.Tensor

    @staticmethod
    def pack(materials, dtype=torch.float32, device=None) -> "MaterialTable":
        """The materials' columns in the render's real type `dtype`."""
        mats = list(materials) or [Material.default()]
        np_dtype = numpy_real(dtype)

        def col(vals):
            return torch.as_tensor(np.asarray(vals, np_dtype), device=device)

        return MaterialTable(
            color=col([m.color for m in mats]),
            index=col([m.index for m in mats]),
            roughness=col([m.roughness for m in mats]),
            metallic=col([m.metallic for m in mats]),
            emittance=col([m.emittance for m in mats]),
            transparent=col([1.0 if m.transparent else 0.0 for m in mats]),
        )

    def gather(self, ids: torch.Tensor) -> MatParams:
        """Row gather by material id. The reference's one-hot matmul gives
        the same exact values, and the same gradient: a column that
        requires grad gets each row's hits summed into it (`_RowGather`).
        Ids are clipped so a bad id degrades to a valid row."""
        ids = torch.clamp(ids.long(), 0, self.color.shape[0] - 1)
        return MatParams(
            color=_RowGather.apply(self.color, ids),
            index=_RowGather.apply(self.index, ids),
            roughness=_RowGather.apply(self.roughness, ids),
            metallic=_RowGather.apply(self.metallic, ids),
            emittance=_RowGather.apply(self.emittance, ids),
            transparent=_RowGather.apply(self.transparent, ids),
        )


def _safe(x, eps=_TINY):
    """Clamp a denominator away from zero, keeping its sign."""
    return torch.where(torch.abs(x) < eps, signed_full(x < 0, eps, x), x)


def _sin2_nh(n, h):
    """sin^2 of the angle between unit n and h via |n x h|^2, which stays
    well-conditioned near theta = 0 in f32."""
    c = cross(n, h)
    return clip(dot(c, c), 0.0, 1.0)


def _beckmann_exponent(n, h, m2):
    sin2 = _sin2_nh(n, h)
    cos2 = maximum(1.0 - sin2, 1e-12)
    return maximum(-sin2 / (cos2 * m2), -80.0), cos2


def _beckmann_d(n, h, m2):
    """Beckmann D, evaluated in log space so f32 never underflows."""
    expo, cos2 = _beckmann_exponent(n, h, m2)
    log_denom = torch.log(m2 * _PI) + 2.0 * torch.log(cos2)
    return torch.exp(minimum(expo - log_denom, 80.0))


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def bsdf(mat: MatParams, n: torch.Tensor, wo: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """Batched BSDF value (..., 3) for unit normal, outgoing and incident directions."""
    n_wi = dot(n, wi)
    n_wo = dot(n, wo)
    wi_out = n_wi >= 0.0
    wo_out = n_wo >= 0.0
    transparent = mat.transparent > 0.5
    m2 = maximum(mat.roughness * mat.roughness, 1e-12)

    f0s = ((mat.index - 1.0) / (mat.index + 1.0)) ** 2
    f0 = f0s[..., None] * (1.0 - mat.metallic[..., None]) + mat.color * mat.metallic[..., None]

    # Same-side branch: Cook-Torrance + Lambert.
    h = normalize(wi + wo)
    wo_h = dot(wo, h)
    n_h = dot(n, h)
    d = _beckmann_d(n, h, m2)

    sin_t = safe_sqrt(1.0 - wo_h * wo_h)
    tir = (~wi_out) & (sin_t * mat.index > 1.0)
    fres = f0 + (1.0 - f0) * _pow5(1.0 - wo_h)[..., None]
    fres = torch.where(tir[..., None], torch.ones_like(fres), fres)

    g = torch.minimum(n_wi * n_h, n_wo * n_h)
    g = minimum(2.0 * g / _safe(wo_h), 1.0)

    spec = (d * g / _safe(4.0 * n_wo * n_wi))[..., None] * fres
    diff = (1.0 - fres) * mat.color / _PI
    refl = torch.where(transparent[..., None], spec, spec + diff)

    # Opposite-side branch: Walter-style BTDF.
    eta_t = torch.where(wo_out, mat.index, 1.0 / mat.index)
    h2 = normalize(wi * eta_t[..., None] + wo)
    wi_h2 = dot(wi, h2)
    wo_h2 = dot(wo, h2)
    n_h2 = dot(n, h2)
    d2 = _beckmann_d(n, h2, m2)
    fres2 = f0 + (1.0 - f0) * _pow5(1.0 - absolute(wi_h2))[..., None]
    g2 = torch.minimum(absolute(n_wi * n_h2), absolute(n_wo * n_h2))
    g2 = minimum(2.0 * g2 / _safe(absolute(wo_h2)), 1.0)
    scale = absolute(wi_h2 * wo_h2 / _safe(n_wi * n_wo))
    denom = _safe((eta_t * wi_h2 + wo_h2) ** 2)
    refr = (scale * d2 * g2 / denom)[..., None] * (1.0 - fres2) * mat.color

    same_side = wi_out == wo_out
    out = torch.where(same_side[..., None], refl, refr)
    blocked = (~transparent) & ((~wi_out) | (~wo_out))
    return torch.where(blocked[..., None], torch.zeros_like(out), out)


def _beckmann_pdf(n, h, m2):
    """Half-vector pdf exp(-tan^2/m2) / (pi m2 cos^3), in log space."""
    expo, cos2 = _beckmann_exponent(n, h, m2)
    log_denom = torch.log(_PI * m2) + 1.5 * torch.log(cos2)
    return torch.exp(minimum(expo - log_denom, 80.0))


class SampleDraws(NamedTuple):
    """`sample_f`'s five uniform draws, (...,) each."""

    u: torch.Tensor  # the Beckmann half-vector's tan^2 = -m2 log u, u in [1e-7, 1)
    phi: torch.Tensor  # its azimuth in [0, 2 pi)
    disk_r: torch.Tensor  # the cosine lobe's disk point: radius^2 in [0, 1)
    disk_a: torch.Tensor  # and angle in [0, 2 pi)
    lobe: torch.Tensor  # the lobe choice in [0, 1)


def sample_draws(key, shape, device, dtype) -> SampleDraws:
    """The draws of `sample_f` under `key`, of the real type `dtype`: the key
    split in four (lobe, theta, phi, disk), the disk's key split in two as
    `sampling.uniform_disk` splits it."""
    k_lobe, k_theta, k_phi, k_disk = rnd.split(key, 4)
    k_r, k_a = rnd.split(k_disk)
    return SampleDraws(
        u=rnd.uniform(k_theta, shape, dtype=dtype, minval=1e-7, maxval=1.0, device=device),
        phi=rnd.uniform(k_phi, shape, dtype=dtype, minval=0.0, maxval=2.0 * _PI, device=device),
        disk_r=rnd.uniform(k_r, shape, dtype=dtype, device=device),
        disk_a=rnd.uniform(k_a, shape, dtype=dtype, minval=0.0, maxval=2.0 * _PI, device=device),
        lobe=rnd.uniform(k_lobe, shape, dtype=dtype, device=device),
    )


def sample_f(key, mat: MatParams, n: torch.Tensor, wo: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample an incident direction: (wi (...,3), mixture pdf (...,), valid
    (...,) bool). Invalid samples (total internal reflection on the
    transmission lobe) must contribute nothing. The draws are of the type of
    `n` (float64 in a float64 render, as the reference's default-typed draws
    under `jax_enable_x64`)."""
    return sample_f_drawn(sample_draws(key, tuple(n.shape[:-1]), n.device, n.dtype), mat, n, wo)


def sample_f_drawn(draws: SampleDraws, mat: MatParams, n: torch.Tensor,
                   wo: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`sample_f` from its draws (`sample_draws`)."""
    m2 = maximum(mat.roughness * mat.roughness, 1e-12)

    f0s = ((mat.index - 1.0) / (mat.index + 1.0)) ** 2
    f_est = (1.0 - mat.metallic) * f0s + mat.metallic * torch.mean(mat.color, dim=-1)
    f_est = f_est * 0.8 + 0.2

    n_wo = dot(wo, n)
    eta_t = torch.where(n_wo > 0.0, mat.index, 1.0 / mat.index)

    theta = torch.atan(torch.sqrt(-m2 * torch.log(draws.u)))
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    phi = draws.phi
    h_local = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t], dim=-1)
    h = from_local(n, h_local)

    h_wo = dot(h, wo)
    wi_spec = 2.0 * h_wo[..., None] * h - wo

    xy = disk_point(draws.disk_r, draws.disk_a)
    z = safe_sqrt(1.0 - torch.sum(xy * xy, dim=-1))
    wi_diff = from_local(n, torch.cat([xy, z[..., None]], dim=-1))

    wo_perp = wo - h * h_wo[..., None]
    wi_perp = -wo_perp / eta_t[..., None]
    sin2_ti = dot(wi_perp, wi_perp)
    tir = sin2_ti > 1.0
    cos_ti = safe_sqrt(1.0 - sin2_ti)
    wi_trans = -torch.sign(h_wo)[..., None] * cos_ti[..., None] * h + wi_perp

    transparent = mat.transparent > 0.5
    pick_spec = draws.lobe < f_est
    wi_other = torch.where(transparent[..., None], wi_trans, wi_diff)
    wi = torch.where(pick_spec[..., None], wi_spec, wi_other)
    valid = ~((~pick_spec) & transparent & tir)

    n_wi = dot(wi, n)
    hs = normalize(wi + wo)
    p_spec = f_est * _beckmann_pdf(n, hs, m2) / _safe(4.0 * absolute(dot(hs, wo)))
    p_diff = (1.0 - f_est) * maximum(n_wi, 0.0) / _PI

    ht = normalize(wi * eta_t[..., None] + wo)
    ht_wo = dot(ht, wo)
    ht_wi = dot(ht, wi)
    jac = absolute(ht_wo) / _safe((eta_t * ht_wi + ht_wo) ** 2)
    p_trans = (1.0 - f_est) * _beckmann_pdf(n, ht, m2) * jac
    opposite = (n_wo >= 0.0) != (n_wi >= 0.0)
    p_trans = torch.where(opposite, p_trans, torch.zeros_like(p_trans))

    pdf = p_spec + torch.where(transparent, p_trans, p_diff)
    return wi, pdf, valid
