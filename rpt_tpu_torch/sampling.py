"""Monte Carlo sampling primitives on threefry keys (`rpt_tpu/sampling.py`).

`dtype` is the render's real type: the reference draws these at JAX's
default float type, float32, or float64 under `jax_enable_x64`."""

from __future__ import annotations

import math

import torch

from . import random as rnd
from .utils.vmath import safe_sqrt

__all__ = ["uniform_disk", "disk_point", "uniform_circle", "cosine_hemisphere", "uniform_triangle_barycentric"]


def uniform_disk(key, shape=(), device=None, dtype=torch.float32) -> torch.Tensor:
    """Uniform sample inside the unit disk, shape (..., 2): sqrt(r) * (cos t, sin t)."""
    k1, k2 = rnd.split(key)
    u = rnd.uniform(k1, shape, dtype=dtype, device=device)
    return disk_point(u, rnd.uniform(k2, shape, dtype=dtype, minval=0.0, maxval=2.0 * math.pi, device=device))


def disk_point(u: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """The point sqrt(u) * (cos theta, sin theta) of the unit disk, shape (..., 2)."""
    r = torch.sqrt(u)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def uniform_circle(key, shape=(), device=None, dtype=torch.float32) -> torch.Tensor:
    """Uniform sample on the unit circle, shape (..., 2): (cos t, sin t)."""
    theta = rnd.uniform(key, shape, dtype=dtype, minval=0.0, maxval=2.0 * math.pi, device=device)
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def cosine_hemisphere(key, shape=(), device=None, dtype=torch.float32) -> torch.Tensor:
    """Cosine-weighted hemisphere sample in local (t1, t2, n) coordinates by
    Malley's method (a disk sample lifted), shape (..., 3), z >= 0; its pdf
    is z / pi."""
    xy = uniform_disk(key, shape, device=device, dtype=dtype)
    z = safe_sqrt(1.0 - torch.sum(xy * xy, dim=-1))
    return torch.cat([xy, z[..., None]], dim=-1)


def uniform_triangle_barycentric(key, shape=(), device=None, dtype=torch.float32) -> torch.Tensor:
    """Uniform barycentric (u, v), u + v <= 1, by the mirror trick."""
    uv = rnd.uniform(key, rnd._shape(shape) + (2,), dtype=dtype, device=device)
    over = torch.sum(uv, dim=-1, keepdim=True) > 1.0
    return torch.where(over, 1.0 - uv, uv)
