"""Batched 3-vector math on tensors whose last axis has size 3.

Counterpart of `rpt_tpu/utils/vmath.py`: every function broadcasts over
leading axes, so one call covers a whole wavefront of rays or normals.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "dot",
    "length",
    "length2",
    "normalize",
    "cross",
    "reflect",
    "orthonormal_basis",
    "from_local",
    "safe_sqrt",
    "maximum",
    "minimum",
    "clip",
    "absolute",
    "signed_full",
    "numpy_real",
    "real_value",
]


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt clamped at 0; the square root is only evaluated on positive
    inputs, which keeps masked lanes' gradients finite."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))), torch.zeros_like(x))


class _Clip(torch.autograd.Function):
    """torch.clamp(x, lo, hi) forward; JAX's gradient backward: `jnp.clip`
    is `minimum(maximum(x, lo), hi)`, and JAX's max and min split a tie
    evenly, so x at a bound takes half the gradient (torch.clamp gives it
    all) and a NaN none."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, min=lo, max=hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        zero = torch.zeros_like(g)
        if lo is not None:
            g = torch.where(x > lo, g, torch.where(x == lo, 0.5 * g, zero))
        if hi is not None:
            g = torch.where(x < hi, g, torch.where(x == hi, 0.5 * g, zero))
        return g, None, None


class _Abs(torch.autograd.Function):
    """torch.abs forward; JAX's gradient backward: +1 at 0 (`jnp.abs`
    takes g where x >= 0, else -g), where torch.abs takes 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0.0, g, -g)


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """`jnp.clip(x, lo, hi)` against constant bounds: the values of
    torch.clamp, the gradient of the reference (half at a bound)."""
    return _Clip.apply(x, lo, hi)


def maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """`jnp.maximum(x, c)` for a constant c (see `clip`)."""
    return clip(x, lo=c)


def minimum(x: torch.Tensor, c: float) -> torch.Tensor:
    """`jnp.minimum(x, c)` for a constant c (see `clip`)."""
    return clip(x, hi=c)


def absolute(x: torch.Tensor) -> torch.Tensor:
    """`jnp.abs(x)`: the values of torch.abs, the reference's gradient at 0."""
    return _Abs.apply(x)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis, summed x + y + z in that order."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def length2(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length2(v))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """v / |v|, and 0 for (near-)zero vectors."""
    n2 = length2(v)
    ok = n2 > eps
    inv = torch.where(ok, torch.rsqrt(torch.where(ok, n2, torch.ones_like(n2))), torch.zeros_like(n2))
    return v * inv[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def reflect(incident: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """GLM-convention reflection I - 2 (N.I) N."""
    return incident - 2.0 * dot(n, incident)[..., None] * n


def orthonormal_basis(n: torch.Tensor):
    """Tangents (t1, t2) of unit normal `n`: normalize(n.y, -n.x, 0) when
    n.x is usable, else normalize(0, -n.z, n.y)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    use_x = torch.abs(nx) > 1e-12
    zero = torch.zeros_like(nx)
    t_a = torch.stack([ny, -nx, zero], dim=-1)
    t_b = torch.stack([zero, -nz, ny], dim=-1)
    t1 = normalize(torch.where(use_x[..., None], t_a, t_b))
    t2 = cross(n, t1)
    return t1, t2


def from_local(n: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """Map a vector in the (t1, t2, n) frame to world space."""
    t1, t2 = orthonormal_basis(n)
    return local[..., 0:1] * t1 + local[..., 1:2] * t2 + local[..., 2:3] * n


def signed_full(neg: torch.Tensor, value: float, like: torch.Tensor) -> torch.Tensor:
    """-value where `neg`, else value, in the dtype of `like` (the
    reference's `where(x < 0, -value, value)` of a weakly typed scalar; a
    float64 value stays exact where torch's scalar `where` gives float32)."""
    if like.dtype == torch.float32:
        return torch.where(neg, -value, value)
    return torch.where(neg, torch.full_like(like, -value), torch.full_like(like, value))


def numpy_real(dtype: torch.dtype):
    """The numpy type of the real type `dtype` (float32 or float64) of a
    render, a scene or a pack."""
    return np.float64 if dtype == torch.float64 else np.float32


def real_value(x: float, dtype: torch.dtype) -> float:
    """A scalar of a render (`t_min`, the exposure scale) as a computation
    in the real type `dtype` takes it: rounded to float32 for float32, as
    given for float64 (the reference's `jnp.asarray(x, dtype)`)."""
    return float(np.float32(x)) if dtype == torch.float32 else float(x)
