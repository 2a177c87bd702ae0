"""Particle-system ODE integration (RK4) for physics-driven animation
(`rpt_tpu/ode/particle.py`).

`ParticleState` is a pair of (N, 3) float32 tensors; time derivatives are
vectorized over the particles (the O(N^2) pairwise forces are one
broadcast). The arithmetic is the reference's, in its order, with jnp's
forms where torch would round otherwise: integer powers as `integer_pow`
computes them (`_ipow`), the radial grid as `jnp.linspace` lowers it
(`_linspace`), `jnp.hypot`'s scaled form (`_hypot`); `argmin` takes the
first index in both packages.

The reference runs a trajectory as one XLA program (`lax.scan`). Its
counterpart on a CUDA device is a CUDA graph: `rk4_integrate` captures one
`rk4_step` over fixed state tensors (after an eager warm-up) and replays it
once per step, then runs the remainder step eagerly; the capture is cached
per (system type and parameters, N, step, device, dtype). On the CPU the
loop runs eagerly. A failed capture raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.cuda_graph import Capture, GraphCache
from ..utils.device import resolve_device

__all__ = [
    "ParticleState",
    "ParticleSystem",
    "SimpleCircleSystem",
    "SolidGravitySystem",
    "MarblesSystem",
    "monomial_closest_point",
]


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """Positions + velocities of N particles."""

    pos: torch.Tensor  # (N, 3)
    vel: torch.Tensor  # (N, 3)

    @staticmethod
    def create(pos, vel=None, device=None) -> "ParticleState":
        """A float32 state on `device` (the CUDA card when None; raises
        without one)."""
        device = resolve_device(device)

        def f32(a):
            a = a if isinstance(a, torch.Tensor) else np.array(a, np.float32)
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        pos = f32(pos)
        return ParticleState(pos, torch.zeros_like(pos) if vel is None else f32(vel))

    def __add__(self, other: "ParticleState") -> "ParticleState":
        return ParticleState(self.pos + other.pos, self.vel + other.vel)

    def __mul__(self, s) -> "ParticleState":
        return ParticleState(self.pos * s, self.vel * s)

    __rmul__ = __mul__

    def __truediv__(self, s) -> "ParticleState":
        return ParticleState(self.pos / s, self.vel / s)


_RK4_CACHE = GraphCache()  # (system type and parameters, N, step, device, dtype) -> _Rk4Graph


class _Rk4Graph:
    """One captured `rk4_step(state, step)` over fixed state tensors, which
    each replay advances in place."""

    def __init__(self, system: "ParticleSystem", n: int, step: float, device, dtype):
        self.pos = torch.zeros((n, 3), dtype=dtype, device=device)
        self.vel = torch.zeros((n, 3), dtype=dtype, device=device)

        def run():
            out = system.rk4_step(ParticleState(self.pos, self.vel), step)
            self.pos.copy_(out.pos)
            self.vel.copy_(out.vel)

        self.capture = Capture(run, device, "the RK4 step")

    def __call__(self, state: ParticleState, n_steps: int) -> ParticleState:
        self.pos.copy_(state.pos)
        self.vel.copy_(state.vel)
        for _ in range(n_steps):
            self.capture.graph.replay()
        # Fresh tensors: the next call refills the fixed ones.
        return ParticleState(self.pos.clone(), self.vel.clone())


class ParticleSystem:
    """A system of physical laws."""

    def time_derivative(self, state: ParticleState) -> ParticleState:
        raise NotImplementedError

    def rk4_step(self, state: ParticleState, step) -> ParticleState:
        k1 = self.time_derivative(state)
        k2 = self.time_derivative(state + k1 * (step / 2.0))
        k3 = self.time_derivative(state + k2 * (step / 2.0))
        k4 = self.time_derivative(state + k3 * step)
        return state + (k1 + k2 * 2.0 + k3 * 2.0 + k4) * (step / 6.0)

    def rk4_integrate(self, state: ParticleState, time: float, step: float) -> ParticleState:
        """Integrate for `time` with fixed `step` (+ one remainder step), the
        reference's step count; on a CUDA device the fixed steps replay one
        captured step (`_rk4_graph`)."""
        n_steps = int(np.floor(time / step - 1e-12))
        if state.pos.device.type != "cuda" or n_steps == 0:
            return self._rk4_eager(state, time, step)
        state = self._rk4_graph(state.pos.shape[0], step, state.pos.device, state.pos.dtype)(state, n_steps)
        return self.rk4_step(state, time - n_steps * step)

    def _rk4_eager(self, state: ParticleState, time: float, step: float) -> ParticleState:
        """`rk4_integrate` with every step run eagerly: the path on the CPU,
        and on a CUDA device the yardstick the graph is held against."""
        n_steps = int(np.floor(time / step - 1e-12))
        for _ in range(n_steps):
            state = self.rk4_step(state, step)
        return self.rk4_step(state, time - n_steps * step)

    def _rk4_graph(self, n: int, step: float, device, dtype=torch.float32) -> _Rk4Graph:
        """The captured step of this system for N particles, captured on
        first use."""
        key = (type(self), tuple(sorted(vars(self).items())), n, float(step), str(torch.device(device)), dtype)
        g = _RK4_CACHE.get(key)
        if g is None:
            g = _Rk4Graph(self, n, float(step), device, dtype)
            _RK4_CACHE.put(key, g)
        return g


class SimpleCircleSystem(ParticleSystem):
    """dp/dt = (-y, x, 0): circular motion, used by the rk4 unit test."""

    def time_derivative(self, state: ParticleState) -> ParticleState:
        x, y, z = state.pos[:, 0], state.pos[:, 1], state.pos[:, 2]
        dpos = torch.stack([-y, x, torch.zeros_like(z)], dim=-1)
        return ParticleState(dpos, torch.zeros_like(state.vel))


def _ipow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x ** y for an integer y as `lax.integer_pow` computes it: square and
    multiply, then one division for a negative power."""
    if y == 0:
        return torch.ones_like(x)
    recip, y = y < 0, abs(y)
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return 1.0 / acc if recip else acc


def _linspace(resolution: int, dtype, device) -> torch.Tensor:
    """`jnp.linspace(-1.0, 1.0, resolution)` as XLA lowers it: the division
    by resolution - 1 becomes a product with its float32 reciprocal,
    start * (1 - s) + stop * s, then the endpoint appended."""
    div = resolution - 1
    s = torch.arange(div, dtype=dtype, device=device) * (torch.ones((), dtype=dtype, device=device) / div)
    return torch.cat([-(1.0 - s) + s, torch.ones(1, dtype=dtype, device=device)])


def _hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`jnp.hypot`: max * sqrt(1 + (min / max)^2), 0 where both are 0."""
    a, b = a.abs(), b.abs()
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    r = lo / torch.where(hi == 0, torch.ones_like(hi), hi)
    return torch.where(hi == 0, hi, hi * torch.sqrt(1.0 + r * r))


def _pairwise(pos):
    """diff[i, j] = pos_i - pos_j, plus distances with a safe diagonal."""
    diff = pos[:, None, :] - pos[None, :, :]  # (N,N,3)
    dist = torch.linalg.norm(diff, dim=-1)
    n = pos.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    dist_safe = torch.where(eye | (dist < 1e-12), torch.ones_like(dist), dist)
    dirs = diff / dist_safe[..., None]
    return diff, dist, dist_safe, dirs, eye


class SolidGravitySystem(ParticleSystem):
    """Pairwise attraction len^-2 - 1e-4 len^-5."""

    def time_derivative(self, state: ParticleState) -> ParticleState:
        _, dist, dist_safe, dirs, eye = _pairwise(state.pos)
        mag = _ipow(dist_safe, -2) - 1e-4 * _ipow(dist_safe, -5)
        mag = torch.where(eye, torch.zeros_like(mag), mag)
        # For the pair (i, j): acc_i -= dir_ij * mag (attraction toward j)
        acc = -torch.sum(dirs * mag[..., None], dim=1)
        return ParticleState(state.vel, acc)


def monomial_closest_point(point, height: float, resolution: int = 201) -> torch.Tensor:
    """Closest point on y = height*(x^2+z^2)^2 via a radial grid search of
    `resolution` points. `point`: (..., 3). Fully vectorized."""
    point = torch.as_tensor(point)
    px = _hypot(point[..., 0], point[..., 2])
    py = point[..., 1]
    xs = _linspace(resolution, torch.float32, point.device)  # (R,)
    ys = height * _ipow(xs, 4)
    d2 = _ipow(px[..., None] - xs, 2) + _ipow(py[..., None] - ys, 2)  # (..., R)
    best = torch.argmin(d2, dim=-1)
    xf = xs[best]
    xz_norm = _hypot(point[..., 0], point[..., 2])
    xz_safe = torch.where(xz_norm > 1e-12, xz_norm, torch.ones_like(xz_norm))
    cx = xf * (point[..., 0] / xz_safe)
    cz = xf * (point[..., 2] / xz_safe)
    cy = height * _ipow(_ipow(cx, 2) + _ipow(cz, 2), 2)
    closest = torch.stack([cx, cy, cz], dim=-1)
    # Degenerate near-zero input: return the point itself.
    tiny = (torch.linalg.norm(point, dim=-1) < 1e-12)[..., None]
    return torch.where(tiny, point, closest.to(point.dtype))


class MarblesSystem(ParticleSystem):
    """Marbles in a monomial glass on a table."""

    def __init__(self, radius: float):
        self.radius = float(radius)

    def time_derivative(self, state: ParticleState) -> ParticleState:
        r = self.radius
        pos, vel = state.pos, state.vel
        # Constants made on the device: a copy from the host cannot be
        # captured in a CUDA graph.
        zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
        acc = torch.zeros_like(pos)
        acc[:, 1] = -1.0

        # Sphere-sphere contact springs + per-contact damping
        _, dist, dist_safe, dirs, eye = _pairwise(pos)
        contact = (~eye) & (dist < 2.0 * r)
        spring = 5.0 * ((2.0 * r - dist) / r)
        # For pair (i, j): acc_i += dir_ij * spring (repulsion), and each
        # contact also damps that particle's velocity by 0.5 * vel
        pair_force = torch.where(contact[..., None], dirs * spring[..., None], zero)
        acc = acc + torch.sum(pair_force, dim=1)
        contact_count = torch.sum(contact, dim=1).to(pos.dtype)
        acc = acc - vel * 0.5 * contact_count[:, None]

        # Glass surface contact (the height-2 monomial)
        closest = monomial_closest_point(pos, 2.0)
        vec = pos - closest
        vlen = torch.linalg.norm(vec, dim=-1)
        normal = vec / torch.clamp(vlen, min=1e-12)[:, None]
        ratio = (r - vlen) / r
        nvel = torch.sum(vel * normal, dim=-1)
        surf_acc = torch.where(
            ((-0.1 < ratio) & (ratio < 0.0))[:, None],
            -30.0 * normal * _ipow(nvel, 3)[:, None],
            zero,
        ) + torch.where((ratio >= 0.0)[:, None], 100.0 * normal * ratio[:, None], zero)
        acc = acc + surf_acc

        # Table contact, only for marbles not on the glass (|pos| > 0.1)
        t_normal = (torch.arange(3, device=pos.device) == 1).to(pos.dtype)
        t_ratio = ((r - 0.06) - pos[:, 1]) / r
        t_nvel = vel[:, 1]
        off_glass = torch.linalg.norm(pos, dim=-1) > 0.1
        t_acc = torch.where(
            (off_glass & (-0.1 < t_ratio) & (t_ratio < 0.0))[:, None],
            -20.0 * t_normal[None, :] * t_nvel[:, None],
            zero,
        ) + torch.where(
            (off_glass & (t_ratio >= 0.0))[:, None],
            300000.0 * t_normal[None, :] * t_ratio[:, None],
            zero,
        )
        acc = acc + t_acc

        # Air resistance
        acc = acc - vel / 5.0
        return ParticleState(vel, acc)

