"""Thin-lens perspective camera with batched ray generation (`rpt_tpu/camera.py`)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .sampling import uniform_disk
from .utils.vmath import cross, dot, normalize

__all__ = ["Camera"]

_FIELDS = ("eye", "direction", "up", "fov", "aperture", "focal_distance")


def _f32(v, device=None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(dtype=torch.float32, device=device if device is not None else v.device)
    return torch.tensor(np.asarray(v, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """A thin-lens perspective camera; every field is a float32 tensor.

    Defaults: eye at (0,0,10) looking -z, y-up, fov pi/6, no aperture.
    """

    eye: torch.Tensor = (0.0, 0.0, 10.0)
    direction: torch.Tensor = (0.0, 0.0, -1.0)
    up: torch.Tensor = (0.0, 1.0, 0.0)
    fov: torch.Tensor = math.pi / 6
    aperture: torch.Tensor = 0.0
    focal_distance: torch.Tensor = 0.0

    def __post_init__(self):
        for f in _FIELDS:
            object.__setattr__(self, f, _f32(getattr(self, f)))

    def to(self, device) -> "Camera":
        return Camera(**{f: getattr(self, f).to(device) for f in _FIELDS})

    @staticmethod
    def look_at(eye, center, up, fov) -> "Camera":
        """Perspective camera looking at a point."""
        eye, center, up = _f32(eye), _f32(center), _f32(up)
        direction = normalize(center - eye)
        up = normalize(up - dot(up, direction) * direction)
        return Camera(eye=eye, direction=direction, up=up, fov=np.float32(fov))

    def focus(self, focal_point, aperture) -> "Camera":
        """Focus on a world position with a given aperture."""
        focal_point = _f32(focal_point, self.eye.device)
        fd = dot(focal_point - self.eye, self.direction)
        return dataclasses.replace(self, focal_distance=fd, aperture=np.float32(aperture))

    def cast_rays(self, x: torch.Tensor, y: torch.Tensor, key):
        """Rays for normalized screen coords in [-1, 1], x and y of shape (N,).

        Depth d = cot(fov/2); direction d*dir + x*right + y*up; with an
        aperture, the origin is jittered on the lens disk and aimed at the
        focal point. Returns (origins (N,3), unit directions (N,3)).

        The fields stay float32, as in the reference; float64 coordinates
        give float64 rays (the lens disk is drawn in their type), and each
        mixed product is of a float32 field with a float64 tensor with
        dimensions, which torch computes in float64 as JAX does.
        """
        d = 1.0 / torch.tan(self.fov / 2.0)
        right = normalize(cross(self.direction, self.up))
        base_dir = d * self.direction + x[..., None] * right + y[..., None] * self.up
        origin = torch.broadcast_to(self.eye, base_dir.shape)

        lens_xy = uniform_disk(key, tuple(x.shape), device=x.device, dtype=x.dtype)
        focal_point = origin + normalize(base_dir) * self.focal_distance
        offset = (lens_xy[..., 0:1] * right + lens_xy[..., 1:2] * self.up) * self.aperture
        dof_origin = origin + offset
        dof_dir = focal_point - dof_origin

        use_dof = self.aperture > 0.0
        origin = torch.where(use_dof, dof_origin, origin)
        direction = torch.where(use_dof, dof_dir, base_dir)
        return origin, normalize(direction)
