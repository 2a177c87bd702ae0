"""Environment lighting: a solid color or an HDRI equirectangular map
(`rpt_tpu/environment.py`).

The HDRI lookup is a bilinear blend over (azimuth, polar) for a whole
wavefront of directions at once, with the azimuthal wrap (`(x0 + 1) % w`)
and the polar clamp (`min(y0 + 1, h - 1)`) of the reference. Two forms, as
there: a map of at most `_QUAD_MAX_TEXELS` texels carries a quad table baked
on the host, one row per texel holding its four bilinear neighbours, so a
lookup is one row gather; a larger map is read with four gathers of the map
itself. Both give the same values.

The port's quad row is the reference's 12 floats and one zero: torch
gathers rows whose size is a multiple of 16 bytes with a slower kernel, so
a row of 13 floats (52 bytes) is read faster than one of 12 (48 bytes), and
the values read are the same.

`Environment` holds host numpy arrays. A compiled scene carries them as
device tensors (`SceneData.env_color`, `env_hdri`, `env_quad`), and the
integrator reads them through `lookup`, which copies nothing from the host
and so runs inside a CUDA graph. Texels stay float32 in a float64 render,
as in the reference; the lookup's arithmetic runs in the directions' type.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .utils.vmath import clip, normalize

__all__ = ["Environment", "lookup", "pad_quad"]


# Quad tables above this texel count are not built (the table is 4x the
# image): such maps take the 4-gather form.
_QUAD_MAX_TEXELS = 2_097_152
# A quad row: [c00 c01 c10 c11] (12 floats) and one zero column.
QUAD_WIDTH = 13


def pad_quad(quad: np.ndarray) -> np.ndarray:
    """The reference's (H*W, 12) quad table as the port's (H*W, 13) one."""
    quad = np.asarray(quad, np.float32)
    return np.concatenate([quad, np.zeros((quad.shape[0], QUAD_WIDTH - 12), np.float32)], axis=-1)


@dataclasses.dataclass(frozen=True)
class Environment:
    color: np.ndarray  # (3,) float32 solid background color, host side
    hdri: Optional[np.ndarray] = None  # (H, W, 3) float32 linear RGB, or None
    # Row y*W+x: [c00 c01 c10 c11 0] with the wrap and the clamp baked in;
    # None for a map above _QUAD_MAX_TEXELS (the 4-gather form).
    hdri_quad: Optional[np.ndarray] = None  # (H*W, 13) float32, or None

    @staticmethod
    def from_color(color) -> "Environment":
        return Environment(color=np.asarray(color, np.float32).reshape(3))

    @staticmethod
    def from_hdri(image) -> "Environment":
        img = np.asarray(image, np.float32)
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"an HDRI is (H, W, 3), not {img.shape}")
        quad = None
        h, w = img.shape[:2]
        if h * w <= _QUAD_MAX_TEXELS:
            right = np.roll(img, -1, axis=1)  # x+1 wraps azimuthally
            down = img[np.minimum(np.arange(h) + 1, h - 1)]  # y+1 clamps
            down_right = np.roll(down, -1, axis=1)
            quad = pad_quad(np.concatenate([img, right, down, down_right], axis=-1).reshape(h * w, 12))
        return Environment(color=np.zeros(3, np.float32), hdri=img, hdri_quad=quad)

    @staticmethod
    def black() -> "Environment":
        return Environment.from_color((0.0, 0.0, 0.0))

    def tensors(self, device, dtype=torch.float32) -> tuple:
        """(color in `dtype`, map, quad table) on `device`, the last two
        float32 or None: what a compiled scene carries."""
        def f32(a):
            return None if a is None else torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

        return torch.tensor(self.color, dtype=dtype, device=device), f32(self.hdri), f32(self.hdri_quad)

    def get_color(self, dirs: torch.Tensor) -> torch.Tensor:
        """Environment radiance for a batch of directions (N, 3). Copies the
        arrays to the directions' device on every call; a render reads the
        compiled scene's copies instead (`SceneData.environment_color`)."""
        return lookup(dirs, *self.tensors(dirs.device, dirs.dtype))


def lookup(dirs: torch.Tensor, color: torch.Tensor, hdri: Optional[torch.Tensor] = None,
           quad: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`Environment.get_color` over device tensors: `color` broadcast when
    there is no map, else the bilinear lookup of `hdri` (H, W, 3), through
    the quad table `quad` (H*W, k >= 12, row y*W+x) when given, else
    through four gathers of the map."""
    if hdri is None:
        return torch.broadcast_to(color, dirs.shape)
    h, w = hdri.shape[0], hdri.shape[1]
    d = normalize(dirs)
    azimuth = torch.atan2(d[..., 2], d[..., 0]) + math.pi
    polar = torch.acos(clip(d[..., 1], -1.0, 1.0))
    x = azimuth / (2.0 * math.pi) * (w - 1)
    y = polar / math.pi * (h - 1)
    x0 = torch.clamp(x.to(torch.int32), 0, w - 1)
    y0 = torch.clamp(y.to(torch.int32), 0, h - 1)
    ax = (x - x0)[..., None]
    ay = (y - y0)[..., None]
    if quad is not None:
        q = quad[(y0 * w + x0).long()]
        c00, c01 = q[..., 0:3], q[..., 3:6]
        c10, c11 = q[..., 6:9], q[..., 9:12]
    else:
        flat = hdri.reshape(h * w, 3)
        x1 = torch.remainder(x0 + 1, w)
        y1 = torch.clamp(y0 + 1, max=h - 1)
        c00 = flat[(y0 * w + x0).long()]
        c01 = flat[(y0 * w + x1).long()]
        c10 = flat[(y1 * w + x0).long()]
        c11 = flat[(y1 * w + x1).long()]
    top = c00 * (1 - ax) + c01 * ax
    bot = c10 * (1 - ax) + c11 * ax
    return top * (1 - ay) + bot * ay
