"""Linear RGB colors with sRGB gamma-2.2 conversion (`rpt_tpu/color.py`)."""

from __future__ import annotations

import numpy as np
import torch

from . import profiling

SRGB_GAMMA = 2.2

__all__ = ["SRGB_GAMMA", "hex_color", "color_bytes"]


def hex_color(x: int) -> np.ndarray:
    """sRGB hex integer -> linear-intensity float32 color, gamma 2.2.

    Returned as a host array: colors are scene-building inputs."""
    r = ((x >> 16) & 0xFF) / 255.0
    g = ((x >> 8) & 0xFF) / 255.0
    b = (x & 0xFF) / 255.0
    return np.asarray([r**SRGB_GAMMA, g**SRGB_GAMMA, b**SRGB_GAMMA], dtype=np.float32)


def color_bytes(color) -> np.ndarray:
    """Clamp a linear color (..., 3) to sRGB u8 (gamma 1/2.2, rounded)."""
    if isinstance(color, torch.Tensor):
        # The copy waits for the work queued before it on the device.
        with profiling.span("rpt.image.to_host", bytes=color.nbytes):
            color = color.detach().cpu().numpy()
    with profiling.span("rpt.image.tonemap"):
        c = np.asarray(color, dtype=np.float64)
        c = np.clip(c, 0.0, 1.0) ** (1.0 / SRGB_GAMMA)
        return np.rint(c * 255.0).astype(np.uint8)
