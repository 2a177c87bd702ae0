"""Linear RGB colors with sRGB gamma-2.2 conversion (`rpt_tpu/color.py`)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import profiling

SRGB_GAMMA = 2.2

__all__ = ["SRGB_GAMMA", "hex_color", "color_bytes"]

# Tensor types mapped on their own device; float16 and bfloat16 widen
# exactly to float32 first.
_TABLE_TYPES = {torch.float32: np.float32, torch.float64: np.float64}
_WIDENED = (torch.float16, torch.bfloat16)


def hex_color(x: int) -> np.ndarray:
    """sRGB hex integer -> linear-intensity float32 color, gamma 2.2.

    Returned as a host array: colors are scene-building inputs."""
    r = ((x >> 16) & 0xFF) / 255.0
    g = ((x >> 8) & 0xFF) / 255.0
    b = (x & 0xFF) / 255.0
    return np.asarray([r**SRGB_GAMMA, g**SRGB_GAMMA, b**SRGB_GAMMA], dtype=np.float32)


def _numpy_bytes(color) -> np.ndarray:
    """The reference's map on the host: float64 clip to [0, 1], gamma
    1/2.2, rounded to nearest."""
    c = np.asarray(color, dtype=np.float64)
    c = np.clip(c, 0.0, 1.0) ** (1.0 / SRGB_GAMMA)
    return np.rint(c * 255.0).astype(np.uint8)


@functools.cache
def byte_thresholds(dtype) -> tuple:
    """(t, nan_byte): t[k - 1] is the smallest non-negative value of the
    floating `dtype` (np.float32 or np.float64) whose byte under the numpy
    map is at least k, k = 1..255; nan_byte is the numpy map's byte for NaN
    on this host. The map is monotone, so byte(x) = #{k : t[k - 1] <= x}
    for every x but NaN. Found by bisection over the non-negative bit
    patterns (ordered as the values are), with the numpy map itself."""
    ftype = np.dtype(dtype)
    utype = np.dtype(f"u{ftype.itemsize}")
    k = np.arange(1, 256)
    lo = np.zeros(255, utype)  # byte(lo) < k: the byte of 0 is 0
    hi = np.full(255, np.array(np.inf, ftype).view(utype))  # byte(hi) >= k: the byte of +inf is 255
    while np.any(hi - lo > 1):
        mid = lo + (hi - lo) // 2
        up = _numpy_bytes(mid.view(ftype)) >= k
        lo, hi = np.where(up, lo, mid), np.where(up, mid, hi)
    with np.errstate(invalid="ignore"):
        nan_byte = int(_numpy_bytes(np.array([np.nan], ftype))[0])
    return hi.view(ftype), nan_byte


@functools.cache
def _device_thresholds(dtype: torch.dtype, device: torch.device) -> tuple:
    """`byte_thresholds` of a torch type on `device`. The first call for a
    card copies from pageable memory, so it waits for the work queued there."""
    t, nan_byte = byte_thresholds(_TABLE_TYPES[dtype])
    return torch.as_tensor(t, device=device), nan_byte


def color_bytes(color) -> np.ndarray:
    """Clamp a linear color (..., 3) to sRGB u8 (gamma 1/2.2, rounded), on
    the host. A floating tensor is mapped on its own device through the
    exact thresholds of its type (`byte_thresholds`), and only the bytes are
    copied; any other input takes the numpy map. Both give the same bytes."""
    if isinstance(color, torch.Tensor) and (color.dtype in _TABLE_TYPES or color.dtype in _WIDENED):
        x = color.detach()
        with profiling.span("rpt.image.tonemap", on=x.device.type):
            if x.dtype in _WIDENED:
                x = x.float()
            t, nan_byte = _device_thresholds(x.dtype, x.device)
            b = torch.bucketize(x.contiguous(), t, right=True, out_int32=True)
            b = b.masked_fill_(torch.isnan(x), nan_byte).to(torch.uint8)
        # The copy waits for the work queued before it on the device.
        with profiling.span("rpt.image.to_host", bytes=b.nbytes):
            return b.cpu().numpy()
    if isinstance(color, torch.Tensor):
        with profiling.span("rpt.image.to_host", bytes=color.nbytes):
            color = color.detach().cpu().numpy()
    with profiling.span("rpt.image.tonemap", on="numpy"):
        return _numpy_bytes(color)
