"""Sample accumulation buffer with streaming variance and box filtering
(`rpt_tpu/buffer.py`): per-pixel sum, sum of squared magnitudes and a
sample count, which reproduce the reference's variance exactly."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import profiling
from .color import color_bytes
from .utils.device import resolve_device

__all__ = ["Filter", "Buffer"]


@dataclasses.dataclass(frozen=True)
class Filter:
    """Box noise-reduction filter with a given radius (0 = no-op)."""

    radius: int = 0

    @staticmethod
    def box(radius: int) -> "Filter":
        return Filter(radius=radius)


@dataclasses.dataclass(frozen=True)
class Buffer:
    sum: torch.Tensor  # (H, W, 3)
    sum_sq: torch.Tensor  # (H, W)
    count: int

    @staticmethod
    def new(width: int, height: int, dtype=torch.float32, device=None) -> "Buffer":
        """An empty buffer of sums in `dtype` (the render's real type; the
        third argument, as in the reference) on `device` (the CUDA card when
        None; raises without one)."""
        device = resolve_device(device)
        return Buffer(
            sum=torch.zeros((height, width, 3), dtype=dtype, device=device),
            sum_sq=torch.zeros((height, width), dtype=dtype, device=device),
            count=0,
        )

    def add_samples(self, samples: torch.Tensor) -> "Buffer":
        """Add one uniform frame of samples, (H, W, 3)."""
        return Buffer(
            sum=self.sum + samples,
            sum_sq=self.sum_sq + torch.sum(samples * samples, dim=-1),
            count=self.count + 1,
        )

    def merge(self, other: "Buffer") -> "Buffer":
        return Buffer(self.sum + other.sum, self.sum_sq + other.sum_sq, self.count + other.count)

    def variance(self) -> torch.Tensor:
        """Mean per-pixel sample variance with n-1 degrees of freedom."""
        n = float(max(self.count, 2))
        mean_sq = torch.sum(self.sum * self.sum, dim=-1) / n
        return torch.mean((self.sum_sq - mean_sq) / (n - 1.0))

    def mean_image(self, filter: Filter = Filter()) -> torch.Tensor:
        """Filtered linear-radiance image (H, W, 3): the box filter averages
        all samples in the (2r+1)^2 neighborhood, edges excluded."""
        n = float(max(self.count, 1))
        if filter.radius == 0:
            return self.sum / n
        r = filter.radius
        x = self.sum.permute(2, 0, 1)[None]
        avg = torch.nn.functional.avg_pool2d(x, 2 * r + 1, stride=1, padding=r, count_include_pad=False)
        return avg[0].permute(1, 2, 0) / n

    def image(self, filter: Filter = Filter()) -> np.ndarray:
        """Tone-mapped uint8 image (H, W, 3) on the host."""
        with profiling.span("rpt.image"):
            return color_bytes(self.mean_image(filter))

    # The accumulator and the sampling cursor round-trip exactly, in the
    # sums' own type (float32 or float64), so a resumed render equals an
    # uninterrupted one bit for bit (sample i is keyed by fold_in(seed, i)
    # whatever the chunking). The .npz keys are the JAX package's
    # (`rpt_tpu/buffer.py` save / load): a checkpoint of either package
    # loads in the other.

    def save(self, path, *, seed: int, iteration: int) -> None:
        """Write the accumulator and the sampling cursor to an .npz checkpoint."""
        np.savez_compressed(
            path,
            sum=self.sum.detach().cpu().numpy(),
            sum_sq=self.sum_sq.detach().cpu().numpy(),
            count=np.int32(self.count),
            seed=np.int64(seed),
            iteration=np.int64(iteration),
        )

    @staticmethod
    def load(path, device=None):
        """Read a checkpoint onto `device` (the CUDA card when None; raises
        without one), its sums in the type they were saved in; returns
        (Buffer, seed, iteration)."""
        device = resolve_device(device)
        with np.load(path) as z:
            buf = Buffer(
                sum=torch.as_tensor(z["sum"], device=device),
                sum_sq=torch.as_tensor(z["sum_sq"], device=device),
                count=int(z["count"]),
            )
            return buf, int(z["seed"]), int(z["iteration"])
