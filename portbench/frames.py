"""The one traffic generator: a closed loop of one client that renders frame
after frame of one scene and camera through the port's public entry, on one
`Renderer`, with nothing between frames but the harness's bookkeeping.

A mix (`traffic/<name>.json`) sets:
- `entry`: "render" (`Renderer.render()`, one image per frame) or
  "iterative_render" (`Renderer.iterative_render(interval, callback)`, then
  the buffer's image, as the upstream scripts save it), the callback
  computing the buffer's variance on the host, as a script prints it;
- `interval`: the samples between callbacks, a number or "config" for the
  configuration's own `interval` (its script's);
- `spp`: samples per frame, a number or null for the configuration's.

Frame k is keyed by `frame_seed(seed, k)`, set on the renderer; the warm-up
frame is frame -1. After each frame the harness keeps its image (and, from
the progressive entry, its buffer's sums) at the pixels the check will read,
and nothing else."""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import List, Optional

import numpy as np

from portbench.devtrace import span

ENTRIES = ("render", "iterative_render")


def frame_seed(seed: int, k: int) -> int:
    """The int32 seed of frame k of a run seeded `seed` (any whole number)."""
    digest = hashlib.blake2b(f"{int(seed)}:{int(k)}".encode(), digest_size=4).digest()
    return int.from_bytes(digest, "little") & 0x7FFFFFFF


@dataclasses.dataclass
class Frame:
    k: int
    seed: int
    start: float  # perf_counter seconds
    end: float
    updates: List[float]  # seconds between successive callbacks (the first from the frame's start)
    image: np.ndarray  # (P, 3) uint8 at the checked pixels
    sums: Optional[np.ndarray] = None  # (P, 3) of the buffer's sum at those pixels
    sum_sq: Optional[np.ndarray] = None  # (P,)
    count: int = 0


class Driver:
    """Frames of one mix on one renderer; `pixels` are the row-major pixels
    kept of every frame."""

    def __init__(self, renderer, cfg: dict, mix: dict, pixels: np.ndarray):
        if mix["entry"] not in ENTRIES:
            raise ValueError(f"unknown entry {mix['entry']!r}; one of {ENTRIES}")
        self.renderer = renderer
        self.entry = mix["entry"]
        interval = mix.get("interval")
        self.interval = int(cfg["interval"] if interval == "config" else interval or renderer.num_samples)
        if mix.get("spp") is not None:
            renderer.set_num_samples(int(mix["spp"]))
        self.spp = renderer.num_samples
        self.keep(pixels)

    def keep(self, pixels: np.ndarray) -> None:
        """Keep the row-major `pixels` of every frame from now on."""
        import torch

        self.pixels = np.asarray(pixels, np.int64)
        self.rows, self.cols = self.pixels // self.renderer.width, self.pixels % self.renderer.width
        self.index = torch.as_tensor(self.pixels, device=self.renderer.device)

    def frame(self, k: int, seed: int) -> Frame:
        r = self.renderer
        r.seed = seed
        updates: List[float] = []
        start = time.perf_counter()
        if self.entry == "render":
            with span("render"):
                img = r.render()
            return Frame(k, seed, start, time.perf_counter(), updates, img[self.rows, self.cols], count=self.spp)
        last = [start]

        def callback(iteration, buffer):
            with span("callback"):
                float(buffer.variance())
            now = time.perf_counter()
            updates.append(now - last[0])
            last[0] = now

        with span("iterative_render"):
            buf = r.iterative_render(self.interval, callback)
        with span("image"):
            img = buf.image()
        end = time.perf_counter()
        with span("keep"):
            sums = buf.sum.reshape(-1, 3)[self.index].cpu().numpy()
            sum_sq = buf.sum_sq.reshape(-1)[self.index].cpu().numpy()
        return Frame(k, seed, start, end, updates, img[self.rows, self.cols], sums, sum_sq, buf.count)
