"""What the example modules share: the `--device` flag, the timing they
print and the PNG they save."""

from __future__ import annotations

import time

import numpy as np

from ..io.image import save_png


def add_device(parser) -> None:
    parser.add_argument("--device", default=None,
                        help="torch device to render on (default: the CUDA card; 'cpu' for the plain torch path)")


def render(renderer) -> np.ndarray:
    """`renderer.render()`, timed."""
    t0 = time.time()
    img = renderer.render()
    print(f"Rendered {renderer.width}x{renderer.height} @ {renderer.num_samples} spp in {time.time() - t0:.2f}s")
    return img


def progressive(renderer, interval: int):
    """`renderer.iterative_render(interval, ...)`, printing each interval's
    milliseconds and the buffer's variance; returns the buffer."""
    state = {"t": time.time()}

    def callback(iteration, buffer):
        ms = (time.time() - state["t"]) * 1000.0
        print(f"Finished iteration {iteration}, took {ms:.0f} ms, variance: {float(buffer.variance()):.6f}")
        state["t"] = time.time()

    return renderer.iterative_render(interval, callback)


def save(path, image: np.ndarray) -> np.ndarray:
    save_png(path, image)
    print(f"Saved {path}")
    return image
