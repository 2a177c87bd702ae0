"""CUDA graph capture and a bounded cache of captured functions, shared by
the renderer's sample passes and the ODE's RK4 step."""

from __future__ import annotations

import time
from typing import Callable

import torch

from .. import profiling

__all__ = ["Capture", "GraphCache"]


class Capture:
    """One captured call of `run` (named `what` in errors): the graph, the
    capture's seconds (warm-up included) and the device memory it reserved
    for the graph's pool. A failed capture raises."""

    def __init__(self, run: Callable[[], None], device, what: str):
        # `device`, which a render sharded over several cards need not have
        # current, is made the current device for the warm-up and the capture.
        with profiling.rare_span("rpt.graph.capture"), torch.cuda.device(device):
            self._capture(run, device, what)

    def _capture(self, run: Callable[[], None], device, what: str) -> None:
        stream = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        t0 = time.perf_counter()
        # The eager warm-up, on a side stream as torch.cuda.graphs asks: it
        # loads every kernel's module, raises the kernels' shared-memory
        # limits once and makes the device's launch-count table, none of
        # which may happen inside a capture.
        with torch.cuda.stream(side):
            run()
        stream.wait_stream(side)
        torch.cuda.synchronize(device)
        # The pool's size: what stays reserved after the allocator's cache
        # is emptied, before and after (a live graph's pool is kept).
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        self.graph = torch.cuda.CUDAGraph()
        try:
            # Captured on the side stream: torch.cuda.graph's own default
            # stream is made once, on the first device that captures.
            with torch.cuda.graph(self.graph, stream=side):
                run()
        except Exception as e:
            raise RuntimeError(f"capturing {what} as a CUDA graph failed: {e}") from e
        torch.cuda.synchronize(device)
        self.seconds = time.perf_counter() - t0
        torch.cuda.empty_cache()
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved


class GraphCache:
    """Insertion-ordered bounded cache of functions that may hold captured
    graphs. Every entry pins what its graphs read (`pin`, kept alive while
    the entry lives), and eviction is FIFO at `cap` entries (an evicted
    graph frees its memory pool)."""

    def __init__(self, cap: int = 16):
        self.cap = cap
        self._entries: dict = {}

    def get(self, key):
        e = self._entries.get(key)
        return e[0] if e is not None else None

    def put(self, key, fn, pin=None) -> None:
        while len(self._entries) >= self.cap:
            self._entries.pop(next(iter(self._entries)))
        self._entries[key] = (fn, pin)

    def values(self) -> list:
        return [fn for fn, _ in self._entries.values()]

    def __len__(self) -> int:
        return len(self._entries)
