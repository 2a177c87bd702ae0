"""Profiling and observability (`rpt_tpu/profiling.py`): device traces, rays/s
counters, wavefront occupancy, and spans of the entry's host work.

- `device_trace(logdir)`: a `torch.profiler` trace of everything inside the
  block (the host's ops and, on a CUDA card, its kernels), written where
  TensorBoard (`tensorboard --logdir <logdir>`) or Perfetto opens it, with
  the program's spans as ranges on the same clock; it yields the profile.
- `rays_per_sample`: the ray accounting of every rays/s number: one camera
  or bounce ray per depth plus one shadow ray per shadow-casting light per
  path vertex.
- `measure_rays_per_sec`: time full-frame samples through the renderer's
  many-sample function (on the card, one CUDA graph replay per sample).
- `depth_stats`: per-depth live-lane occupancy of one 1-spp pass, in the
  32x32-tile ray order the kernels see.
- `span`, `rare_span`, `recording`, `spans`: the program's own record of
  where the host spends an entry call (`Renderer.render` /
  `iterative_render`): the scene's compile and digest, the replays, the
  image's tone map and byte copy. A span is recorded inside `with recording():`
  or while any torch profiler runs; a rare span (a scene build, a graph
  capture, a kernel library load: once per scene, capture or library) is
  recorded always. `spans()` returns the last `RING` records, oldest first:

      with rpt_tpu_torch.profiling.recording():
          renderer.render()
      for s in rpt_tpu_torch.profiling.spans():
          print(s.name, (s.end_ns - s.start_ns) / 1e6, "ms", s.attrs)

  Records go to torch's profiler (`record_function`) only inside
  `device_trace`, whose profiler the program runs: a profiler started
  elsewhere sees nothing of them on its timeline.

The meters take the renderer's real type, as the reference's take the
scene's: a float64 renderer times and counts float64 passes.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import numpy as np
import torch

__all__ = [
    "device_trace", "rays_per_sample", "measure_rays_per_sec", "depth_stats",
    "span", "rare_span", "recording", "spans", "Span", "RING",
]

# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

RING = 65536  # the records kept: the last RING spans to end
_ring: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()  # each thread's open spans, innermost last
_lock = threading.Lock()
_recording = 0  # open `recording()` blocks
_mirrored = 0  # open `device_trace` blocks
_profiler_enabled = torch.autograd._profiler_enabled


def _open() -> list:
    try:
        return _local.open
    except AttributeError:
        _local.open = []
        return _local.open


class Span:
    """One span of the program's host work: `name`, `start_ns` and
    `end_ns` (`time.perf_counter_ns`), its own `id`, its parent's id
    (`parent`, None at a root), the id of the root span of its call
    (`call`: every span of one `render()` or `iterative_render()` shares
    it) and `attrs`, counts taken at its boundary (bytes, samples)."""

    __slots__ = ("name", "attrs", "id", "parent", "call", "start_ns", "end_ns", "_mirror")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.start_ns = self.end_ns = None

    def set(self, **attrs) -> None:
        """Attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = _open()
        self.id = next(_ids)
        outer = stack[-1] if stack else None
        self.parent, self.call = (outer.id, outer.call) if outer is not None else (None, self.id)
        stack.append(self)
        self._mirror = None
        if _mirrored:
            self._mirror = torch.profiler.record_function(self.name)
            self._mirror.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._mirror is not None:
            self._mirror.__exit__(*exc)
        _open().pop()
        _ring.append(self)
        return False


class _NoSpan:
    """What `span` returns while nothing records: one shared object."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A span of the entry's host work, recorded inside `recording()` or
    while a torch profiler runs; else the shared no-op `NO_SPAN`."""
    if _recording or _profiler_enabled():
        return Span(name, attrs)
    return NO_SPAN


def rare_span(name: str, **attrs) -> Span:
    """A span of an event that comes once per scene, capture or library and
    takes seconds (a scene build, a graph capture, a kernel library load):
    recorded always, so a rebuild or a recapture shows at any time."""
    return Span(name, attrs)


@contextlib.contextmanager
def recording():
    """Record every span inside the block (the operator's switch)."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans() -> list:
    """The recorded spans (the last `RING` to end), oldest first."""
    return sorted(_ring, key=lambda s: (s.start_ns, s.id))


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace everything inside the block into `logdir` (a Chrome trace JSON
    file that TensorBoard's profile plugin and Perfetto open), the
    program's spans among the host's ranges; yields the profile, whose
    `events()` a caller may read once the block has closed:

        with rpt_tpu_torch.profiling.device_trace("traces") as prof:
            renderer.render()
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    global _mirrored
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        with _lock:
            _mirrored += 1
        try:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            with _lock:
                _mirrored -= 1


def _n_shadow_lights(scene_data) -> int:
    """Lights that cost a shadow ray per path vertex (all but ambient)."""
    from .lights import AmbientLightData

    return sum(0 if isinstance(light, AmbientLightData) else 1 for light in scene_data.lights)


def rays_per_sample(scene_data, max_bounces: int) -> int:
    """Rays traced per pixel per sample: one closest hit per depth plus one
    shadow ray per shadow-casting light per depth."""
    return (max_bounces + 1) * (1 + _n_shadow_lights(scene_data))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_rays_per_sec(renderer, warmup: int = 2, passes: int = 8) -> dict:
    """Time `passes` full-frame samples through `make_render_many_fn` (after
    `warmup` samples, which also capture its graph on the card), ending in a
    device synchronize. Returns {"rays_per_sec", "samples_per_sec",
    "seconds", "rays"}."""
    from .renderer import make_render_many_fn

    scene_data, t_min, ev_scale = renderer._pass_args()
    fn = make_render_many_fn(scene_data, renderer.width, renderer.height, renderer.max_bounces)
    base = renderer.base_key()

    def run(start, n):
        out = fn(renderer.camera, base, start, n, t_min, ev_scale)
        _sync(scene_data.device)
        return out

    run(0, warmup)
    t0 = time.perf_counter()
    run(warmup, passes)
    dt = time.perf_counter() - t0
    rays = renderer.width * renderer.height * rays_per_sample(scene_data, renderer.max_bounces) * passes
    return {"rays_per_sec": rays / dt, "samples_per_sec": passes / dt, "seconds": dt, "rays": rays}


def depth_stats(renderer, seed: int | None = None) -> dict:
    """Per-depth wavefront occupancy of one 1-spp pass, as numpy arrays:
    found_frac[d], the share of lanes that hit a surface at depth d, and
    cont_frac[d], the share still alive entering depth d+1 (the lanes every
    deeper traversal carries). Keyed by PRNGKey(seed) itself, as the
    reference's is (the renderer's seed when None), in the renderer's type."""
    from . import random as rnd
    from .integrator import trace_paths
    from .renderer import camera_rays_tiled, pixel_ndc_tiled

    scene_data, t_min, _ = renderer._pass_args()
    ndc = pixel_ndc_tiled(renderer.width, renderer.height, scene_data.device, scene_data.dtype)
    key = rnd.PRNGKey(renderer.seed if seed is None else seed, x64=scene_data.dtype == torch.float64)
    o, d, k_trace = camera_rays_tiled(renderer.camera.to(scene_data.device), key, ndc)
    _, stats = trace_paths(scene_data, o, d, k_trace, renderer.max_bounces, t_min, want_stats=True)
    return {k: np.asarray(v.cpu().numpy()) for k, v in stats.items()}
