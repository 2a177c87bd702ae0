"""Renderer: camera + compiled scene + integrator -> frames (`rpt_tpu/renderer.py`).

One pass traces one jittered sample for every pixel as one wavefront, with
pixels in 32x32-tile order (the order the reference draws its random
numbers in, so same-seed renders agree pixel by pixel). Sample i is keyed by
fold_in(PRNGKey(seed), start + i), so a render split into chunks equals one
made in a single call, bit for bit.

The JAX package runs n samples in one device dispatch (a `lax.fori_loop`
under one `jax.jit`, `make_render_many_fn`). Its counterpart here is a CUDA
graph: `make_render_many_fn` captures one sample pass of a compiled scene at
one size, after one eager warm-up, and replays it once per sample. The pass
reads and writes only fixed tensors (`_PassInputs`): the camera, the base
key, a sample counter on the device that the pass advances itself, the
exposure scale and the tile-order sums, updated in place. So a replay needs
no copy from the host, and a new camera, seed, start or exposure is written
into those tensors and replays the same graph. The ray offset `t_min` is an
immediate of the traversal kernels, so each `t_min` has its own capture.
On the CPU the same pass runs eagerly. Graphs are cached per scene,
resolution, bounce count and wavefront order (`SceneCache`, as the reference
caches its jit functions), each entry pinning the SceneData whose tensors it
reads. The order (`integrator._auto_compact`, `RPT_COMPACT`) is resolved
when a scene's passes are made and is fixed in their graph, so a render
under another `RPT_COMPACT` gets a graph of its own.

`Renderer(dynamic=True)` is the path for animation frames, the reference's
`_render_many_dynamic`. The reference passes the compiled scene as a jit
argument, so frames of one topology share one executable. Here frames of
one topology (`_topology_key`: every tensor's shape, dtype and device and
every other field of the compiled scene by value, the packs' stack depths
included, but not the digest) share one entry of `_DYNAMIC_CACHE`: a slot,
a compiled scene whose tensors are the entry's own, and the sample passes
over it. Each frame's compiled tensors are copied into the slot's in place
before the replays, so one capture serves every frame.

A replay launches the kernels without calling their Python wrappers; their
launch counts live on the device and are added to by the kernels
themselves (`kernels.launch_counter`), so every replay counts.

`Renderer(dtype=torch.float64)` renders as the reference does with
`dtype=jnp.float64` under `jax_enable_x64`: an x64 key (`PRNGKey(seed,
x64=True)`), 64-bit draws, a float64 scene, pixel grid, sums, `t_min` and
exposure, and the float64 kernels. The dtype is part of every cache key, so
a float32 graph is never replayed for a float64 render, nor the reverse.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from . import profiling
from . import random as rnd
from .buffer import Buffer, Filter
from .camera import _FIELDS as _CAMERA_FIELDS
from .camera import Camera
from .integrator import _auto_compact, trace_paths
from .scene import Scene, SceneData
from .utils.cuda_graph import Capture, GraphCache
from .utils.device import resolve_device
from .utils.vmath import numpy_real, real_value

__all__ = [
    "Renderer", "render_pass_tiled", "pixel_ndc_tiled", "shard_rows", "shard_ndc",
    "jittered_ndc", "camera_rays_tiled", "scene_cache_key", "SceneCache",
    "make_render_many_fn", "dynamic_render_many_fn", "make_render_fn", "render_pass",
]

# The reference's f64 epsilon does not survive f32; default self-intersection offset.
DEFAULT_EPSILON = 1e-3
TILE_W = TILE_H = 32


def _tile_perm_np(width: int, height: int):
    """Forward / inverse permutations putting pixels in 32x32-tile order
    (ragged edges give partial tiles)."""
    idx = np.arange(width * height, dtype=np.int32).reshape(height, width)
    parts = [
        idx[y:y + TILE_H, x:x + TILE_W].ravel()
        for y in range(0, height, TILE_H)
        for x in range(0, width, TILE_W)
    ]
    perm = np.concatenate(parts)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


def pixel_ndc_tiled(width: int, height: int, device=None, dtype=torch.float32):
    """Pixel-center NDC coordinates on the max dimension (y flipped so row 0
    is the top), in tile order, plus dim and the inverse permutation; the
    coordinates computed on the host in `dtype`, as the reference does."""
    np_dtype = numpy_real(dtype)
    dim = float(max(width, height))
    x = np.arange(width, dtype=np_dtype)
    y = np.arange(height, dtype=np_dtype)
    xn = (2.0 * x + 1.0 - width) / dim
    yn = (2.0 * (height - y) - 1.0 - height) / dim
    xg = np.broadcast_to(xn[None, :], (height, width)).reshape(-1)
    yg = np.broadcast_to(yn[:, None], (height, width)).reshape(-1)
    perm, inv = _tile_perm_np(width, height)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    return as_t(xg[perm].astype(np_dtype)), as_t(yg[perm].astype(np_dtype)), dim, as_t(inv.astype(np.int64))


def shard_rows(x: torch.Tensor, index: int, count: int) -> torch.Tensor:
    """The rows of shard `index` of `count` of `x`, as the reference's
    sharded render cuts its pixels: `x` padded with zero rows to a multiple
    of `count`, then cut into `count` contiguous slices."""
    m = -(-x.shape[0] // count)
    x = torch.cat([x, x.new_zeros((m * count - x.shape[0],) + tuple(x.shape[1:]))])
    return x[index * m:(index + 1) * m]


def shard_ndc(ndc, index: int, count: int) -> tuple:
    """Shard `index` of `count` of a pixel grid (`pixel_ndc_tiled(...)`):
    (xg, yg, dim, None), its slices of the tile-ordered coordinates
    (`shard_rows`, the pads at 0.0). The pad pixels are traced too, and
    dropped when the shards' sums are put back in pixel order."""
    xg, yg, dim, _ = ndc
    return shard_rows(xg, index, count), shard_rows(yg, index, count), dim, None


def jittered_ndc(key, ndc, shard: Optional[int] = None) -> tuple:
    """The jittered pixel coordinates of one pass in tile order, and the
    keys left for the camera and the path tracer: (x, y, k_cam, k_trace).
    `ndc` is `pixel_ndc_tiled(...)` (or a `shard_ndc` of it); `key` a host
    or a tensor key.

    With `shard`, the index of a slice of a sharded render
    (`parallel.sharding`), the key is folded with the index first, as the
    reference's shard body folds it. That body draws its jitter in [-1, 1)
    and multiplies it by 1/dim rounded to the render's type; on the same key
    and length this draw in [-1/dim, 1/dim) equals it bit for bit, in either
    type: 2u - 1 is exact and the span 2/dim is twice the rounded 1/dim, so
    both are one rounding of (1/dim)(2u - 1). So one form serves both."""
    xg, yg, dim, _ = ndc
    if shard is not None:
        key = rnd.fold_in(key, shard)
    k_jit, k_cam, k_trace = rnd.split(key, 3)
    jitter = rnd.uniform(k_jit, (2, xg.shape[0]), dtype=xg.dtype, minval=-1.0 / dim, maxval=1.0 / dim, device=xg.device)
    return xg + jitter[0], yg + jitter[1], k_cam, k_trace


def camera_rays_tiled(camera: Camera, key, ndc, shard: Optional[int] = None) -> tuple:
    """The jittered camera rays of one pass in tile order, and the key left
    for the path tracer: (o, d, k_trace). `ndc`, `key` and `shard` as
    `jittered_ndc` takes them."""
    x, y, k_cam, k_trace = jittered_ndc(key, ndc, shard)
    o, d = camera.cast_rays(x, y, k_cam)
    return o, d, k_trace


def render_pass_tiled(scene_data: SceneData, camera: Camera, key, ndc, max_bounces: int,
                      t_min: float, ev_scale, compact=None, shard: Optional[int] = None) -> torch.Tensor:
    """Trace one sample per pixel; (H*W, 3) radiance in tile order.
    `ev_scale` is a float or a 0-d tensor of the scene's type; `compact` the
    wavefront order (`trace_paths`); `shard` the index of a sharded
    render's slice (`camera_rays_tiled`)."""
    o, d, k_trace = camera_rays_tiled(camera, key, ndc, shard)
    return trace_paths(scene_data, o, d, k_trace, max_bounces, t_min, compact=compact) * ev_scale


# ---------------------------------------------------------------------------
# Per-scene caches
# ---------------------------------------------------------------------------


def scene_cache_key(scene_data: SceneData) -> str:
    """Identity of a compiled scene for the per-scene caches: the content
    digest that Scene.compile stamps, the traversal packs it carries (a
    compile under another kernel choice has the same digest and other
    kernels), its device and its real type. A SceneData built outside
    Scene.compile (digest "") falls back to id(), which SceneCache keeps
    valid by pinning the SceneData while its entry lives."""
    packs = ",".join(pack.library for pack in scene_data.packs)
    return f"{scene_data.digest or f'id:{id(scene_data)}'}|{packs}|{scene_data.device}|{scene_data.dtype}"



class SceneCache(GraphCache):
    """The per-scene cache of the renderer's functions (the reference's
    `SceneCache`): every entry pins the SceneData it was built from."""

    def captures(self) -> int:
        """CUDA graphs held by the live entries that are sample passes
        (`make_render_many_fn`'s and the dynamic path's)."""
        return sum(len(fn.captures) for fn in self.values() if isinstance(fn, _SamplePasses))


_PASS_CACHE = SceneCache()
_MANY_CACHE = SceneCache()
_DYNAMIC_CACHE = SceneCache()


# ---------------------------------------------------------------------------
# The sample pass and its graph
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _PassInputs:
    """Everything a sample pass reads or writes, in tensors allocated once:
    a captured graph reads and writes these very tensors on every replay."""

    camera: Camera  # float32 fields, as in the reference
    key: torch.Tensor  # (2,) int64: the base key (or the pass's own key)
    counter: torch.Tensor  # (1,) int64: the index of the next sample
    ev_scale: torch.Tensor  # () in the render's real type
    s: torch.Tensor  # (H*W, 3) in the render's real type, tile order
    ss: torch.Tensor  # (H*W,)

    @staticmethod
    def new(npix: int, device, dtype=torch.float32) -> "_PassInputs":
        f32 = dict(dtype=torch.float32, device=device)
        real = dict(dtype=dtype, device=device)
        camera = Camera(**{f: torch.zeros(getattr(Camera(), f).shape, **f32) for f in _CAMERA_FIELDS})
        return _PassInputs(camera=camera, key=torch.zeros(2, dtype=torch.int64, device=device),
                           counter=torch.zeros(1, dtype=torch.int64, device=device),
                           ev_scale=torch.zeros((), **real), s=torch.zeros((npix, 3), **real),
                           ss=torch.zeros((npix,), **real))

    def load(self, camera: Camera, key, start: int, ev_scale: float, sums=None) -> None:
        """Write a call's inputs in place; the sums start from `sums` (tile
        order) or from zero."""
        for f in _CAMERA_FIELDS:
            getattr(self.camera, f).copy_(getattr(camera, f))
        self.key.copy_(rnd.to_device(key, "cpu") if not isinstance(key, torch.Tensor) else key)
        self.counter.fill_(int(start))
        self.ev_scale.fill_(real_value(ev_scale, self.ev_scale.dtype))
        if sums is None:
            self.s.zero_()
            self.ss.zero_()
        else:
            self.s.copy_(sums[0])
            self.ss.copy_(sums[1])


def _sample_pass(sd: SceneData, inp: _PassInputs, ndc, max_bounces: int, t_min: float, fold: bool,
                 compact, shard: Optional[int] = None) -> None:
    """Add one sample per pixel into `inp.s` / `inp.ss` (tile order), the
    wavefronts ordered as `compact` says. With `fold` the sample is keyed
    by fold_in(inp.key, inp.counter), computed on the device, and the
    counter then advances by one; without, by inp.key itself. A shard's
    pass folds its index in after that (`camera_rays_tiled`)."""
    key = rnd.fold_in(inp.key, inp.counter) if fold else inp.key
    frame = render_pass_tiled(sd, inp.camera, key, ndc, max_bounces, t_min, inp.ev_scale, compact, shard)
    inp.s.add_(frame)
    inp.ss.add_(torch.sum(frame * frame, dim=-1))
    if fold:
        inp.counter.add_(1)


class _SamplePasses:
    """Sample passes of one compiled scene at one size and bounce count over
    fixed inputs: captured and replayed on a CUDA device, run eagerly on the
    CPU or when `eager`. `fold` keys sample i by fold_in(key, start + i)
    (make_render_many_fn); without it one pass is keyed by the key itself
    (make_render_fn). `compact` is the wavefront order of every pass
    (`trace_paths`), fixed here: a graph captures one order. `shard`,
    (index, count), makes these the passes of one shard of a sharded render
    (`parallel.sharding`): its slice of the pixels (`shard_ndc`), its index
    folded into every key; their sums are that slice's, in tile order."""

    def __init__(self, scene_data: SceneData, width: int, height: int, max_bounces: int, compact,
                 fold: bool = True, eager: bool = False, shard: Optional[tuple] = None):
        self.sd = scene_data
        self.width, self.height, self.max_bounces = width, height, max_bounces
        self.compact = compact
        self.fold = fold
        self.device = scene_data.device
        self.dtype = scene_data.dtype
        self.graphed = self.device.type == "cuda" and not eager
        self.ndc = pixel_ndc_tiled(width, height, self.device, self.dtype)
        self.shard = None
        if shard is not None:
            self.ndc, self.shard = shard_ndc(self.ndc, *shard), shard[0]
        self.perm = torch.as_tensor(_tile_perm_np(width, height)[0].astype(np.int64), device=self.device)
        self.inputs = _PassInputs.new(self.ndc[0].shape[0], self.device, self.dtype)
        self.captures: dict = {}  # t_min -> Capture

    def _run(self, t_min: float) -> None:
        _sample_pass(self.sd, self.inputs, self.ndc, self.max_bounces, t_min, self.fold, self.compact, self.shard)

    def capture(self, t_min: float) -> Capture:
        """The graph of a pass at `t_min`, captured on first use."""
        t_min = real_value(t_min, self.dtype)
        if t_min not in self.captures:
            self.captures[t_min] = Capture(lambda: self._run(t_min), self.device, "the sample pass")
        return self.captures[t_min]

    def __call__(self, camera: Camera, key, start: int, n: int, t_min, ev_scale, into=None):
        """(sum (H, W, 3), sum_sq (H, W)) of samples start .. start+n-1,
        added one by one onto `into`, a (sum, sum_sq) pair, when given (so a
        render in chunks adds in the order of one call, bit for bit)."""
        n = int(n)
        with profiling.span("rpt.passes.run", n=n):
            t_min = self.load(camera, key, start, n, t_min, ev_scale, self.tiled(into))
            self.replay(n, t_min)
            inv = self.ndc[3]
            return (self.inputs.s[inv].reshape(self.height, self.width, 3),
                    self.inputs.ss[inv].reshape(self.height, self.width))

    def tiled(self, into) -> Optional[tuple]:
        """A (sum (H, W, 3), sum_sq (H, W)) pair in tile order, or None."""
        if into is None:
            return None
        if into[0].dtype != self.dtype or into[1].dtype != self.dtype:
            raise TypeError(f"{into[0].dtype} sums cannot take the samples of a {self.dtype} render")
        return into[0].reshape(-1, 3)[self.perm], into[1].reshape(-1)[self.perm]

    def load(self, camera: Camera, key, start: int, n: int, t_min, ev_scale, sums=None) -> float:
        """Ready a call of `n` samples: capture the pass at `t_min` on first
        use (its warm-up writes the inputs, so they are loaded after), then
        write the call's inputs, the sums from `sums` (tile order, this
        pass's pixels) or zero. Returns t_min in the render's type."""
        t_min = real_value(t_min, self.dtype)
        if self.graphed and n > 0:
            self.capture(t_min)
        self.inputs.load(camera, key, start, ev_scale, sums)
        return t_min

    def replay(self, n: int, t_min: float) -> None:
        """Add `n` samples onto the loaded sums: `n` replays of the graph,
        or `n` eager passes. Nothing here waits for the device."""
        for _ in range(n):
            if self.graphed:
                self.captures[t_min].graph.replay()
            else:
                self._run(t_min)


def _pass_key(scene_data: SceneData, width: int, height: int, max_bounces: int) -> tuple:
    """The cache key of a scene's passes: the scene (`scene_cache_key`,
    which holds its real type, so a float32 graph is never replayed for a
    float64 render), the size, the bounces and the wavefront order
    `_auto_compact` resolves now (`RPT_COMPACT` included), so a render under
    another order gets its own graph."""
    return (scene_cache_key(scene_data), width, height, max_bounces, _auto_compact(scene_data))


def make_render_many_fn(scene_data: SceneData, width: int, height: int, max_bounces: int):
    """(camera, base_key, start, n, t_min, ev_scale, into=None) -> (sum
    (H, W, 3), sum_sq (H, W)) of `n` samples per pixel, sample i keyed by
    fold_in(base_key, start + i), added onto `into` (a buffer's sum and
    sum_sq) when given. On a CUDA device one pass is a CUDA graph,
    captured at the first call (for each t_min) and replayed n times; a
    failed capture raises. Cached per (scene, width, height, max_bounces,
    real type, wavefront order)."""
    cache_key = _pass_key(scene_data, width, height, max_bounces)
    fn = _MANY_CACHE.get(cache_key)
    if fn is None:
        fn = _SamplePasses(scene_data, width, height, max_bounces, cache_key[-1])
        _MANY_CACHE.put(cache_key, fn, scene_data)
    return fn


def _eager_render_many_fn(scene_data: SceneData, width: int, height: int, max_bounces: int):
    """make_render_many_fn's function with every pass run eagerly, also on
    a CUDA device, in the wavefront order make_render_many_fn would take:
    the yardstick a graph is held against and the path that Python-level
    instrumentation of the wrappers sees. Not cached."""
    return _SamplePasses(scene_data, width, height, max_bounces, _auto_compact(scene_data), eager=True)


# ---------------------------------------------------------------------------
# The dynamic path: one graph per scene topology, refilled frame by frame
# ---------------------------------------------------------------------------


def _scene_fields(x) -> list:
    """The fields of a dataclass node of a compiled scene's tree that the
    dynamic path walks, for its key, its slot and its refill alike. The
    digest names the content, which a topology leaves free; the pass reads
    the environment through env_color, env_hdri and env_quad, never through
    the host object."""
    return [f.name for f in dataclasses.fields(x)
            if not (isinstance(x, SceneData) and f.name in ("digest", "environment"))]


def _leaves(x, path: str = ""):
    """(path, value) of every leaf of a compiled scene's tree, in field
    order: tensors, and the non-tensor fields (ints, None, the device)."""
    if isinstance(x, torch.Tensor):
        yield path, x
    elif dataclasses.is_dataclass(x):
        yield path, type(x).__qualname__
        for name in _scene_fields(x):
            yield from _leaves(getattr(x, name), f"{path}.{name}")
    elif isinstance(x, tuple):
        yield path, len(x)
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, x


def _tensor_leaves(scene_data: SceneData) -> list:
    return [v for _, v in _leaves(scene_data) if isinstance(v, torch.Tensor)]


def _topology_key(scene_data: SceneData, width: int, height: int, max_bounces: int) -> tuple:
    """The key of a scene's dynamic passes: every tensor leaf's path,
    shape, dtype and device, every other field by value (the packs'
    `group_depth`, `stack_depth`, `n_tlas`, which parts are None, the
    lights' classes in order, the device), and the size, bounces and
    wavefront order, as `_pass_key`. The digest is left out, as the
    reference strips it: frames that differ only in tensor values share a
    key. A captured pass may read a host value of the scene only if it is
    in this key: the packs' ints are launch arguments and launch geometry
    that a graph freezes."""
    leaves = tuple(
        (path, tuple(v.shape), v.dtype, v.device) if isinstance(v, torch.Tensor) else (path, v)
        for path, v in _leaves(scene_data)
    )
    return (leaves, width, height, max_bounces, _auto_compact(scene_data))


def dynamic_render_many_fn(scene_data: SceneData, width: int, height: int, max_bounces: int):
    """`make_render_many_fn` for animation frames (`Renderer(dynamic=True)`,
    the reference's `_render_many_dynamic`): frames whose scenes share a
    topology (`_topology_key`) share one entry of `_DYNAMIC_CACHE`, which
    owns a slot (a SceneData whose tensors are clones of the first frame's,
    so no frame's own tensors are captured) and the sample passes over it.
    Each call copies the frame's tensors into the slot's, in place on the
    current stream, where the graph replays; the pass then captures on
    first use and replays, as `make_render_many_fn`'s does. A new topology
    gets a new entry and a new capture."""
    key = _topology_key(scene_data, width, height, max_bounces)
    fn = _DYNAMIC_CACHE.get(key)
    if fn is None:
        # The slot keys no content: its digest is cleared.
        slot = dataclasses.replace(_map_tensors(scene_data, torch.clone), digest="")
        fn = _SamplePasses(slot, width, height, max_bounces, key[-1])
        _DYNAMIC_CACHE.put(key, fn, slot)
    else:
        for dst, src in zip(_tensor_leaves(fn.sd), _tensor_leaves(scene_data), strict=True):
            dst.copy_(src)
    return fn


def _map_tensors(x, fn):
    """A copy of a compiled scene's tree with fn applied to every tensor
    that `_leaves` yields; the fields it skips are kept as they are."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        return tuple(_map_tensors(v, fn) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{name: _map_tensors(getattr(x, name), fn) for name in _scene_fields(x)})
    return x


def make_render_fn(scene_data: SceneData, width: int, height: int, max_bounces: int):
    """(camera, key, t_min, ev_scale) -> one (H, W, 3) frame keyed by `key`,
    as a CUDA graph on a CUDA device; cached per (scene, resolution,
    bounces, real type, wavefront order)."""
    cache_key = _pass_key(scene_data, width, height, max_bounces)
    fn = _PASS_CACHE.get(cache_key)
    if fn is None:
        passes = _SamplePasses(scene_data, width, height, max_bounces, cache_key[-1], fold=False)

        def fn(camera, key, t_min, ev_scale):
            return passes(camera, key, 0, 1, t_min, ev_scale)[0]

        _PASS_CACHE.put(cache_key, fn, scene_data)
    return fn


def render_pass(scene_data, camera, key, width, height, max_bounces, t_min, ev_scale) -> torch.Tensor:
    """One sample per pixel through the per-scene cached pass."""
    return make_render_fn(scene_data, width, height, max_bounces)(camera, key, t_min, ev_scale)


class Renderer:
    """Fluent builder over a scene + camera. Runs on `device` (the CUDA card
    when None; raises without one), in `dtype`, float32 or float64 (see the
    module docstring). Defaults: 800x600, EV 0, no filter, 0 bounces, 1
    sample."""

    def __init__(
        self,
        scene: Scene,
        camera: Optional[Camera] = None,
        width: int = 800,
        height: int = 600,
        exposure_value: float = 0.0,
        filter: Filter = Filter(),
        max_bounces: int = 0,
        num_samples: int = 1,
        epsilon: float = DEFAULT_EPSILON,
        seed: int = 0,
        dtype=torch.float32,
        dynamic: bool = False,
        device=None,
    ):
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"a render is float32 or float64, not {dtype}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.scene = scene
        self.camera = camera if camera is not None else Camera()
        self.width = width
        self.height = height
        self.exposure_value = exposure_value
        self.filter = filter
        self.max_bounces = max_bounces
        self.num_samples = num_samples
        self.epsilon = epsilon
        self.seed = seed
        # dynamic=True: for frame loops whose geometry moves but whose
        # topology stays; one graph serves every frame
        # (`dynamic_render_many_fn`).
        self.dynamic = dynamic

    def set_width(self, width: int) -> "Renderer":
        self.width = width
        return self

    def set_height(self, height: int) -> "Renderer":
        self.height = height
        return self

    def set_exposure_value(self, ev: float) -> "Renderer":
        self.exposure_value = ev
        return self

    def set_filter(self, filter: Filter) -> "Renderer":
        self.filter = filter
        return self

    def set_max_bounces(self, n: int) -> "Renderer":
        self.max_bounces = n
        return self

    def set_num_samples(self, n: int) -> "Renderer":
        self.num_samples = n
        return self

    def scene_data(self) -> SceneData:
        return self.scene.compile(self.dtype, device=self.device)

    def base_key(self) -> np.ndarray:
        """PRNGKey(seed) as the reference makes it for a render of this
        type: an x64 key for a float64 render."""
        return rnd.PRNGKey(self.seed, x64=self.dtype == torch.float64)

    def _pass_args(self, scene_data: Optional[SceneData] = None):
        """(compiled scene, t_min, ev_scale) of a pass, as values of the
        render's type. A given scene must be of that type."""
        sd = scene_data if scene_data is not None else self.scene_data()
        if sd.dtype != self.dtype:
            raise TypeError(f"a {self.dtype} render cannot take a {sd.dtype} scene")
        return sd, real_value(self.epsilon, self.dtype), real_value(2.0 ** self.exposure_value, self.dtype)

    def _sample_with(self, make_fn, buffer: Buffer, iterations: int, start_iter: int,
                     scene_data: Optional[SceneData]) -> Buffer:
        sd, t_min, ev_scale = self._pass_args(scene_data)
        fn = make_fn(sd, self.width, self.height, self.max_bounces)
        s, ss = fn(self.camera, self.base_key(), start_iter, iterations, t_min, ev_scale,
                   into=(buffer.sum, buffer.sum_sq))
        return Buffer(sum=s, sum_sq=ss, count=buffer.count + iterations)

    def sample_into(self, buffer: Buffer, iterations: int, start_iter: int = 0,
                    scene_data: Optional[SceneData] = None) -> Buffer:
        """Add `iterations` samples per pixel to the buffer, samples
        start_iter .. start_iter+iterations-1 of the seed's stream; on a
        CUDA device one replay of the captured pass per sample
        (`make_render_many_fn`, or `dynamic_render_many_fn` when
        `dynamic`). `scene_data` overrides the scene's own compile (e.g. a
        converted reference scene)."""
        make_fn = dynamic_render_many_fn if self.dynamic else make_render_many_fn
        return self._sample_with(make_fn, buffer, iterations, start_iter, scene_data)

    def _sample_into_eager(self, buffer: Buffer, iterations: int, start_iter: int = 0,
                           scene_data: Optional[SceneData] = None) -> Buffer:
        """`sample_into` with every pass run eagerly (`_eager_render_many_fn`)."""
        return self._sample_with(_eager_render_many_fn, buffer, iterations, start_iter, scene_data)

    def render_buffer(self, scene_data: Optional[SceneData] = None) -> Buffer:
        buffer = Buffer.new(self.width, self.height, device=self.device, dtype=self.dtype)
        return self.sample_into(buffer, self.num_samples, scene_data=scene_data)

    def render(self) -> np.ndarray:
        """Render and return a uint8 (H, W, 3) image."""
        with profiling.span("rpt.render"):
            return self.render_buffer().image(self.filter)

    def iterative_render(
        self,
        callback_interval: int,
        callback: Callable[[int, Buffer], None],
        checkpoint_path: Optional[str] = None,
    ) -> Buffer:
        """Progressive rendering with a callback every `callback_interval`
        samples. With `checkpoint_path`, the accumulator and the sampling
        cursor are saved after every interval, and a render resumes from an
        existing checkpoint, bit for bit equal to an uninterrupted one (a
        checkpoint of the JAX package's renderer loads too)."""
        with profiling.span("rpt.iterative_render"):
            buffer = Buffer.new(self.width, self.height, device=self.device, dtype=self.dtype)
            iteration = 0
            if checkpoint_path and os.path.exists(checkpoint_path):
                buffer, ck_seed, iteration = Buffer.load(checkpoint_path, device=self.device)
                if ck_seed != self.seed:
                    raise ValueError(f"checkpoint seed {ck_seed} != renderer seed {self.seed}")
            while iteration < self.num_samples:
                steps = min(self.num_samples - iteration, callback_interval)
                with profiling.span("rpt.update", iteration=iteration + steps):
                    buffer = self.sample_into(buffer, steps, start_iter=iteration)
                    iteration += steps
                    if checkpoint_path:
                        buffer.save(checkpoint_path, seed=self.seed, iteration=iteration)
                    with profiling.span("rpt.callback"):
                        callback(iteration, buffer)
            return buffer
