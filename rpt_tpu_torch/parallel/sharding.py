"""Rendering with the ray wavefront sharded over several devices
(`rpt_tpu/parallel/sharding.py`).

The reference shards the flattened pixel wavefront over a 1-D device mesh
with `shard_map`: the pixel grid, in 32x32-tile order, is padded with zeros
to a multiple of the mesh's size and cut into contiguous slices; shard k
traces its slice with the sample key folded with k (`axis_index("rays")`),
and the scene is replicated. Radiance needs no collective: every shard owns
its pixels. Gradients with respect to the material table are summed over the
shards by `shard_map`'s transpose.

Here a mesh (`RayMesh`) is an ordered tuple of torch devices, one entry per
shard. A device may be named several times, one shard per entry: that is
how several shards run on one card or on the CPU (the reference's tests get
8 shards from 8 virtual CPU devices). Each shard is the renderer's own
sample pass over its slice (`renderer._SamplePasses` with `shard=`): on a
CUDA device one CUDA graph per shard, captured once per `t_min` and replayed
once per sample with the sample counter on the device, as
`Renderer.render_buffer` does. Every shard's inputs are written first and
then every shard's replays go out, so nothing waits for a device between
shards, and shards on distinct cards run at once; each shard's work is
issued with its card current, as the kernels launch on the current card.
The shards' sums are gathered onto the mesh's first device and put back in
pixel order there. The compiled scene is copied once to each distinct
device of the mesh.

The sharded gradient (`make_sharded_diff_fn`) runs eagerly on torch
autograd: the material table reaches each shard's device by a
differentiable copy, so the backward pass sums the shards' gradients onto
the caller's table, the counterpart of the reference's psum.

A mesh may hold other processes' shards (`multihost.make_global_ray_mesh`):
each process renders its own, and the finished sums, or frames, are
all-gathered (`collective`), so every process returns the whole frame. Its
sharded gradient sums the processes' parts of each gradient in rank order
on every process, so every process's leaves get the same bits.

No mesh size gives the image of `Renderer.render_buffer`: sample i of shard
k is keyed by fold_in(fold_in(base, start + i), k), and its jitter is a draw
of its own slice's length (`renderer.jittered_ndc`, which also shows why
the reference's shard form of the draw gives the same bits). The sharded
render is held to the reference's sharded render.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from ..buffer import Buffer
from ..integrator import _auto_compact
from ..materials import MaterialTable
from ..random import _device
from ..renderer import (
    SceneCache, _map_tensors, _SamplePasses, pixel_ndc_tiled, render_pass_tiled, scene_cache_key, shard_ndc,
    shard_rows,
)
from ..scene import SceneData
from ..utils.vmath import real_value
from . import collective

__all__ = [
    "RayMesh",
    "make_ray_mesh",
    "render_pass_sharded",
    "make_sharded_render_fn",
    "make_sharded_diff_fn",
    "make_sharded_many_fn",
    "render_distributed",
]


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """A 1-D mesh of ray shards, the reference's `Mesh(devices, ("rays",))`.

    `devices[k]` is shard k's device; shard k traces the k-th slice of the
    padded pixel wavefront and folds k into its keys. In a multi-process run
    (`multihost.make_global_ray_mesh`) `devices` holds every process's
    shards, process-major, `rank` and `world_size` are this process's, and
    this process renders the shards `local` names (a device of another
    process is only a name here). Frozen, so it keys the caches."""

    devices: tuple
    local: tuple = ()
    rank: int = 0
    world_size: int = 1

    def __post_init__(self):
        object.__setattr__(self, "devices", tuple(_device(d) for d in self.devices))
        if not self.devices:
            raise ValueError("a ray mesh needs at least one shard")
        if not self.local:
            object.__setattr__(self, "local", tuple(range(len(self.devices))))
        if any(not 0 <= k < len(self.devices) for k in self.local):
            raise ValueError(f"local shards {self.local} are not shards of a {len(self.devices)}-shard mesh")

    @property
    def size(self) -> int:
        """The number of shards (the reference's `mesh.devices.size`)."""
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """The device of this process's first shard, where its sums gather."""
        return self.devices[self.local[0]]


def make_ray_mesh(n_devices: Optional[int] = None, device=None) -> RayMesh:
    """A mesh of `n_devices` shards. With no `device`: the first
    `n_devices` CUDA cards (every card when None), one shard each; raises
    when there is no card or fewer cards than asked. With `device` ("cpu",
    "cuda:0", ...): `n_devices` shards (1 when None) on that one device."""
    if device is not None:
        return RayMesh(devices=(_device(device),) * (1 if n_devices is None else int(n_devices)))
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' for shards on the CPU")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 0 < n <= count:
        raise RuntimeError(f"a mesh of {n} cards was asked for and {count} are available; "
                           "pass device= to put several shards on one device")
    return RayMesh(devices=tuple(torch.device("cuda", i) for i in range(n)))


def _on(device: torch.device):
    """Make `device` the current card for what runs inside: the kernels
    launch on the current card's streams (a no-op on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _scene_on(scene_data: SceneData, device: torch.device) -> SceneData:
    """The compiled scene with every tensor copied to `device` (itself if
    it is there: its tensors' device, since a scene compiled for "cuda"
    lies on the card that was current then)."""
    if scene_data.materials.color.device == device:
        return scene_data
    return dataclasses.replace(_map_tensors(scene_data, lambda t: t.to(device)), device=device)


def _scenes_by_device(scene_data: SceneData, mesh: RayMesh) -> dict:
    """{device: the compiled scene there} for this process's shards: one
    copy per distinct device."""
    out = {}
    for k in mesh.local:
        d = mesh.devices[k]
        if d not in out:
            out[d] = _scene_on(scene_data, d)
    return out


class _ShardedPasses:
    """The sample passes of this process's shards of `mesh`, one
    `_SamplePasses` per shard (one CUDA graph each on a card). `fold` keys
    sample i by fold_in(key, start + i) before the shard's own fold, as
    `make_sharded_many_fn`; without it one pass is keyed by the key itself,
    as `make_sharded_render_fn`."""

    def __init__(self, scene_data: SceneData, width: int, height: int, max_bounces: int, mesh: RayMesh,
                 compact, fold: bool = True, eager: bool = False):
        self.width, self.height = width, height
        self.mesh = mesh
        self.dtype = scene_data.dtype
        scenes = _scenes_by_device(scene_data, mesh)
        self.shards = [_SamplePasses(scenes[mesh.devices[k]], width, height, max_bounces, compact, fold=fold,
                                     eager=eager, shard=(k, mesh.size)) for k in mesh.local]
        self.device = mesh.first
        self.inv = pixel_ndc_tiled(width, height, self.device, self.dtype)[3]

    def local_sums(self, camera, key, start: int, n: int, t_min, ev_scale, into=None) -> tuple:
        """This process's shards' (sum, sum_sq) of samples start ..
        start+n-1, their slices concatenated in shard order (tile order,
        pads included) on `self.device`, added onto `into` (a (sum, sum_sq)
        pair of the whole frame) when given. Every shard's inputs are
        loaded (a capture on first use) before any replay goes out."""
        n = int(n)
        sums = [None] * len(self.shards)
        if into is not None:
            tiled = self.shards[0].tiled(into)
            sums = [tuple(shard_rows(x.to(p.device), p.shard, self.mesh.size) for x in tiled) for p in self.shards]
        t_mins = []
        for p, sum_ in zip(self.shards, sums):
            with _on(p.device):
                t_mins.append(p.load(camera, key, start, n, t_min, ev_scale, sum_))
        for p, t in zip(self.shards, t_mins):
            with _on(p.device):
                p.replay(n, t)
        return (torch.cat([p.inputs.s.to(self.device) for p in self.shards]),
                torch.cat([p.inputs.ss.to(self.device) for p in self.shards]))

    def frame(self, s: torch.Tensor, ss: torch.Tensor) -> tuple:
        """Every shard's sums, concatenated in shard order, in pixel order:
        (sum (H, W, 3), sum_sq (H, W)); the pads are dropped."""
        return s[self.inv].reshape(self.height, self.width, 3), ss[self.inv].reshape(self.height, self.width)

    def __call__(self, camera, key, start: int, n: int, t_min, ev_scale, into=None) -> tuple:
        s, ss = self.local_sums(camera, key, start, n, t_min, ev_scale, into)
        if self.mesh.world_size > 1:
            s, ss = collective.all_gather(s), collective.all_gather(ss)
        return self.frame(s, ss)


# Keyed on the scene's content digest and the mesh, bounded, each entry
# pinning its SceneData: see renderer.SceneCache.
_SHARD_CACHE = SceneCache()


def _shard_key(kind: str, scene_data: SceneData, width: int, height: int, max_bounces: int, mesh: RayMesh) -> tuple:
    """A cache key: the kind, the scene, the size, the bounces, the mesh and
    the wavefront order `_auto_compact` resolves now (`RPT_COMPACT`)."""
    return (kind, scene_cache_key(scene_data), width, height, max_bounces, mesh, _auto_compact(scene_data))


def _sharded_passes(kind: str, scene_data: SceneData, width: int, height: int, max_bounces: int,
                    mesh: RayMesh) -> _ShardedPasses:
    key = _shard_key(kind, scene_data, width, height, max_bounces, mesh)
    fn = _SHARD_CACHE.get(key)
    if fn is None:
        fn = _ShardedPasses(scene_data, width, height, max_bounces, mesh, key[-1], fold=kind == "many")
        _SHARD_CACHE.put(key, fn, scene_data)
    return fn


def make_sharded_render_fn(scene_data: SceneData, width: int, height: int, max_bounces: int, mesh: RayMesh):
    """(camera, key, t_min, ev_scale) -> one (H, W, 3) frame keyed by `key`,
    the pixels sharded over `mesh` (shard k keyed by fold_in(key, k)).
    Cached per (scene, size, bounces, mesh, wavefront order)."""
    passes = _sharded_passes("pass", scene_data, width, height, max_bounces, mesh)

    def fn(camera, key, t_min, ev_scale):
        return passes(camera, key, 0, 1, t_min, ev_scale)[0]

    return fn


def render_pass_sharded(scene_data, camera, key, width, height, max_bounces, t_min, ev_scale, mesh):
    """One sample per pixel, sharded across `mesh`; returns (H, W, 3).
    Pixels are padded to a multiple of the shard count; the scene and
    camera go to every shard's device."""
    return make_sharded_render_fn(scene_data, width, height, max_bounces, mesh)(camera, key, t_min, ev_scale)


def make_sharded_many_fn(scene_data: SceneData, width: int, height: int, max_bounces: int, mesh: RayMesh):
    """(camera, base_key, start, n, t_min, ev_scale, into=None) -> (sum
    (H, W, 3), sum_sq (H, W)) of `n` samples per pixel with the pixels
    sharded over `mesh`, on the mesh's first device: sample i of shard k
    keyed by fold_in(fold_in(base_key, start + i), k). The sums start from
    zero, as the reference's, or from `into` (a buffer's sum and sum_sq),
    onto which the samples are added one by one, so a render in chunks
    equals one call bit for bit. On a card each shard's pass is a CUDA
    graph replayed once per sample. Cached per (scene, size, bounces, mesh,
    wavefront order)."""
    return _sharded_passes("many", scene_data, width, height, max_bounces, mesh)


def _eager_sharded_many_fn(scene_data: SceneData, width: int, height: int, max_bounces: int, mesh: RayMesh):
    """make_sharded_many_fn's function with every shard's pass run eagerly,
    also on a card: the yardstick its graphs are held against. Not cached."""
    return _ShardedPasses(scene_data, width, height, max_bounces, mesh, _auto_compact(scene_data), eager=True)


def _materials_on(materials: MaterialTable, device: torch.device) -> MaterialTable:
    """The material table on `device`, by a differentiable copy (the table
    itself where it already is)."""
    return MaterialTable(**{f.name: getattr(materials, f.name).to(device) for f in dataclasses.fields(materials)})


def _replicated_inputs(materials: MaterialTable, camera, mesh: RayMesh, dtype) -> tuple:
    """(materials, camera, the tensors replaced) for a call over a mesh of
    several processes: every tensor of the table and the camera that
    requires grad passes through `collective.replicated`, so the backward
    pass sums the processes' gradients. First, every process's names of
    those tensors and the scene's type must be the same (else each raises)."""
    tensors = {f"materials.{f.name}": getattr(materials, f.name) for f in dataclasses.fields(materials)}
    tensors.update({f"camera.{f.name}": getattr(camera, f.name) for f in dataclasses.fields(camera)})
    grad = {name: t for name, t in tensors.items() if torch.is_grad_enabled() and t.requires_grad}
    collective.check_same("tensors requiring grad and type", (sorted(grad), str(dtype)))
    if not grad:
        return materials, camera, ()
    grad = collective.replicated(grad, mesh.first)

    def part(obj, prefix):
        return dataclasses.replace(obj, **{name[len(prefix):]: t for name, t in grad.items()
                                           if name.startswith(prefix)})

    return part(materials, "materials."), part(camera, "camera."), tuple(grad.values())


def make_sharded_diff_fn(scene_data: SceneData, width: int, height: int, max_bounces: int, mesh: RayMesh):
    """(materials, camera, key, t_min, ev_scale) -> (H, W, 3), one sample
    per pixel keyed by `key` with the pixels sharded over `mesh`,
    differentiable in the material table, on the mesh's first device. The
    geometry is each device's copy of the compiled scene; the table goes to
    each shard's device by a differentiable copy, so the backward pass sums
    the shards' gradients onto the caller's table. Eager; a ray that
    requires grad raises at a walk, as in `grad.make_material_render_fn`.

    Over a mesh of several processes every process calls with the same
    arguments and renders its own shards; their frames are gathered, so
    every process returns the whole frame (`collective.gather_rows`). Each
    tensor of the table and the camera that requires grad is replicated
    (`collective.replicated`): the backward pass gathers every process's
    part of its gradient and adds them in rank order, so every process's
    leaves get the same gradient, bit for bit, the sum over all shards.
    Cached per (scene, size, bounces, mesh, wavefront order)."""
    cache_key = _shard_key("diff", scene_data, width, height, max_bounces, mesh)
    fn = _SHARD_CACHE.get(cache_key)
    if fn is not None:
        return fn
    compact, dtype = cache_key[-1], scene_data.dtype
    scenes = _scenes_by_device(scene_data, mesh)
    ndc = pixel_ndc_tiled(width, height, mesh.first, dtype)
    shards = [(k, mesh.devices[k], shard_ndc(pixel_ndc_tiled(width, height, mesh.devices[k], dtype), k, mesh.size))
              for k in mesh.local]

    def fn(materials, camera, key, t_min, ev_scale):
        if materials.color.dtype != dtype:
            raise TypeError(f"a {dtype} scene cannot take {materials.color.dtype} materials")
        if mesh.world_size > 1:
            materials, camera, replicated = _replicated_inputs(materials, camera, mesh, dtype)
        t = real_value(float(t_min), dtype)
        frames = []
        for k, d, ndc_k in shards:
            sd = dataclasses.replace(scenes[d], materials=_materials_on(materials, d))
            with _on(d):
                frame = render_pass_tiled(sd, camera.to(d), key, ndc_k, max_bounces, t, ev_scale, compact, shard=k)
            frames.append(frame.to(mesh.first))
        rows = torch.cat(frames)
        if mesh.world_size > 1:
            rows = collective.gather_rows(rows, replicated)
        return rows[ndc[3]].reshape(height, width, 3)

    _SHARD_CACHE.put(cache_key, fn, scene_data)
    return fn


def _pass_args(renderer, mesh: RayMesh) -> tuple:
    """The renderer's (compiled scene, t_min, ev_scale) with the scene
    compiled on the mesh's first device: the renderer's own compile when
    that is its device."""
    same = _device(renderer.device) == mesh.first
    return renderer._pass_args(None if same else renderer.scene.compile(renderer.dtype, device=mesh.first))


def render_distributed(renderer, mesh: Optional[RayMesh] = None) -> Buffer:
    """`renderer`'s frame buffer with the pixels sharded over `mesh` (every
    CUDA card when None; raises without one): all `num_samples` samples in
    one call of `make_sharded_many_fn`, in the renderer's real type (a
    float64 render keys from the x64 key, as `Renderer` does). The buffer
    lies on the mesh's first device; over a mesh of several processes it is
    the whole frame on every process."""
    if mesh is None:
        mesh = make_ray_mesh()
    sd, t_min, ev_scale = _pass_args(renderer, mesh)
    fn = make_sharded_many_fn(sd, renderer.width, renderer.height, renderer.max_bounces, mesh)
    s, ss = fn(renderer.camera, renderer.base_key(), 0, renderer.num_samples, t_min, ev_scale)
    return Buffer(sum=s, sum_sq=ss, count=renderer.num_samples)
