"""The port's sharded rendering (`rpt_tpu_torch.parallel`) against the JAX
package's (`rpt_tpu.parallel`), on the CPU.

The reference shards over the conftest's 8 virtual CPU devices; the port's
shards are a mesh that names the CPU several times
(`make_ray_mesh(n, device="cpu")`). Both sides draw the same numbers for
every pixel of every shard (the shard's key folds its index in, and its
jitter is a draw of its own slice's length under that key; the reference's
shard form of the draw and the single-device form give the same bits), so
the images compare pixel by pixel, to the render
tolerance of `tests/test_torch_render.py` (99% of pixels to rtol 1e-3 /
atol 1e-4, the mean to 1e-3 relative), and the float64 render to the bar
of `tests/test_torch_f64.py`. Gradients are held to `tests/test_torch_grad.py`'s
bars: 1e-4 of the largest |g| at bounces 0, 1e-3 beyond.
"""

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpt_tpu
import rpt_tpu_torch
import rpt_tpu_torch.scene as scene_mod
from rpt_tpu.parallel import make_ray_mesh as ref_make_ray_mesh
from rpt_tpu.parallel import make_sharded_diff_fn as ref_make_sharded_diff_fn
from rpt_tpu.parallel import render_distributed as ref_render_distributed
from rpt_tpu.parallel import render_pass_sharded as ref_render_pass_sharded
from rpt_tpu.renderer import pixel_ndc_tiled as ref_pixel_ndc_tiled
from rpt_tpu_torch import random as rnd
from rpt_tpu_torch.materials import MaterialTable
from rpt_tpu_torch.parallel import (
    make_ray_mesh, make_sharded_diff_fn, make_sharded_many_fn, render_distributed, render_pass_sharded,
)
from rpt_tpu_torch.parallel import sharding
from rpt_tpu_torch.renderer import jittered_ndc, pixel_ndc_tiled, shard_ndc
from rpt_tpu_torch.scenes import build_dragon_scene, dragon_camera
from test_torch_f64 import x64
from test_torch_grad import FIELDS, assert_grad_agrees, fd_cam, fd_scene, leaves, port_grads
from test_torch_reference_native import reference_native
from test_torch_render import EXAMPLES, sphere_scene

reference_native()

SEED = 3


def simple_scene(pkg):
    """`tests/test_parallel_grad.py`'s `simple_scene()` and `cam()`."""
    scene = pkg.Scene()
    scene.add(pkg.Object(pkg.sphere()).material(pkg.Material.diffuse((0.7, 0.3, 0.2))))
    scene.add(pkg.Object(pkg.plane([0.0, 1.0, 0.0], -1.0)).material(pkg.Material.diffuse((0.6, 0.6, 0.6))))
    scene.add(pkg.PointLight((30.0, 30.0, 30.0), (3.0, 6.0, 3.0)))
    return scene, pkg.Camera.look_at([0.0, 2.0, 8.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], 0.7)


def renderers(make_scene, **kw):
    """The reference's Renderer and the port's on the CPU, same scene and
    settings."""
    ref_scene, ref_cam = make_scene(rpt_tpu)[:2]
    port_scene, port_cam = make_scene(rpt_tpu_torch)[:2]
    return (rpt_tpu.Renderer(ref_scene, ref_cam, seed=SEED, **kw),
            rpt_tpu_torch.Renderer(port_scene, port_cam, seed=SEED, device="cpu", **kw))


def assert_images_agree(got, want, rtol=1e-3, atol=1e-4, share=0.99, mean_rtol=1e-3):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    close = np.isclose(got, want, rtol=rtol, atol=atol).all(-1)
    assert close.mean() >= share, f"only {close.mean():.4f} of pixels agree"
    assert abs(got.mean() - want.mean()) <= mean_rtol * abs(want.mean())


@pytest.mark.parametrize("size,bounces,spp", [((36, 20), 1, 8), ((33, 7), 0, 1)], ids=["36x20", "pad_33x7"])
def test_distributed_render_matches_reference(size, bounces, spp):
    """`render_distributed` on 8 shards; 33x7 = 231 pixels pads by 1."""
    ref, port = renderers(simple_scene, width=size[0], height=size[1], max_bounces=bounces, num_samples=spp)
    want = np.asarray(ref_render_distributed(ref, ref_make_ray_mesh(8)).mean_image())
    buf = render_distributed(port, make_ray_mesh(8, device="cpu"))
    assert buf.count == spp and buf.sum.device.type == "cpu"
    got = buf.mean_image().numpy()
    assert got.shape == (size[1], size[0], 3)
    assert_images_agree(got, want)


def trefoil(pkg):
    """A 1,200-triangle trefoil of `examples/dragon.py`'s scene, in either
    package, and its camera."""
    if pkg is rpt_tpu:
        sys.path.insert(0, EXAMPLES)
        import dragon

        return dragon.build_scene(target_tris=1200), rpt_tpu.Camera.look_at(
            (-2.5, 4.0, 6.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), math.pi / 6)
    return build_dragon_scene(target_tris=1200), dragon_camera()


def test_trefoil_through_the_plain_bvh8_walk_matches_reference(monkeypatch):
    """4 shards through the port's bvh8 walk (the wide threshold lowered
    below the trefoil's rows), against the reference's walk."""
    monkeypatch.setattr(scene_mod, "WIDE_KERNEL_MIN_TRIS", 1024)
    ref, port = renderers(trefoil, width=32, height=24, max_bounces=1, num_samples=2)
    assert port.scene_data().mesh_pack.library == "bvh8"
    want = np.asarray(ref_render_distributed(ref, ref_make_ray_mesh(4)).mean_image())
    got = render_distributed(port, make_ray_mesh(4, device="cpu")).mean_image().numpy()
    assert_images_agree(got, want)


def test_render_pass_sharded_matches_reference_and_one_sample_of_many():
    """One sharded pass keyed by a key, against the reference's; and bit
    for bit the first sample of `make_sharded_many_fn` from the key it was
    folded from."""
    ref, port = renderers(simple_scene, width=36, height=20, max_bounces=1)
    base = rnd.PRNGKey(SEED)
    key = rnd.fold_in(base, 0)
    ref_sd = ref.scene.compile()
    want = np.asarray(ref_render_pass_sharded(ref_sd, ref.camera, jnp.asarray(key), 36, 20, 1, jnp.float32(1e-3),
                                              jnp.float32(1.0), ref_make_ray_mesh(8)))
    sd, mesh = port.scene_data(), make_ray_mesh(8, device="cpu")
    got = render_pass_sharded(sd, port.camera, key, 36, 20, 1, 1e-3, 1.0, mesh)
    assert_images_agree(got.numpy(), want)
    s, _ = make_sharded_many_fn(sd, 36, 20, 1, mesh)(port.camera, base, 0, 1, 1e-3, 1.0)
    assert torch.equal(s, got)


def test_many_fn_in_two_chunks_equals_one_call():
    """Samples 0-1 and then 2-4 added onto them equal samples 0-4 in one
    call, bit for bit, on 7 shards (36x20 = 720 pixels pads by 4)."""
    _, port = renderers(simple_scene, width=36, height=20, max_bounces=1)
    fn = make_sharded_many_fn(port.scene_data(), 36, 20, 1, make_ray_mesh(7, device="cpu"))
    base = port.base_key()
    whole = fn(port.camera, base, 0, 5, 1e-3, 1.0)
    chunked = fn(port.camera, base, 2, 3, 1e-3, 1.0, into=fn(port.camera, base, 0, 2, 1e-3, 1.0))
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])
    assert not torch.equal(whole[0], fn(port.camera, base, 0, 4, 1e-3, 1.0)[0])


@pytest.mark.parametrize("shard", [0, 6], ids=["first", "last_padded"])
def test_shard_jitter_is_the_reference_shard_draw(shard):
    """A shard's jittered pixel coordinates are bit for bit the reference's
    shard body's, `xg + uniform(k_jit, (2, m), -1, 1) * jitter_scale` on its
    padded slice (100x60 on 7 shards: 858 pixels a shard, the last with 6
    pads). The reference's single-device form, a draw in [-1/dim, 1/dim),
    gives the same bits on the same slice and key: 2u - 1 is exact, so both
    are one rounding of (1/dim) (2u - 1). What a shard must take is its own
    folded key and its own slice's length: the single-device pass draws
    other numbers for those pixels."""
    w, h, n = 100, 60, 7
    key = rnd.fold_in(rnd.PRNGKey(SEED), 5)
    xg, yg, dim, _ = ref_pixel_ndc_tiled(w, h)
    m = -(-xg.shape[0] // n)
    cut = slice(shard * m, (shard + 1) * m)
    xs, ys = jnp.pad(xg, (0, m * n - xg.shape[0]))[cut], jnp.pad(yg, (0, m * n - yg.shape[0]))[cut]
    k_jit = jax.random.split(jax.random.fold_in(jnp.asarray(key), shard), 3)[0]
    scale = jnp.asarray(1.0 / dim, jnp.float32)
    jitter = jax.random.uniform(k_jit, (2, m), jnp.float32, minval=-1.0, maxval=1.0) * scale
    want = (np.asarray(xs + jitter[0]), np.asarray(ys + jitter[1]))
    single = jax.random.uniform(k_jit, (2, m), jnp.float32, minval=-1.0 / dim, maxval=1.0 / dim)
    np.testing.assert_array_equal(np.asarray(single), np.asarray(jitter))

    ndc = shard_ndc(pixel_ndc_tiled(w, h, "cpu"), shard, n)
    np.testing.assert_array_equal(ndc[0].numpy(), np.asarray(xs))
    x, y, _, _ = jittered_ndc(key, ndc, shard=shard)
    np.testing.assert_array_equal(x.numpy(), want[0])
    np.testing.assert_array_equal(y.numpy(), want[1])
    full = jittered_ndc(key, pixel_ndc_tiled(w, h, "cpu"))
    real = min(m, xg.shape[0] - shard * m)
    assert not np.array_equal(full[0][shard * m:shard * m + real].numpy(), want[0][:real])


def ref_sharded_grads(fn, mats0, camera, key):
    g = jax.grad(lambda m: jnp.mean(fn(m, camera, key, jnp.float32(1e-3), jnp.float32(1.0))))(mats0)
    return {f: np.asarray(getattr(g, f)) for f in FIELDS}


@pytest.mark.parametrize("bounces", [0, 2])
def test_sharded_gradient_matches_jax_grad(bounces):
    """d mean(image) / d every material leaf of `make_sharded_diff_fn` on
    8 shards at 12x8, against `jax.grad` of the reference's."""
    ref_sd = fd_scene(rpt_tpu).compile()
    ref_fn = ref_make_sharded_diff_fn(ref_sd, 12, 8, bounces, ref_make_ray_mesh(8))
    key = rnd.PRNGKey(SEED)
    want = ref_sharded_grads(ref_fn, ref_sd.materials, fd_cam(rpt_tpu), jnp.asarray(key))
    sd = fd_scene(rpt_tpu_torch).compile(device="cpu")
    fn = make_sharded_diff_fn(sd, 12, 8, bounces, make_ray_mesh(8, device="cpu"))
    got = port_grads(lambda m: fn(m, fd_cam(rpt_tpu_torch), key, 1e-3, 1.0), sd.materials)
    assert any(np.abs(g).max() > 0 for g in want.values())
    for f in FIELDS:
        if np.abs(want[f]).max() > 0:
            assert_grad_agrees(got[f], want[f], bounces, f)
        else:
            assert np.abs(got[f]).max() == 0, f


def test_dryrun_multichip_step_matches_reference():
    """`__graft_entry__.dryrun_multichip`'s training step: the sphere scene
    at 32x16, 2 bounces, 8 shards, one SGD step (lr 1e-2) on
    mean((image - 0)^2): the loss and every new material leaf against the
    reference's."""
    w, h, bounces, lr = 32, 16, 2, 1e-2
    key = rnd.PRNGKey(0)
    ref_scene, ref_cam, _ = sphere_scene(rpt_tpu)
    ref_sd = ref_scene.compile()
    ref_fn = ref_make_sharded_diff_fn(ref_sd, w, h, bounces, ref_make_ray_mesh(8))

    def ref_loss(m):
        return jnp.mean(ref_fn(m, ref_cam, jnp.asarray(key), jnp.float32(1e-3), jnp.float32(1.0)) ** 2)

    ref_l, ref_g = jax.value_and_grad(ref_loss)(ref_sd.materials)
    ref_new = jax.tree_util.tree_map(lambda p, g: p - lr * g, ref_sd.materials, ref_g)

    scene, cam, _ = sphere_scene(rpt_tpu_torch)
    sd = scene.compile(device="cpu")
    fn = make_sharded_diff_fn(sd, w, h, bounces, make_ray_mesh(8, device="cpu"))
    m = leaves(sd.materials)
    loss = torch.mean(fn(MaterialTable(**m), cam, key, 1e-3, 1.0) ** 2)
    loss.backward()
    with torch.no_grad():
        new = {f: m[f] - lr * (m[f].grad if m[f].grad is not None else torch.zeros_like(m[f])) for f in FIELDS}
    loss = float(loss.detach())
    assert np.isfinite(loss) and abs(loss - float(ref_l)) <= 1e-3 * abs(float(ref_l))
    for f in FIELDS:
        want_g = np.asarray(getattr(ref_g, f))
        got_g = np.zeros_like(want_g) if m[f].grad is None else m[f].grad.numpy()
        if np.abs(want_g).max() > 0:
            assert_grad_agrees(got_g, want_g, bounces, f)
        else:
            assert np.abs(got_g).max() == 0, f
        # The step moves each leaf by lr * g: within lr x the gradient's bar,
        # and a float32 ulp of the leaf for the subtraction's rounding.
        got, want = new[f].numpy(), np.asarray(getattr(ref_new, f))
        slack = lr * 1e-3 * np.abs(want_g).max() + np.spacing(np.float32(np.abs(want).max()))
        assert np.abs(got - want).max() <= slack, f


def test_float64_render_matches_reference_under_x64():
    """A float64 render on 2 shards against the reference's under x64 (the
    x64 key, 64-bit draws), to `tests/test_torch_f64.py`'s bar."""
    kw = dict(width=32, height=24, max_bounces=1, num_samples=2, seed=SEED)
    with x64():
        ref_scene, ref_cam, _ = sphere_scene(rpt_tpu)
        ref = rpt_tpu.Renderer(ref_scene, ref_cam, dtype=jnp.float64, **kw)
        want = np.asarray(ref_render_distributed(ref, ref_make_ray_mesh(2)).mean_image())
    scene, cam, _ = sphere_scene(rpt_tpu_torch)
    port = rpt_tpu_torch.Renderer(scene, cam, dtype=torch.float64, device="cpu", **kw)
    buf = render_distributed(port, make_ray_mesh(2, device="cpu"))
    assert buf.sum.dtype == torch.float64 and want.dtype == np.float64
    assert_images_agree(buf.mean_image().numpy(), want, rtol=1e-5, atol=1e-7, share=0.995, mean_rtol=1e-7)


def test_make_ray_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_ray_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_ray_mesh(2)
    mesh = make_ray_mesh(3, device="cpu")
    assert mesh.size == 3 and set(mesh.devices) == {torch.device("cpu")}


def test_make_ray_mesh_with_more_cards_than_exist_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_ray_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_ray_mesh(1).devices == (torch.device("cuda", 0),)
    with pytest.raises(RuntimeError, match="3 cards"):
        make_ray_mesh(3)


def test_shards_on_one_device_share_its_compiled_scene():
    scene, _ = simple_scene(rpt_tpu_torch)
    sd = scene.compile(device="cpu")
    scenes = sharding._scenes_by_device(sd, make_ray_mesh(3, device="cpu"))
    assert list(scenes) == [torch.device("cpu")] and scenes[torch.device("cpu")] is sd
    with pytest.raises(ValueError, match="local shards"):
        sharding.RayMesh(devices=("cpu",) * 2, local=(2,))
