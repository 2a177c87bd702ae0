"""The port's wavefront sorts against the JAX package (`tests/test_compaction.py`).

A sort only reorders what `SceneData.intersect` and `occluded` see: RNG
draws and shading stay in the original lane order, and a lane's hit does not
depend on its place in the wavefront. So every mode must equal the masked
trace bit for bit, on a scene that compiles a `tlas8` pack (instanced meshes)
and on one that compiles a `bvh8` pack (the 5k trefoil under a lowered
`WIDE_KERNEL_MIN_TRIS`). The permutations themselves must equal the
reference's element for element, and the mode `_auto_compact` picks must be
the reference's on the same scenes for every `RPT_COMPACT` value. The port's
morton trace is held against the reference's morton trace at the render
tolerance of `tests/test_torch_render.py` (XLA contracts multiply-adds where
torch does not, so a few paths take other walks).
"""

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpt_tpu
import rpt_tpu.scene as ref_scene_mod
import rpt_tpu_torch
import rpt_tpu_torch.scene as scene_mod
from rpt_tpu import integrator as ref_int
from rpt_tpu_torch import integrator as port_int
from rpt_tpu_torch import random as rnd
from rpt_tpu_torch import renderer as renderer_mod
from rpt_tpu_torch.profiling import depth_stats
from test_tlas_pallas import _build_instanced_scene
from test_torch_reference_native import reference_native
from test_torch_render import EXAMPLES, sphere_scene

reference_native()

W, H = 48, 32
SEED = 7
MODES = [True, "octant", "morton"]


# ---------------------------------------------------------------------------
# Scenes, built with either package's API
# ---------------------------------------------------------------------------


def mesh_instances_scene(pkg):
    """`tests/test_compaction.py`'s scene: mesh instances sharing two meshes
    (the two-level tree, tlas8), a sphere, a floor and an area light."""
    meshes, instances = _build_instanced_scene(2, 6, tris_per_mesh=40)
    mesh_objs = [pkg.shapes.Mesh(vertices=np.asarray(m.vertices), normals=np.asarray(m.normals)) for m in meshes]
    scene = pkg.Scene()
    for mesh_idx, mat4, _ in instances:
        scene.add(pkg.Object(pkg.shapes.Transformed(mesh_objs[mesh_idx], np.asarray(mat4)))
                  .material(pkg.Material.diffuse(pkg.hex_color(0xB0B0B0))))
    scene.add(pkg.Object(pkg.sphere()).material(pkg.Material.specular(pkg.hex_color(0xB7410E), 0.2)))
    scene.add(pkg.Object(pkg.plane([0.0, 1.0, 0.0], -1.0)).material(pkg.Material.diffuse(pkg.hex_color(0x777777))))
    scene.add(pkg.ObjectLight(pkg.Object(pkg.sphere().scale([2.0] * 3).translate([0.0, 14.0, 0.0]))
                              .material(pkg.Material.light(pkg.hex_color(0xFFFFFF), 30.0))))
    cam = pkg.Camera.look_at([-4.0, 5.0, 9.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], np.pi / 4)
    return scene, cam


def trefoil_scene(pkg):
    """The `dragon` scene with the 5k-triangle trefoil (125 segments x 20
    sides): its JAX example, or the port's copy."""
    if pkg is rpt_tpu:
        sys.path.insert(0, EXAMPLES)
        import dragon

        scene = dragon.build_scene(target_tris=5000)
    else:
        scene = rpt_tpu_torch.scenes.build_dragon_scene(segments=125, sides=20)
    cam = pkg.Camera.look_at((-2.5, 4.0, 6.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), math.pi / 6)
    return scene, cam


def _compile(pkg, builder):
    scene, cam = builder(pkg)
    if pkg is rpt_tpu:
        return scene.compile(), cam
    return scene.compile(device="cpu"), cam


@pytest.fixture(scope="module")
def compiled():
    """Both packages' compiled scenes and cameras: `instanced` (tlas8),
    `mesh` (the trefoil with both packages' WIDE_KERNEL_MIN_TRIS lowered to
    4096, so bvh8) and `sphere` (no traversal pack)."""
    out = {}
    saved = ref_scene_mod.WIDE_KERNEL_MIN_TRIS, scene_mod.WIDE_KERNEL_MIN_TRIS
    ref_scene_mod.WIDE_KERNEL_MIN_TRIS = scene_mod.WIDE_KERNEL_MIN_TRIS = 4096
    try:
        for name, builder in (("instanced", mesh_instances_scene), ("mesh", trefoil_scene),
                              ("sphere", lambda pkg: sphere_scene(pkg)[:2])):
            out[name] = {pkg: _compile(pkg, builder) for pkg in (rpt_tpu, rpt_tpu_torch)}
    finally:
        ref_scene_mod.WIDE_KERNEL_MIN_TRIS, scene_mod.WIDE_KERNEL_MIN_TRIS = saved
    assert out["instanced"][rpt_tpu_torch][0].instance_pack.library == "tlas8"
    assert out["mesh"][rpt_tpu_torch][0].mesh_pack.library == "bvh8" and out["mesh"][rpt_tpu][0].bvh8_packed is not None
    return out


def camera_rays(cam):
    """The reference camera's rays through the W x H pixel centers, as numpy."""
    from rpt_tpu.renderer import pixel_ndc

    xg, yg, _ = pixel_ndc(W, H)
    o, d = cam.cast_rays(xg, yg, jax.random.PRNGKey(SEED))
    return np.array(o), np.array(d)


def port_trace(compiled, name, compact):
    sd = compiled[name][rpt_tpu_torch][0]
    o, d = camera_rays(compiled[name][rpt_tpu][1])
    return port_int.trace_paths(sd, torch.as_tensor(o), torch.as_tensor(d), rnd.PRNGKey(SEED), 3, 1e-3,
                                compact=compact)


# ---------------------------------------------------------------------------
# The permutations
# ---------------------------------------------------------------------------


def _perm_inputs(seed, n=777):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, size=(n, 3)).astype(np.float32)  # some origins outside the box
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::50, 1] = 0.0  # a zero component is not negative
    active = rng.random(n) < 0.6
    box = (np.full(3, -2.0, np.float32), np.array([2.0, 2.5, 1.0], np.float32))
    return o, d, active, box


@pytest.mark.parametrize("which", ["compaction", "octant", "morton"])
@pytest.mark.parametrize("seed", [3, 5])
def test_perm_and_inverse_equal_the_reference(which, seed):
    o, d, active, (lo, hi) = _perm_inputs(seed)
    args = {"compaction": (active,), "octant": (d, active), "morton": (o, d, active, lo, hi)}[which]
    fn = f"_{which}_perm"
    want_perm, want_pos = getattr(ref_int, fn)(*map(jnp.asarray, args))
    perm, pos = getattr(port_int, fn)(*map(torch.as_tensor, args))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want_perm))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(perm.numpy()[pos.numpy()], np.arange(o.shape[0]))
    # Live lanes first, in every mode.
    n_alive = int(active.sum())
    assert active[perm.numpy()][:n_alive].all() and not active[perm.numpy()][n_alive:].any()


@pytest.mark.parametrize("columns", [6, 8])  # 8: the padded width (the shadow rays' gather)
def test_gather_packed_round_trip(columns):
    rng = np.random.default_rng(6)
    n = 333
    perm = torch.as_tensor(rng.permutation(n))
    f1 = rng.normal(size=(n,)).astype(np.float32)
    f1[7] = np.inf  # hit.t carries +inf misses through packing
    f3 = rng.normal(size=(n, 3)).astype(np.float32)
    ints = rng.integers(-5, 900, size=(n,)).astype(np.int32)
    bools = rng.random(n) < 0.5
    arrays = (f1, f3, ints, bools) if columns == 6 else (f3, f3 + 1.0, f1, bools)
    got = port_int._gather_packed(perm, tuple(map(torch.as_tensor, arrays)))
    p = perm.numpy()
    for g, want in zip(got, arrays):
        assert g.dtype == torch.as_tensor(want).dtype and g.shape == want.shape
        np.testing.assert_array_equal(g.numpy(), want[p])
    want_ref = ref_int._gather_packed(jnp.asarray(p, jnp.int32), tuple(map(jnp.asarray, arrays)))
    for g, w in zip(got, want_ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_scene_box_is_the_root_box(compiled):
    for name in ("instanced", "mesh", "sphere"):
        lo, hi = port_int._scene_box(compiled[name][rpt_tpu_torch][0])
        want_lo, want_hi = ref_int._scene_box(compiled[name][rpt_tpu][0])
        np.testing.assert_array_equal(lo.numpy(), np.asarray(want_lo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(want_hi))


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compact", MODES, ids=[str(m) for m in MODES])
@pytest.mark.parametrize("name", ["instanced", "mesh"])
def test_sorted_trace_equals_masked_bit_for_bit(compiled, name, compact):
    masked = port_trace(compiled, name, False)
    assert torch.isfinite(masked).all() and float(masked.mean()) > 0.0
    assert torch.equal(port_trace(compiled, name, compact), masked)


@pytest.mark.parametrize("name", ["instanced", "mesh"])
def test_morton_trace_matches_reference(compiled, name):
    ref_sd, cam = compiled[name][rpt_tpu]
    o, d = camera_rays(cam)
    want = np.asarray(ref_int.trace_paths(ref_sd, jnp.asarray(o), jnp.asarray(d), jax.random.PRNGKey(SEED), 3,
                                          1e-3, compact="morton"))
    got = port_trace(compiled, name, "morton").numpy()
    assert got.shape == want.shape == (W * H, 3)
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of rays agree"
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())


@pytest.mark.parametrize("value", [None, "", "0", "1", "octant", "morton"])
def test_auto_compact_picks_the_reference_mode(compiled, value, monkeypatch):
    if value is None:
        monkeypatch.delenv("RPT_COMPACT", raising=False)
    else:
        monkeypatch.setenv("RPT_COMPACT", value)
    picked = {}
    for name, pair in compiled.items():
        want = ref_int._auto_compact(pair[rpt_tpu][0], 3)
        got = port_int._auto_compact(pair[rpt_tpu_torch][0])
        assert got == want and type(got) is type(want), (name, got, want)
        picked[name] = got
    if not value:
        assert picked == {"instanced": "morton", "mesh": "morton", "sphere": False}


# ---------------------------------------------------------------------------
# The mode in the renderer's caches
# ---------------------------------------------------------------------------


def test_each_mode_has_its_own_cached_pass(compiled, monkeypatch):
    """The wavefront order is part of the pass's cache key: a render under
    another RPT_COMPACT gets its own entry (on the card, its own graph), and
    renders the masked render bit for bit."""
    sd, _ = compiled["instanced"][rpt_tpu_torch]
    cam = mesh_instances_scene(rpt_tpu_torch)[1]
    fns, sums = {}, {}
    for value in ("0", "1", "octant", "morton"):
        monkeypatch.setenv("RPT_COMPACT", value)
        fn = renderer_mod.make_render_many_fn(sd, 32, 24, 2)
        assert renderer_mod.make_render_many_fn(sd, 32, 24, 2) is fn
        key = (renderer_mod.scene_cache_key(sd), 32, 24, 2, port_int._auto_compact(sd))
        assert renderer_mod._MANY_CACHE.get(key) is fn and fn.compact == key[-1]
        assert renderer_mod._eager_render_many_fn(sd, 32, 24, 2).compact == key[-1]
        fns[value] = fn
        sums[value] = fn(cam, rnd.PRNGKey(SEED), 0, 1, 1e-3, 1.0)
    assert len({id(f) for f in fns.values()}) == 4
    for value in ("1", "octant", "morton"):
        assert torch.equal(sums[value][0], sums["0"][0]) and torch.equal(sums[value][1], sums["0"][1])


def test_depth_stats_are_the_same_in_every_mode(monkeypatch):
    scene, cam = mesh_instances_scene(rpt_tpu_torch)
    r = rpt_tpu_torch.Renderer(scene, cam, width=W, height=H, max_bounces=3, seed=SEED, device="cpu")
    stats = {}
    for value in ("0", "morton"):
        monkeypatch.setenv("RPT_COMPACT", value)
        stats[value] = depth_stats(r)
    for k in ("found_frac", "cont_frac"):
        np.testing.assert_array_equal(stats["morton"][k], stats["0"][k])
    assert stats["0"]["found_frac"].shape == (4,) and stats["0"]["cont_frac"][-1] > 0.0
