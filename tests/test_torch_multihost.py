"""Multi-process rendering and gradients of the port
(`rpt_tpu_torch.parallel`), the counterpart of `tests/test_multihost.py`:
two OS processes with two CPU shards each join over gloo, each renders its
own shards of the 4-shard global mesh, and all-gathers give both the whole
frame.

Renders: both processes must hold the same frame, bit for bit the port's
single-process render on 4 CPU shards (`render_distributed`,
`render_pass_sharded`, `make_sharded_render_fn`, `make_sharded_many_fn` in
two chunks), and within the render tolerance of `tests/test_torch_render.py`
of the reference's `render_multihost` on a 4-device mesh.

Gradients (`make_sharded_diff_fn` over the global mesh): both processes'
gradients are the same bits; each is within `MP_RTOL` of the largest |g|
per leaf (1e-6 in float32, 1e-12 in float64) of the port's in-process
gradient on 4 shards, which adds the shards in autograd's order where the
processes add their parts in rank order; and it agrees with `jax.grad` of
the reference's sharded gradient at `tests/test_torch_grad.py`'s bar,
in-process and across two JAX processes of 2 CPU devices each, whose own
gradient is held to the reference's in-process one within 1e-6 of max|g|.

This file is also the worker:

    python tests/test_torch_multihost.py <rank> <nproc> <port> <outdir> [<shards> [<mode>]]

`mode` is `render` (the default), `grad` (the gradient cases), `mismatch`
(rank 0's `color` requires grad and rank 1's does not) or `jax` (the
reference's gradient over its global mesh). It imports no JAX at module
level; only the `jax` workers import it.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

NPROC = 2
LOCAL_SHARDS = 2  # per process; the global mesh has 4
WORKER_TIMEOUT = 300
SEED = 3
W, H = 12, 8
BOUNCES = (0, 2)
FIELDS = ("color", "index", "roughness", "metallic", "emittance", "transparent")
# The multi-process gradient against the in-process one, over max|g| per leaf.
MP_RTOL = {"float32": 1e-6, "float64": 1e-12}


def make_renderer(pkg, **kw):
    """`tests/test_multihost.py`'s scene, in either package; identical in
    every process."""
    scene = pkg.Scene()
    scene.add(pkg.Object(pkg.sphere()).material(pkg.Material.specular(pkg.hex_color(0xB7410E), 0.3)))
    scene.add(pkg.Object(pkg.plane([0.0, 1.0, 0.0], -1.0)).material(pkg.Material.diffuse(pkg.hex_color(0xAAAAAA))))
    scene.add(pkg.ObjectLight(pkg.Object(pkg.sphere().scale([2.0, 2.0, 2.0]).translate([0.0, 12.0, 0.0]))
                              .material(pkg.Material.light(pkg.hex_color(0xFFFFFF), 40.0))))
    cam = pkg.Camera.look_at([-2.5, 4.0, 6.5], [0.0, -0.25, 0.0], [0.0, 1.0, 0.0], np.pi / 4)
    return pkg.Renderer(scene, cam, width=64, height=36, max_bounces=2, num_samples=3, **kw)


def grad_scene(pkg):
    """`tests/test_torch_grad.py`'s `fd_scene` and `fd_cam`, in either
    package (a copy: that file imports JAX)."""
    s = pkg.Scene()
    s.add(pkg.Object(pkg.sphere()).material(pkg.Material.specular(pkg.hex_color(0xCC2222), 0.35)))
    s.add(pkg.Object(pkg.plane([0.0, 1.0, 0.0], -1.0)).material(pkg.Material.diffuse(pkg.hex_color(0x888888))))
    s.add(pkg.PointLight((25.0, 25.0, 25.0), (3.0, 5.0, 4.0)))
    return s, pkg.Camera.look_at([0.0, 1.5, 6.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], np.pi / 5)


def grad_cases(mesh, dtype=torch.float32, fields=FIELDS) -> dict:
    """The port's gradient cases on `mesh`, as numpy: {case: image or
    {leaf: gradient}}. A leaf that gets no gradient (`transparent`, read
    only through `> 0.5`) has zeros."""
    import rpt_tpu_torch
    from rpt_tpu_torch import random as rnd
    from rpt_tpu_torch.materials import MaterialTable
    from rpt_tpu_torch.parallel import make_sharded_diff_fn

    scene, cam = grad_scene(rpt_tpu_torch)
    key, other = rnd.PRNGKey(SEED), rnd.PRNGKey(SEED + 1)
    out = {}

    def grads(sd, bounces, loss_of, tag):
        fn = make_sharded_diff_fn(sd, W, H, bounces, mesh)
        m = {f: getattr(sd.materials, f).detach().clone().requires_grad_(f in fields) for f in FIELDS}
        img = fn(MaterialTable(**m), cam, key, 1e-3, 1.0)
        loss_of(img, lambda k: fn(MaterialTable(**m), cam, k, 1e-3, 1.0)).backward()
        out[f"{tag}/image"] = img.detach().numpy()
        for f in fields:
            out[f"{tag}/{f}"] = (torch.zeros_like(m[f]) if m[f].grad is None else m[f].grad).detach().numpy()

    if dtype == torch.float64:
        grads(scene.compile(torch.float64, device="cpu"), 2, lambda img, again: torch.mean(img), "f64")
        return out
    sd = scene.compile(device="cpu")
    for b in BOUNCES:
        grads(sd, b, lambda img, again: torch.mean(img), f"mean{b}")
    # A loss on process 0's pixels alone (rows 0-1 are shard 0's 24 pixels).
    grads(sd, 2, lambda img, again: img[:2].sum(), "rows")
    # A loss over two calls with different keys.
    grads(sd, 2, lambda img, again: torch.mean(img) + torch.mean(again(other)), "two_calls")
    return out


def render_cases(mesh) -> dict:
    """`render_pass_sharded`, `make_sharded_render_fn` and
    `make_sharded_many_fn` (5 samples in one call, and in chunks of 2 and
    3 with `into=`) of the gradient scene on `mesh`, as numpy."""
    import rpt_tpu_torch
    from rpt_tpu_torch import random as rnd
    from rpt_tpu_torch.parallel import make_sharded_many_fn, make_sharded_render_fn, render_pass_sharded

    scene, cam = grad_scene(rpt_tpu_torch)
    sd = scene.compile(device="cpu")
    base = rnd.PRNGKey(SEED)
    key = rnd.fold_in(base, 7)
    fn = make_sharded_many_fn(sd, W, H, 2, mesh)
    whole = fn(cam, base, 0, 5, 1e-3, 1.0)
    chunked = fn(cam, base, 2, 3, 1e-3, 1.0, into=fn(cam, base, 0, 2, 1e-3, 1.0))
    return {"pass": render_pass_sharded(sd, cam, key, W, H, 2, 1e-3, 1.0, mesh).numpy(),
            "render_fn": make_sharded_render_fn(sd, W, H, 2, mesh)(cam, key, 1e-3, 1.0).numpy(),
            "many/sum": whole[0].numpy(), "many/sum_sq": whole[1].numpy(),
            "chunks/sum": chunked[0].numpy(), "chunks/sum_sq": chunked[1].numpy()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_workers(outdir, shards=(LOCAL_SHARDS,) * NPROC, mode="render") -> list:
    """Start one worker per entry of `shards` (its CPU shard count)."""
    os.makedirs(outdir, exist_ok=True)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(i), str(len(shards)), str(port),
                              str(outdir), str(n), mode], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for i, n in enumerate(shards)]


def wait_workers(procs) -> list:
    """Wait for the workers under WORKER_TIMEOUT; (return code, output) of
    each."""
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def run_workers(tmp_path, shards=(LOCAL_SHARDS,) * NPROC, mode="render") -> list:
    """Start the workers and wait for them: (return code, output) of each."""
    return wait_workers(start_workers(tmp_path, shards, mode))


def test_multiprocess_render_matches_single_process(tmp_path):
    import rpt_tpu_torch
    from rpt_tpu_torch.parallel import make_ray_mesh, render_distributed

    for rc, out in run_workers(tmp_path):
        assert rc == 0, f"worker failed:\n{out}"

    frames = [np.load(tmp_path / f"mh_{i}.npz") for i in range(NPROC)]
    for f in frames[1:]:
        np.testing.assert_array_equal(f["sum"], frames[0]["sum"])
        np.testing.assert_array_equal(f["sum_sq"], frames[0]["sum_sq"])
    assert int(frames[0]["count"]) == 3 and frames[0]["sum"].shape == (36, 64, 3)

    single = render_distributed(make_renderer(rpt_tpu_torch, device="cpu"),
                                make_ray_mesh(NPROC * LOCAL_SHARDS, device="cpu"))
    np.testing.assert_array_equal(single.sum.numpy(), frames[0]["sum"])
    np.testing.assert_array_equal(single.sum_sq.numpy(), frames[0]["sum_sq"])

    import rpt_tpu
    from rpt_tpu.parallel import make_ray_mesh as ref_make_ray_mesh
    from rpt_tpu.parallel.multihost import render_multihost as ref_render_multihost

    want = np.asarray(ref_render_multihost(make_renderer(rpt_tpu), mesh=ref_make_ray_mesh(4)).mean_image())
    got = frames[0]["sum"] / 3.0
    assert np.isfinite(got).all() and got.mean() > 0.01
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of pixels agree"
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())


def test_processes_with_other_shard_counts_raise(tmp_path):
    """The global mesh needs as many shards in every process (the SPMD
    contract): with 1 and 2, both processes raise at the mesh."""
    for rc, out in run_workers(tmp_path, shards=(1, 2)):
        assert rc != 0 and "every process must hold as many shards" in out, out


def test_grad_scene_is_the_gradient_tests_scene():
    """The workers' copy of `tests/test_torch_grad.py`'s scene and camera
    compiles to the same content."""
    import rpt_tpu_torch
    from test_torch_grad import fd_cam, fd_scene

    scene, cam = grad_scene(rpt_tpu_torch)
    got, want = scene.compile(device="cpu"), fd_scene(rpt_tpu_torch).compile(device="cpu")
    assert got.digest and got.digest == want.digest
    for f in ("eye", "direction", "up", "fov", "aperture", "focal_distance"):
        assert torch.equal(getattr(cam, f), getattr(fd_cam(rpt_tpu_torch), f)), f


@pytest.fixture(scope="module")
def grad_runs(tmp_path_factory):
    """Two port workers (`grad`) and two JAX workers (`jax`) at once, and,
    while they run, the same cases in this process: the port's on 4 CPU
    shards and `jax.grad` of the reference's on a 4-device mesh."""
    import jax
    import jax.numpy as jnp

    import rpt_tpu
    from rpt_tpu.parallel import make_ray_mesh as ref_make_ray_mesh
    from rpt_tpu.parallel import make_sharded_diff_fn as ref_make_sharded_diff_fn
    from rpt_tpu_torch.parallel import make_ray_mesh

    out = tmp_path_factory.mktemp("grad_runs")
    procs = start_workers(out, mode="grad") + start_workers(out, mode="jax")
    try:
        mesh = make_ray_mesh(NPROC * LOCAL_SHARDS, device="cpu")
        in_process = {**grad_cases(mesh), **grad_cases(mesh, torch.float64), **render_cases(mesh)}
        scene, cam = grad_scene(rpt_tpu)
        sd = scene.compile()
        ref = {}
        for b in BOUNCES:
            fn = ref_make_sharded_diff_fn(sd, W, H, b, ref_make_ray_mesh(NPROC * LOCAL_SHARDS))
            key = jnp.asarray(np.array([0, SEED], np.uint32))
            g = jax.grad(lambda m: jnp.mean(fn(m, cam, key, jnp.float32(1e-3), jnp.float32(1.0))))(sd.materials)
            ref.update({f"mean{b}/{f}": np.asarray(getattr(g, f)) for f in FIELDS})
    finally:
        results = wait_workers(procs)
    for rc, text in results:
        assert rc == 0, f"worker failed:\n{text}"
    load = lambda name: [dict(np.load(out / f"{name}_{i}.npz")) for i in range(NPROC)]
    return dict(port=load("grad"), jax=load("jax"), in_process=in_process, ref=ref)


def assert_processes_equal(runs: list, keys) -> None:
    for k in keys:
        for r in runs[1:]:
            np.testing.assert_array_equal(r[k], runs[0][k], err_msg=k)


def assert_near_in_process(got: dict, want: dict, tag: str) -> None:
    """Every leaf of case `tag` within MP_RTOL of the largest |g| of the
    in-process gradient; a leaf with no gradient in-process has zeros."""
    for f in FIELDS:
        g, w = got[f"{tag}/{f}"], want[f"{tag}/{f}"]
        assert g.dtype == w.dtype and g.shape == w.shape, f
        scale = float(np.abs(w).max())
        if scale == 0:
            assert not np.any(g), f
            continue
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= MP_RTOL[str(w.dtype)] * scale, f"{tag}/{f}: {err:.3e} > {MP_RTOL[str(w.dtype)]} x {scale:.3e}"


@pytest.mark.parametrize("bounces", BOUNCES)
def test_multiprocess_sharded_gradient_matches_reference(grad_runs, bounces):
    """d mean(image) / d every material leaf over 2 processes x 2 CPU
    shards: the same bits on both processes, the frame bit for bit the
    in-process 4-shard frame, the gradient within MP_RTOL of the
    in-process one and at `assert_grad_agrees`'s bar of `jax.grad` of the
    reference's on a 4-device mesh."""
    from test_torch_grad import assert_grad_agrees

    port, tag = grad_runs["port"], f"mean{bounces}"
    assert_processes_equal(port, [f"{tag}/{f}" for f in ("image", *FIELDS)])
    np.testing.assert_array_equal(port[0][f"{tag}/image"], grad_runs["in_process"][f"{tag}/image"])
    assert_near_in_process(port[0], grad_runs["in_process"], tag)
    ref = grad_runs["ref"]
    assert any(np.abs(ref[f"{tag}/{f}"]).max() > 0 for f in FIELDS)
    for f in FIELDS:
        want = ref[f"{tag}/{f}"]
        if np.abs(want).max() > 0:
            assert_grad_agrees(port[0][f"{tag}/{f}"], want, bounces, f)
        else:
            assert not np.any(port[0][f"{tag}/{f}"]), f


@pytest.mark.parametrize("bounces", BOUNCES)
def test_reference_multiprocess_sharded_gradient(grad_runs, bounces):
    """What the reference does across processes: two JAX processes of 2
    CPU devices each take `jax.grad` of its `make_sharded_diff_fn` over
    the global mesh. Both get the same gradient, within 1e-6 of max|g| of
    its in-process 4-device gradient (the cross-process psum adds in
    another order), and the port's multi-process gradient agrees with it
    at `assert_grad_agrees`'s bar."""
    from test_torch_grad import assert_grad_agrees

    runs, tag = grad_runs["jax"], f"mean{bounces}"
    assert_processes_equal(runs, [f"{tag}/{f}" for f in FIELDS])
    for f in FIELDS:
        got, want = runs[0][f"{tag}/{f}"], grad_runs["ref"][f"{tag}/{f}"]
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= 1e-6 * scale, f
        if scale > 0:
            assert_grad_agrees(grad_runs["port"][0][f"{tag}/{f}"], got, bounces, f)


@pytest.mark.parametrize("case", ["rows", "two_calls"])
def test_multiprocess_gradient_of_other_losses(grad_runs, case):
    """`rows`: a loss on process 0's pixels alone (`img[:2].sum()`), so
    process 1's frame gets a zero gradient and its backward must still
    reach the gather; `two_calls`: a loss over two calls with different
    keys, two gathers in one backward. Both processes the same bits,
    within MP_RTOL of the in-process gradient."""
    port = grad_runs["port"]
    assert_processes_equal(port, [f"{case}/{f}" for f in ("image", *FIELDS)])
    assert_near_in_process(port[0], grad_runs["in_process"], case)
    assert np.abs(port[0][f"{case}/color"]).max() > 0


def test_multiprocess_float64_gradient(grad_runs):
    """A float64 scene and table: both processes the same bits, within
    1e-12 of max|g| of the in-process float64 gradient."""
    port = grad_runs["port"]
    assert port[0]["f64/color"].dtype == np.float64
    assert_processes_equal(port, [f"f64/{f}" for f in ("image", *FIELDS)])
    assert_near_in_process(port[0], grad_runs["in_process"], "f64")


@pytest.mark.parametrize("case", ["pass", "render_fn", "many", "chunks"])
def test_multiprocess_sharded_renders_equal_in_process(grad_runs, case):
    """`render_pass_sharded`, `make_sharded_render_fn`, and
    `make_sharded_many_fn` in one call and in two chunks with `into=` over
    the global mesh: both processes hold the whole frame, bit for bit the
    in-process 4-shard call's (and the chunks the one call's)."""
    port, want = grad_runs["port"], grad_runs["in_process"]
    keys = [case] if case in ("pass", "render_fn") else [f"{case}/sum", f"{case}/sum_sq"]
    assert_processes_equal(port, keys)
    for k in keys:
        assert port[0][k].shape[:2] == (H, W)
        np.testing.assert_array_equal(port[0][k], want[k])
    if case == "chunks":
        np.testing.assert_array_equal(port[0]["chunks/sum"], port[0]["many/sum"])


def test_processes_that_differ_in_leaves_raise(tmp_path):
    """Process 0's `color` requires grad and process 1's does not: both
    raise at the call, before any gather, instead of waiting for each
    other."""
    for rc, out in run_workers(tmp_path, mode="mismatch"):
        assert rc != 0 and "every process must call with the same" in out, out


def test_init_multihost_single_process_noop(monkeypatch):
    """No cluster environment and no arguments: nothing joins; the global
    mesh is every card (none here: it raises), or the shards noted; a
    single-process mesh renders as `render_distributed`, bit for bit."""
    import torch.distributed as dist

    import rpt_tpu_torch
    from rpt_tpu_torch.parallel import (
        init_multihost, is_multihost, make_global_ray_mesh, make_ray_mesh, render_distributed, render_multihost,
    )
    from rpt_tpu_torch.parallel import multihost

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setitem(multihost._LOCAL, "devices", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    init_multihost()
    assert not dist.is_initialized() and not is_multihost()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_global_ray_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        render_multihost(make_renderer(rpt_tpu_torch, device="cpu"))
    init_multihost(local_device_ids=["cpu", "cpu"])
    mesh = make_global_ray_mesh()
    assert mesh == make_ray_mesh(2, device="cpu") and not dist.is_initialized()
    r = make_renderer(rpt_tpu_torch, device="cpu")
    got, want = render_multihost(r), render_distributed(r, mesh)
    assert torch.equal(got.sum, want.sum) and torch.equal(got.sum_sq, want.sum_sq)


def test_init_multihost_raises_when_a_process_cannot_join():
    """Process 0 cannot listen on a port that is taken; a process id
    outside the run is refused before it waits."""
    from rpt_tpu_torch.parallel import init_multihost, is_multihost

    with socket.socket() as s:
        s.bind(("localhost", 0))
        s.listen()
        with pytest.raises(RuntimeError, match="failed to join"):
            init_multihost(f"localhost:{s.getsockname()[1]}", 2, 0, local_device_ids=["cpu"])
    with pytest.raises(ValueError, match="process_id 5"):
        init_multihost(f"localhost:{_free_port()}", 2, 5, local_device_ids=["cpu"])
    assert not is_multihost()


def _jax_worker(rank: int, nproc: int, port: str, outdir: str, shards: int) -> None:
    """The reference's `make_sharded_diff_fn` over its global mesh (`shards`
    CPU devices a process), its inputs replicated by `multihost._replicate`:
    d mean(image) / d every material leaf at each of BOUNCES."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={shards}"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    import rpt_tpu
    from rpt_tpu.parallel import make_sharded_diff_fn
    from rpt_tpu.parallel.multihost import _replicate, init_multihost, make_global_ray_mesh

    init_multihost(coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=rank)
    assert len(jax.devices()) == nproc * shards and len(jax.local_devices()) == shards
    mesh = make_global_ray_mesh()
    scene, cam = grad_scene(rpt_tpu)
    sd = scene.compile()
    key = jnp.asarray(np.array([0, SEED], np.uint32))
    out = {}
    for b in BOUNCES:
        fn = make_sharded_diff_fn(sd, W, H, b, mesh)
        mats, camera, k, t_min, ev = _replicate((sd.materials, cam, key, jnp.float32(1e-3), jnp.float32(1.0)), mesh)
        g = jax.grad(lambda m: jnp.mean(fn(m, camera, k, t_min, ev)))(mats)
        for f in FIELDS:
            out[f"mean{b}/{f}"] = np.asarray(multihost_utils.process_allgather(getattr(g, f), tiled=True))
    np.savez(os.path.join(outdir, f"jax_{rank}.npz"), **out)
    print(f"[jax worker {rank}] done", flush=True)


def _worker(rank: int, nproc: int, port: str, outdir: str, shards: int, mode: str) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if mode == "jax":
        return _jax_worker(rank, nproc, port, outdir, shards)
    import torch.distributed as dist

    import rpt_tpu_torch
    from rpt_tpu_torch.parallel import init_multihost, is_multihost, make_global_ray_mesh, render_multihost

    init_multihost(f"localhost:{port}", nproc, rank, local_device_ids=["cpu"] * shards)
    init_multihost(f"localhost:{port}", nproc, rank, local_device_ids=["cpu"] * shards)  # idempotent
    assert is_multihost()
    try:
        mesh = make_global_ray_mesh()
        assert mesh.size == nproc * shards and mesh.rank == rank and mesh.world_size == nproc
        assert mesh.local == tuple(range(rank * shards, (rank + 1) * shards))
        if mode == "render":
            buf = render_multihost(make_renderer(rpt_tpu_torch, device="cpu"))
            np.savez(os.path.join(outdir, f"mh_{rank}.npz"), sum=buf.sum.numpy(), sum_sq=buf.sum_sq.numpy(),
                     count=np.asarray(buf.count))
        elif mode == "grad":
            np.savez(os.path.join(outdir, f"grad_{rank}.npz"),
                     **grad_cases(mesh), **grad_cases(mesh, torch.float64), **render_cases(mesh))
        elif mode == "mismatch":
            grad_cases(mesh, fields=FIELDS if rank == 0 else ("index",))
        else:
            raise ValueError(f"no worker mode {mode!r}")
    except (ValueError, RuntimeError):
        dist.destroy_process_group()
        raise
    dist.destroy_process_group()
    print(f"[worker {rank}] done", flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            int(sys.argv[5]) if len(sys.argv) > 5 else LOCAL_SHARDS, sys.argv[6] if len(sys.argv) > 6 else "render")
