"""Multi-process rendering of the port (`rpt_tpu_torch.parallel.multihost`),
the counterpart of `tests/test_multihost.py`: two OS processes with two CPU
shards each join over gloo, each renders its own shards of the 4-shard
global mesh, and one all-gather per sum gives both the whole frame.

Both processes must hold the same frame, bit for bit the port's
single-process `render_distributed` on 4 CPU shards, and within the render
tolerance of `tests/test_torch_render.py` of the reference's
`render_multihost` on a 4-device mesh. This file is also the worker:

    python tests/test_torch_multihost.py <rank> <nproc> <port> <outdir> [<shards>]

It imports no JAX at module level (the workers never do).
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(tmp_path, shards=(LOCAL_SHARDS,) * NPROC) -> list:
    """Start one worker per entry of `shards` (its CPU shard count), wait
    for them under WORKER_TIMEOUT; (return code, output) of each."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(i), str(len(shards)), str(port),
                               str(tmp_path), str(n)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for i, n in enumerate(shards)]
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    return [(p.returncode, out) for p, out in zip(procs, outs)]


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


def _worker(rank: int, nproc: int, port: str, outdir: str, shards: int) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch.distributed as dist

    import rpt_tpu_torch
    from rpt_tpu_torch.parallel import init_multihost, is_multihost, make_global_ray_mesh, render_multihost

    init_multihost(f"localhost:{port}", nproc, rank, local_device_ids=["cpu"] * shards)
    init_multihost(f"localhost:{port}", nproc, rank, local_device_ids=["cpu"] * shards)  # idempotent
    assert is_multihost()
    try:
        mesh = make_global_ray_mesh()
    except ValueError:
        dist.destroy_process_group()
        raise
    assert mesh.size == nproc * shards and mesh.rank == rank and mesh.world_size == nproc
    assert mesh.local == tuple(range(rank * shards, (rank + 1) * shards))
    buf = render_multihost(make_renderer(rpt_tpu_torch, device="cpu"))
    np.savez(os.path.join(outdir, f"mh_{rank}.npz"), sum=buf.sum.numpy(), sum_sq=buf.sum_sq.numpy(),
             count=np.asarray(buf.count))
    dist.destroy_process_group()
    print(f"[worker {rank}] done", flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            int(sys.argv[5]) if len(sys.argv) > 5 else LOCAL_SHARDS)
