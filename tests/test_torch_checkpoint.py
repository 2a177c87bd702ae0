"""Checkpoint and resume of the port (`tests/test_checkpoint.py` of the JAX
package, run through `rpt_tpu_torch`): an interrupted render resumes bit
for bit, a checkpoint of another seed is refused, and a checkpoint written
by either package loads in the other with equal arrays."""

import numpy as np
import pytest
import torch

import rpt_tpu
import rpt_tpu_torch


def _scene(pkg):
    s = pkg.Scene()
    s.add(pkg.Object(pkg.sphere()).material(pkg.Material.diffuse(pkg.hex_color(0xBB4444))))
    s.add(pkg.Object(pkg.plane([0.0, 1.0, 0.0], -1.0)).material(pkg.Material.diffuse(pkg.hex_color(0x999999))))
    s.add(pkg.PointLight((40.0, 40.0, 40.0), (2.0, 6.0, 3.0)))
    return s


def _renderer(n, seed=11):
    return rpt_tpu_torch.Renderer(_scene(rpt_tpu_torch), width=32, height=24, max_bounces=1, num_samples=n,
                                  seed=seed, device="cpu")


class Stop(Exception):
    pass


def test_resume_bit_identical(tmp_path):
    ck = str(tmp_path / "render.ckpt.npz")
    seen = []
    full = _renderer(6).iterative_render(2, lambda i, b: seen.append(i))
    assert seen == [2, 4, 6]

    def stopper(i, b):
        if i >= 4:
            raise Stop()

    with pytest.raises(Stop):
        _renderer(6).iterative_render(2, stopper, checkpoint_path=ck)
    buf, seed, iteration = rpt_tpu_torch.Buffer.load(ck, device="cpu")
    assert seed == 11 and iteration == 4 and buf.count == 4

    resumed = _renderer(6).iterative_render(2, lambda i, b: None, checkpoint_path=ck)
    assert torch.equal(resumed.sum, full.sum) and torch.equal(resumed.sum_sq, full.sum_sq)
    assert resumed.count == full.count == 6
    # And equal to one render of all six samples.
    whole = _renderer(6).render_buffer()
    assert torch.equal(whole.sum, full.sum) and torch.equal(whole.sum_sq, full.sum_sq)


def test_seed_mismatch_rejected(tmp_path):
    ck = str(tmp_path / "render.ckpt.npz")
    _renderer(2).iterative_render(2, lambda i, b: None, checkpoint_path=ck)
    with pytest.raises(ValueError, match="checkpoint seed"):
        _renderer(4, seed=999).iterative_render(2, lambda i, b: None, checkpoint_path=ck)


def test_checkpoints_load_across_packages(tmp_path):
    """The JAX package's checkpoint loads in the port and the port's in the
    JAX package, array for array; the port resumes the JAX package's render
    to within the render tolerance of its own."""
    ref_ck, port_ck = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref = rpt_tpu.Renderer(_scene(rpt_tpu), width=32, height=24, max_bounces=1, num_samples=2, seed=11)
    ref_buf = ref.iterative_render(2, lambda i, b: None, checkpoint_path=ref_ck)
    buf, seed, iteration = rpt_tpu_torch.Buffer.load(ref_ck, device="cpu")
    assert (seed, iteration, buf.count) == (11, 2, 2)
    np.testing.assert_array_equal(buf.sum.numpy(), np.asarray(ref_buf.sum))
    np.testing.assert_array_equal(buf.sum_sq.numpy(), np.asarray(ref_buf.sum_sq))

    port_buf = _renderer(2).iterative_render(2, lambda i, b: None, checkpoint_path=port_ck)
    back, seed, iteration = rpt_tpu.Buffer.load(port_ck)
    assert (seed, iteration, int(back.count)) == (11, 2, 2)
    np.testing.assert_array_equal(np.asarray(back.sum), port_buf.sum.numpy())
    np.testing.assert_array_equal(np.asarray(back.sum_sq), port_buf.sum_sq.numpy())

    # The port picks up where the JAX package stopped.
    resumed = _renderer(4).iterative_render(2, lambda i, b: None, checkpoint_path=ref_ck)
    own = _renderer(4).render_buffer()
    assert resumed.count == 4
    got, want = resumed.mean_image().numpy(), own.mean_image().numpy()
    assert np.isclose(got, want, rtol=1e-3, atol=1e-4).all(-1).mean() >= 0.99


def test_load_defaults_to_the_card(tmp_path, monkeypatch):
    ck = str(tmp_path / "render.ckpt.npz")
    _renderer(1).iterative_render(1, lambda i, b: None, checkpoint_path=ck)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rpt_tpu_torch.Buffer.load(ck)
