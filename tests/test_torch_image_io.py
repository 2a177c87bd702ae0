"""The port's image and STL IO, `Buffer.new`'s arguments and the public
names, against the JAX package.

Mirrors `tests/test_hdri.py` (the RGBE round trip) and the STL cases of
`tests/test_bvh_io.py` (their input built in memory): a .hdr written by
either package loads in the port as the reference loads it, bit for bit; a
new-RLE scanline built here decodes to its bytes; `save_png`, written with
the standard library alone, decodes in PIL to the same pixels; binary and
ASCII STL, from file objects and paths, give the reference's Mesh arrays.
"""

import io

import numpy as np
import pytest
import torch

import rpt_tpu
import rpt_tpu_torch
from rpt_tpu.io import image as ref_image
from rpt_tpu.io import stl as ref_stl
from rpt_tpu_torch import Buffer, load_stl
from rpt_tpu_torch.io import load_hdr, save_hdr, save_png
from test_bvh_io import make_binary_stl
from test_hdri import _test_image


def test_hdr_round_trip(tmp_path):
    img = _test_image()
    p = tmp_path / "fixture.hdr"
    save_hdr(p, img)
    back = load_hdr(p)
    assert back.shape == img.shape and back.dtype == np.float32
    # One 8-bit exponent per pixel: error <= maxc/256 + an lsb.
    maxc = np.broadcast_to(img.max(axis=-1, keepdims=True), img.shape)
    np.testing.assert_array_less(np.abs(back - img), maxc / 255.0 + 1e-6)
    assert (back[0, 0] == 0).all()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_hdr_files_load_as_the_reference_loads_them(tmp_path, writer):
    img = _test_image(h=12, w=24, seed=5)
    p = tmp_path / "env.hdr"
    (ref_image.save_hdr if writer == "reference" else save_hdr)(p, img)
    want = ref_image.load_hdr(p)
    got = load_hdr(p)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # Both writers write the same bytes.
    q = tmp_path / "other.hdr"
    (save_hdr if writer == "reference" else ref_image.save_hdr)(q, img)
    assert p.read_bytes() == q.read_bytes()


def _rle_channel(values: np.ndarray) -> bytes:
    """One channel of a new-RLE scanline: a run of the first 5 equal bytes
    (0x80 + 5), then the rest as dumps of at most 128 bytes."""
    out = bytearray([128 + 5, values[0]])
    rest = values[5:]
    for s in range(0, len(rest), 128):
        chunk = rest[s:s + 128]
        out += bytes([len(chunk)]) + bytes(chunk.tolist())
    return bytes(out)


def test_new_rle_scanlines_decode(tmp_path):
    h, w = 3, 140  # wider than one 128-byte dump
    rng = np.random.default_rng(2)
    rgbe = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, (h, w))
    rgbe[:, :5] = rgbe[:, :1]  # each channel starts with a run of 5
    body = bytearray()
    for y in range(h - 1):
        body += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            body += _rle_channel(rgbe[y, :, c])
    body += rgbe[h - 1].tobytes()  # the last scanline flat
    p = tmp_path / "rle.hdr"
    p.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode() + bytes(body))
    got = load_hdr(p)
    np.testing.assert_array_equal(got, ref_image._decode_rgbe(rgbe))
    np.testing.assert_array_equal(got, ref_image.load_hdr(p))


def test_load_hdr_refuses_other_files(tmp_path):
    p = tmp_path / "bad.hdr"
    p.write_bytes(b"P6\n1 1\n255\n\0\0\0")
    with pytest.raises(ValueError):
        load_hdr(p)


def test_save_png_decodes_to_the_same_pixels(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (13, 21, 3), dtype=np.uint8)
    p = tmp_path / "out.png"
    save_png(p, img)
    with Image.open(p) as im:
        assert im.mode == "RGB" and im.size == (21, 13)
        np.testing.assert_array_equal(np.asarray(im), img)


def _assert_same_mesh(got, want):
    assert type(got).__name__ == type(want).__name__ == "Mesh"
    assert got.vertices.dtype == want.vertices.dtype == np.float64
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.normals, want.normals)


STL_TRIS = [
    ((0, 0, 1), (0, 0, 0), (1, 0, 0), (0, 1, 0)),
    ((0, 1, 0), (0, 0, 0), (0, 0, 1), (1, 0, 0)),
    ((0.6, 0.0, 0.8), (0.25, -1.5, 3.0), (1e-3, 2.0, -4.5), (7.0, 0.125, 0.5)),
]
STL_ASCII = b"""solid test
facet normal 0 0 1
outer loop
vertex 0 0 0
vertex 1 0 0
vertex 0 1 0
endloop
endfacet
  facet normal 0.6 0 -0.8
    outer loop
      vertex 0.25 -1.5 3
      vertex 1e-3 2.0 -4.5
      vertex 7 0.125 0.5
    endloop
  endfacet
endsolid test
"""


@pytest.mark.parametrize("source", ["file_object", "path"])
@pytest.mark.parametrize("kind", ["binary", "ascii"])
def test_load_stl_matches_reference(tmp_path, kind, source):
    data = make_binary_stl(STL_TRIS) if kind == "binary" else STL_ASCII
    if source == "path":
        p = tmp_path / "mesh.stl"
        p.write_bytes(data)
        got, want = load_stl(p), ref_stl.load_stl(p)
    else:
        got, want = load_stl(io.BytesIO(data)), ref_stl.load_stl(io.BytesIO(data))
    _assert_same_mesh(got, want)
    assert got.num_triangles == (3 if kind == "binary" else 2)
    np.testing.assert_allclose(got.normals[0], [[0, 0, 1]] * 3)


def test_load_stl_refuses_what_it_cannot_read():
    with pytest.raises(ValueError, match="too short"):
        load_stl(io.BytesIO(b"solid x\n"))
    with pytest.raises(ValueError, match="determine format"):
        load_stl(io.BytesIO(b"\1" * 100))
    # A binary file's size is what tells it apart: one byte more is not binary.
    with pytest.raises(ValueError):
        load_stl(io.BytesIO(make_binary_stl(STL_TRIS) + b"\0"))


def test_stl_mesh_compiles_in_both_packages():
    """An STL mesh in a scene, as `examples/cylinder.py` uses one: both
    packages' compiled triangles are the same."""
    data = make_binary_stl([((0, 0, 1), (0, 0, 0), (1, 0, 0), (0, 1, 0))] * 2)
    ref_scene, port_scene = rpt_tpu.Scene(), rpt_tpu_torch.Scene()
    ref_scene.add(rpt_tpu.Object(ref_stl.load_stl(io.BytesIO(data)).translate([0.0, 0.0, -1.0])))
    port_scene.add(rpt_tpu_torch.Object(load_stl(io.BytesIO(data)).translate([0.0, 0.0, -1.0])))
    want = np.asarray(ref_scene.compile().triangles.verts)
    got = port_scene.compile(device="cpu").triangles.verts.numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_buffer_new_takes_the_dtype_third(dtype):
    """`Buffer.new(width, height, dtype)`, the reference's signature."""
    buf = Buffer.new(2, 3, dtype, device="cpu")
    assert buf.sum.shape == (3, 2, 3) and buf.sum.dtype == dtype and buf.sum_sq.dtype == dtype
    assert buf.count == 0 and not bool(buf.sum.any())
    assert Buffer.new(2, 2, torch.float64, device="cpu").sum.dtype == torch.float64


def test_public_names_are_the_reference_names():
    assert set(rpt_tpu_torch.__all__) == set(rpt_tpu.__all__)
    for name in rpt_tpu_torch.__all__:
        assert getattr(rpt_tpu_torch, name) is not None
    assert rpt_tpu_torch.monomial_surface(2.0).height == 2.0
    assert isinstance(rpt_tpu_torch.monomial_surface(2.0), rpt_tpu_torch.MonomialSurface)
