"""The port's OBJ+MTL loading against the JAX package's.

Mirrors `tests/test_native_obj.py` (apart from its test of an asset that is
not in the repository): the port's native parser against its own Python
semantics oracle, paths and file objects, usemtl groups; then both
packages' loaders on the same text, the toy brick plane of
`examples/lego.py` included: equal vertex and normal arrays, equal material
fields.
"""

import dataclasses
import io

import numpy as np
import pytest

from rpt_tpu.io import obj as ref_obj
from rpt_tpu.native import parse_obj as ref_parse_obj
from rpt_tpu_torch import load_obj, load_obj_with_mtl
from rpt_tpu_torch.io.obj import _load_obj_py, _load_obj_with_mtl_py, load_mtl
from rpt_tpu_torch.native import parse_obj
from rpt_tpu_torch.scenes import TOY_MTL, toy_plane_obj
from test_torch_reference_native import reference_native

reference_native()

OBJ = """
# comment
v 0 0 0
v 1 0 0
v 0 1 0
v 1.5 -2.25e-1 3
vn 0 0 1
vn 0 1 0
vt 0.5 0.5
f 1 2 3
f 1//1 2//1 3//2
f -4 -3 -2 -1
usemtl red
f 1 2 4
usemtl blue
f 2/1/1 3//2 4//1
usemtl red
f 1 3 4
"""
MTL = "newmtl red\nKd 0.7 0 0\nNs 96\nnewmtl blue\nKd 0 0 0.7\nNi 1.33\nd 0.5\n"


def _material_fields(m):
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}


def test_native_matches_python_parser():
    verts, norms, run, names = parse_obj(OBJ.encode())
    mesh = _load_obj_py(OBJ)
    np.testing.assert_allclose(verts, np.asarray(mesh.vertices), rtol=1e-12)
    np.testing.assert_allclose(norms, np.asarray(mesh.normals), rtol=1e-12)
    # 2 tri faces + 1 quad (2 fan tris) + 3 single-tri usemtl runs = 7
    assert verts.shape[0] == 7
    assert names == ["red", "blue", "red"]
    assert run.tolist() == [0, 0, 0, 0, 1, 2, 3]


@pytest.mark.parametrize("text", [OBJ, toy_plane_obj()], ids=["small", "toy_plane"])
def test_native_parser_matches_reference(text):
    got, want = parse_obj(text.encode()), ref_parse_obj(text.encode())
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


def test_malformed_face_raises():
    with pytest.raises(ValueError):
        parse_obj(b"v 0 0 0\nf 1 2 x\n")


def test_load_obj_filelike_and_path(tmp_path):
    p = tmp_path / "m.obj"
    p.write_text(OBJ)
    m1 = load_obj(str(p))
    m2 = load_obj(io.StringIO(OBJ))
    np.testing.assert_allclose(np.asarray(m1.vertices), np.asarray(m2.vertices))
    want = ref_obj.load_obj(io.StringIO(OBJ))
    np.testing.assert_array_equal(np.asarray(m1.vertices), np.asarray(want.vertices))
    np.testing.assert_array_equal(np.asarray(m1.normals), np.asarray(want.normals))


def test_load_obj_with_mtl_groups(tmp_path):
    mtl = tmp_path / "m.mtl"
    mtl.write_text(MTL)
    obj = tmp_path / "m.obj"
    obj.write_text(OBJ)
    objs = load_obj_with_mtl(str(obj), str(mtl))
    # default-material group (4 tris) + red + blue + red
    assert len(objs) == 4
    assert [np.asarray(o.shape.vertices).shape[0] for o in objs] == [4, 1, 1, 1]
    assert float(objs[1].mat.color[0]) > 0.5  # red Kd
    # The Python oracle splits the same groups (it merges no runs either).
    oracle = _load_obj_with_mtl_py(OBJ, load_mtl(io.StringIO(MTL)))
    assert [np.asarray(o.shape.vertices).shape[0] for o in oracle] == [4, 1, 1, 1]


def test_load_mtl_matches_reference():
    got, want = load_mtl(io.StringIO(MTL + TOY_MTL)), ref_obj.load_mtl(io.StringIO(MTL + TOY_MTL))
    assert list(got) == list(want)
    for name in want:
        assert _material_fields(got[name]) == _material_fields(want[name]), name
    assert got["blue"].transparent and got["window"].transparent and not got["red"].transparent


def test_toy_plane_objects_match_reference():
    """The toy plane's OBJ+MTL text through both packages: the same four
    objects (one per usemtl run), vertex and normal arrays equal, material
    fields equal."""
    got = load_obj_with_mtl(io.StringIO(toy_plane_obj()), io.StringIO(TOY_MTL))
    want = ref_obj.load_obj_with_mtl(io.StringIO(toy_plane_obj()), io.StringIO(TOY_MTL))
    assert len(got) == len(want) == 4
    assert sum(o.shape.num_triangles for o in got) == 108
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.shape.vertices), np.asarray(w.shape.vertices))
        np.testing.assert_array_equal(np.asarray(g.shape.normals), np.asarray(w.shape.normals))
        assert _material_fields(g.mat) == _material_fields(w.mat)
