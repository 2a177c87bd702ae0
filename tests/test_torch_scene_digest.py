"""The scene's content digest (`scene._scene_digest`) and the native hash of
its large leaves (`native.hash128`, MurmurHash3_x64_128 with seed 0).

Every mesh's vertices and normals (as float64) and the HDRI map (in its own
dtype) go through the native hash, read in place; its 16 bytes go into the
blake2b stream after the leaf's tag. So the digest still reads every byte:
one ulp of one leaf changes it, equal content digests equal wherever it
lives, sharing stays in the key, the span counts every byte fed
(`bytes`) and the leaves' alone (`leaf_bytes`), and an in-place edit of a
mesh recompiles and renders anew. No fallback: without g++ it raises.
"""

import math
import os

import numpy as np
import pytest

import rpt_tpu_torch
from rpt_tpu_torch import Camera, Environment, Material, Object, Renderer, Scene, native, profiling
from rpt_tpu_torch.scene import _scene_digest
from rpt_tpu_torch.scenes import procedural_sky, trefoil_mesh
from rpt_tpu_torch.shapes import Mesh

FOX = b"The quick brown fox jumps over the lazy dog"
MASK = (1 << 64) - 1


def _murmur3_x64_128(data: bytes) -> bytes:
    """The algorithm in plain Python (SMHasher's MurmurHash3_x64_128, seed
    0), the yardstick for every tail length."""

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & MASK

    def fmix(k):
        k ^= k >> 33
        k = (k * 0xFF51AFD7ED558CCD) & MASK
        k ^= k >> 33
        k = (k * 0xC4CEB9FE1A85EC53) & MASK
        return k ^ (k >> 33)

    c1, c2 = 0x87C37B91114253D5, 0x4CF5AD432745937F
    h1 = h2 = 0
    n = len(data) // 16
    for i in range(n):
        k1 = int.from_bytes(data[16 * i:16 * i + 8], "little")
        k2 = int.from_bytes(data[16 * i + 8:16 * i + 16], "little")
        h1 ^= (rotl((k1 * c1) & MASK, 31) * c2) & MASK
        h1 = (rotl(h1, 27) + h2) & MASK
        h1 = (h1 * 5 + 0x52DCE729) & MASK
        h2 ^= (rotl((k2 * c2) & MASK, 33) * c1) & MASK
        h2 = (rotl(h2, 31) + h1) & MASK
        h2 = (h2 * 5 + 0x38495AB5) & MASK
    tail = data[16 * n:]
    if len(tail) > 8:
        k2 = int.from_bytes(tail[8:], "little")
        h2 ^= (rotl((k2 * c2) & MASK, 33) * c1) & MASK
    if tail:
        k1 = int.from_bytes(tail[:8], "little")
        h1 ^= (rotl((k1 * c1) & MASK, 31) * c2) & MASK
    h1 ^= len(data)
    h2 ^= len(data)
    h1 = (h1 + h2) & MASK
    h2 = (h2 + h1) & MASK
    h1, h2 = fmix(h1), fmix(h2)
    h1 = (h1 + h2) & MASK
    h2 = (h2 + h1) & MASK
    return h1.to_bytes(8, "little") + h2.to_bytes(8, "little")


def _bytes(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8)


def _scene(mesh=None, sky=None) -> Scene:
    """A small trefoil under a small sky, one mesh object, no transform."""
    scene = Scene()
    scene.set_environment(Environment.from_hdri(procedural_sky(8) if sky is None else sky))
    scene.add(Object(trefoil_mesh(12, 4) if mesh is None else mesh).material(
        Material.transparent_colored(rpt_tpu_torch.hex_color(0xF8F8FF), 1.31, 0.2)))
    return scene


@pytest.mark.parametrize("data, want", [
    (FOX, "6c1b07bc7bbc4be347939ac4a93c437a"),  # the published vector
    (b"", "00" * 16),
])
def test_hash128_gives_the_published_values(data, want):
    assert native.hash128(_bytes(data)).hex() == want


@pytest.mark.parametrize("n", [1, 7, 8, 9, 15, 16, 17, 24, 31, 32, 33, 100])
def test_hash128_is_the_algorithm_at_every_tail_length(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert native.hash128(_bytes(data)) == _murmur3_x64_128(data)


def test_hash128_takes_only_a_contiguous_array():
    with pytest.raises(ValueError, match="C-contiguous"):
        native.hash128(np.zeros((4, 4))[:, ::2])
    with pytest.raises(ValueError, match="C-contiguous"):
        native.hash128(FOX)


@pytest.mark.parametrize("leaf", ["vertex", "normal", "texel"])
def test_one_ulp_of_one_leaf_changes_the_digest(leaf):
    mesh = trefoil_mesh(12, 4)
    sky = procedural_sky(8)
    before = _scene_digest(_scene(mesh, sky))
    arr, index = {"vertex": (mesh.vertices, (5, 1, 2)), "normal": (mesh.normals, (17, 2, 0)),
                  "texel": (sky, (3, 9, 1))}[leaf]
    arr[index] = np.nextafter(arr[index], np.inf)
    assert _scene_digest(_scene(mesh, sky)) != before


def test_equal_content_in_separate_arrays_digests_equal():
    a, b = trefoil_mesh(12, 4), trefoil_mesh(12, 4)
    sky = procedural_sky(8)
    assert a.vertices is not b.vertices
    assert _scene_digest(_scene(a, sky)) == _scene_digest(_scene(b, sky.copy()))


@pytest.mark.parametrize("form", ["strided", "float32"])
def test_vertices_digest_as_their_contiguous_float64_copy(form):
    """The leaf is hashed as `np.ascontiguousarray(arr, np.float64)`, so
    the vertices' layout and type do not reach the digest, only their
    values as float64."""
    mesh = trefoil_mesh(12, 4)
    if form == "strided":
        wide = np.zeros(mesh.vertices.shape + (2,))
        wide[..., 1] = mesh.vertices
        other = Mesh(wide[..., 1], mesh.normals)
        assert not other.vertices.flags.c_contiguous
    else:
        mesh.vertices = mesh.vertices.astype(np.float32)
        other = trefoil_mesh(12, 4)
        other.vertices = np.ascontiguousarray(mesh.vertices, np.float64)
    sky = procedural_sky(8)
    assert _scene_digest(_scene(mesh, sky)) == _scene_digest(_scene(other, sky))


def test_a_shared_mesh_and_two_equal_meshes_digest_apart():
    mesh = trefoil_mesh(12, 4)
    digests = []
    for second in (mesh, trefoil_mesh(12, 4)):
        scene = _scene(mesh)
        scene.add(Object(second))
        digests.append(_scene_digest(scene))
    assert digests[0] != digests[1]


def test_leaf_bytes_and_the_structural_bytes_add_up_to_bytes():
    """`leaf_bytes` is what the native hash read (both meshes' vertices and
    normals as float64, the map's float32 bytes); the rest of `bytes` is
    what blake2b read itself: tags, the material's text, the color."""
    scene = _scene()
    scene.add(Object(rpt_tpu_torch.sphere()))
    scene.add(Object(trefoil_mesh(6, 3)))
    with profiling.recording():
        _scene_digest(scene)
    attrs = [s for s in profiling.spans() if s.name == "rpt.scene.digest"][-1].attrs
    meshes = [o.shape for o in scene.objects if isinstance(o.shape, Mesh)]
    leaves = sum(8 * (m.vertices.size + m.normals.size) for m in meshes) + scene.environment.hdri.nbytes
    structural = (3 * len(b"O") + len(b"m0:") + len(b"S") + len(b"m1:")
                  + sum(len(repr(o.mat).encode()) for o in scene.objects) + len(b"E") + 8 * 3)
    assert attrs["leaf_bytes"] == leaves
    assert attrs["bytes"] == leaves + structural


def test_in_place_edit_of_mesh_vertices_recompiles_and_renders_anew():
    """Editing a mesh's vertices in place changes the digest, so
    `Scene.compile` builds a new SceneData, and the next render equals a
    scene built afresh from the edited mesh."""
    camera = Camera.look_at((0.0, 0.5, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), math.pi / 4)

    def renderer(scene):
        return Renderer(scene, camera, width=16, height=12, max_bounces=2, num_samples=1, device="cpu")

    mesh = trefoil_mesh(12, 4)
    r = renderer(_scene(mesh))
    before_image, before = r.render(), r.scene_data()
    mesh.vertices *= 1.5
    edited = r.render()
    assert r.scene_data() is not before
    assert not np.array_equal(edited, before_image)
    fresh = renderer(_scene(Mesh(mesh.vertices.copy(), mesh.normals.copy()))).render()
    assert np.array_equal(edited, fresh)


def test_the_digest_raises_without_a_compiler(monkeypatch, tmp_path):
    """No g++ on the path and no built library: the leaf hash raises, and
    with it the digest. There is no slower stand-in."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(OSError):
        native.hash128(_bytes(FOX))
    with pytest.raises(OSError):
        _scene_digest(_scene())
    assert not os.listdir(tmp_path)
