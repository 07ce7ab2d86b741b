"""dirt_tpu_torch.io.objloader against dirt_tpu.io.objloader, on the CPU.

Mirrors tests/test_objloader.py on the port (quads and split corners,
negative indices, trailing comments, native parser equal to the Python
one, a loaded mesh renders) and holds the port's loader equal to
``dirt_tpu.io.load_obj`` on the same files: every array equal. Also the
library's place (``build/dirt_tpu_torch/``), ``native=True`` raising when
the build fails, ``ObjMesh.to_tensors``, and ``bench_torch.py``'s scene
against the one ``bench.py:88-112`` builds with ``dirt_tpu``'s ``mesh`` and
``matrices`` (vertices within 1e-6 of their scale: one float32 transform in
two frameworks; everything else equal).
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
import dirt_tpu_torch
from dirt_tpu.core import matrices as jmatrices
from dirt_tpu.core import mesh as jmesh
from dirt_tpu.io import load_obj as jax_load_obj
from dirt_tpu_torch.io import ObjMesh, load_obj
from dirt_tpu_torch.io import objloader

CUBE_OBJ = """\
# comment line
v -1 -1 1
v 1 -1 1
v 1 1 1
v -1 1 1
v -1 -1 -1
v 1 -1 -1
v 1 1 -1
v -1 1 -1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0 -1
f 1/1/1 2/2/1 3/3/1 4/4/1
f 6/1/2 5/2/2 8/3/2 7/4/2
"""


def _write(tmp_path, text, name="mesh.obj"):
    p = os.path.join(tmp_path, name)
    with open(p, "w") as f:
        f.write(text)
    return p


def _random_obj(seed=0, nv=200, nf=300):
    """Faces in all four corner styles (v, v/vt, v//vn, v/vt/vn)."""
    rng = np.random.RandomState(seed)
    lines = [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in rng.rand(nv, 3)]
    lines += [f"vt {t[0]:.6f} {t[1]:.6f}" for t in rng.rand(50, 2)]
    lines += [f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}" for n in rng.rand(30, 3)]
    for _ in range(nf):
        ids = rng.randint(1, nv + 1, 3)
        tid = rng.randint(1, 51, 3)
        nid = rng.randint(1, 31, 3)
        style = rng.randint(4)
        corners = [
            str(i) if style == 0 else f"{i}/{t}" if style == 1
            else f"{i}//{n}" if style == 2 else f"{i}/{t}/{n}"
            for i, t, n in zip(ids, tid, nid)]
        lines.append("f " + " ".join(corners))
    return "\n".join(lines) + "\n"


def _assert_meshes_equal(got, want):
    for name in ("vertices", "uvs", "normals", "faces"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.has_uv, got.has_normal) == (want.has_uv, want.has_normal)


def _native_or_skip():
    if objloader._native_lib() is None:
        pytest.skip("no C++ toolchain")


def test_python_parser_quads_and_split(tmp_path):
    p = _write(tmp_path, CUBE_OBJ)
    m = load_obj(p, native=False)
    # two quads -> 4 triangles; 8 unique corner triplets
    assert m.faces.shape == (4, 3)
    assert m.vertices.shape == (8, 3)
    assert m.has_uv and m.has_normal
    np.testing.assert_array_equal(m.faces[0], [0, 1, 2])
    np.testing.assert_array_equal(m.faces[1], [0, 2, 3])
    np.testing.assert_allclose(m.uvs[0], [0, 0])
    np.testing.assert_allclose(m.normals[0], [0, 0, 1])


def test_negative_and_mixed_indices(tmp_path):
    p = _write(tmp_path, "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    m = load_obj(p, native=False)
    assert m.faces.shape == (1, 3)
    assert not m.has_uv and not m.has_normal
    np.testing.assert_allclose(m.vertices[m.faces[0]][:, 0], [0, 1, 0])


def test_trailing_comment_on_face_line(tmp_path):
    text = (
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0  # vertex comment\n"
        "f 1 2 3 # 4\n"
        "f 1 2 4 #4\n"
    )
    p = _write(tmp_path, text)
    mp = load_obj(p, native=False)
    assert mp.faces.shape == (2, 3)
    assert mp.vertices.shape[0] == 4
    _native_or_skip()
    _assert_meshes_equal(load_obj(p, native=True), mp)


def test_native_matches_python(tmp_path):
    _native_or_skip()
    p = _write(tmp_path, _random_obj())
    mp = load_obj(p, native=False)
    mn = load_obj(p, native=True)
    np.testing.assert_array_equal(mp.faces, mn.faces)
    np.testing.assert_allclose(mp.vertices, mn.vertices, atol=1e-6)
    np.testing.assert_allclose(mp.uvs, mn.uvs, atol=1e-6)
    np.testing.assert_allclose(mp.normals, mn.normals, atol=1e-6)
    assert mp.has_uv == mn.has_uv and mp.has_normal == mn.has_normal


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("text", ["cube", "random", "negative"])
def test_loader_matches_dirt_tpu(tmp_path, native, text):
    if native:
        _native_or_skip()
    body = {"cube": CUBE_OBJ, "random": _random_obj(seed=5),
            "negative": "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
                        "f -4 -3 -2 -1\n"}[text]
    p = _write(tmp_path, body)
    _assert_meshes_equal(load_obj(p, native=native),
                         jax_load_obj(p, native=native))


def test_library_is_built_under_build(tmp_path):
    _native_or_skip()
    path = objloader.library_path()
    assert path.parent.parts[-2:] == ("build", "dirt_tpu_torch")
    assert path.is_file() and path.name.startswith("libobjloader_")


def test_native_true_raises_when_the_build_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(objloader, "_SOURCE", tmp_path / "missing.cpp")
    monkeypatch.setattr(objloader, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(objloader, "_LIB", None)
    monkeypatch.setattr(objloader, "_LIB_FAILED", False)
    p = _write(tmp_path, CUBE_OBJ)
    with pytest.raises(RuntimeError, match="native objloader unavailable"):
        load_obj(p, native=True)
    # Without the library the default falls back to the Python parser.
    _assert_meshes_equal(load_obj(p), load_obj(p, native=False))


def test_to_tensors(tmp_path):
    m = load_obj(_write(tmp_path, CUBE_OBJ), native=False)
    verts, uvs, normals, faces = m.to_tensors("cpu")
    assert verts.dtype == uvs.dtype == normals.dtype == torch.float32
    assert faces.dtype == torch.int64
    np.testing.assert_array_equal(verts.numpy(), m.vertices)
    np.testing.assert_array_equal(faces.numpy(), m.faces)
    assert isinstance(m, ObjMesh) and "F=4" in repr(m)


def test_to_tensors_defaults_to_the_card():
    """Like the port's entry points, ``to_tensors`` puts the mesh on the
    card unless the caller asks for another device."""
    default = inspect.signature(ObjMesh.to_tensors).parameters["device"]
    assert default.default == "cuda"


def test_loaded_mesh_renders(tmp_path):
    m = load_obj(_write(tmp_path, CUBE_OBJ), native=False)
    verts, _, _, faces = m.to_tensors("cpu")
    verts = torch.cat([verts * 0.5, torch.ones(len(verts), 1)], dim=1)
    colors = torch.ones(len(verts), 1)
    img = dirt_tpu_torch.rasterise(None, verts, colors, faces, height=32,
                                   width=128, channels=1)
    assert float(img.max()) == 1.0


def _jax_bench_scene(size):
    """``bench.py:88-112`` (``build``) with dirt_tpu's mesh and matrices."""
    verts_obj, faces, _ = jmesh.uv_sphere(n_lat=72, n_lon=72)
    mv = jmatrices.compose(
        jmatrices.rodrigues(jnp.array([0.4, 0.3, 0.0])),
        jmatrices.translation(jnp.array([0.0, 0.0, -3.0])),
    )
    proj = jmatrices.perspective_projection(0.1, 20.0, 0.045, 1.0)
    clip = jax.jit(lambda v: jmatrices.transform_homogeneous(
        v, jmatrices.compose(mv, proj)))(jnp.asarray(verts_obj))
    colors = np.random.RandomState(0).rand(len(verts_obj), 3).astype(
        np.float32)
    weights = np.random.RandomState(1).rand(size, size, 3).astype(np.float32)
    return (np.asarray(verts_obj), np.asarray(clip), colors,
            np.asarray(faces), np.zeros((size, size, 3), np.float32), weights)


def test_bench_scene_matches_bench_py():
    size = 64
    want = _jax_bench_scene(size)
    got = [t.numpy() for t in bench_torch.bench_scene(size, "cpu")]
    assert got[3].dtype == np.int64 and len(got[3]) == 10224
    np.testing.assert_array_equal(got[0], want[0])
    scale = np.abs(want[1]).max()
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6 * scale)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)
