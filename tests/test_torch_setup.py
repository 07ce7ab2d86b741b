"""dirt_tpu_torch vs dirt_tpu: matrices, mesh, triangle setup, clipping,
conversion helpers, and the package's freedom from jax.

Tolerance: allclose(rtol=1e-6, atol=1e-6) on floats (the same f32
expressions in the same order; the margin covers XLA fusing a multiply
into an add where PyTorch's CPU ops round each step); integers (bboxes,
counts, ids) are equal.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_scene import SIZE, sphere_scene, screen_soup
from dirt_tpu.core import matrices as jm
from dirt_tpu.core import mesh as jmesh
from dirt_tpu.ops import clipping as jc
from dirt_tpu.ops import raster as jr
from dirt_tpu.ops import triangle_setup as jt
from dirt_tpu_torch import convert
from dirt_tpu_torch.core import matrices as tm
from dirt_tpu_torch.core import mesh as tmesh
from dirt_tpu_torch.ops import clipping as tc
from dirt_tpu_torch.ops import triangle_setup as tt

TOL = dict(rtol=1e-6, atol=1e-6)
REPO = Path(__file__).resolve().parents[1]


def _close(jax_out, torch_out):
    np.testing.assert_allclose(
        np.asarray(torch_out.detach()), np.asarray(jax_out), **TOL)


_RNG = np.random.RandomState(3)
_AA = _RNG.randn(5, 3).astype(np.float32)
_M3 = _RNG.randn(2, 3, 3).astype(np.float32)
_V3 = _RNG.randn(7, 3).astype(np.float32)
_MATRIX_CASES = {
    "translation": ("translation", (_AA,)),
    "scale_scalar": ("scale", (np.float32(1.7),)),
    "scale_xyz": ("scale", (_AA,)),
    "rodrigues": ("rodrigues", (_AA,)),
    "rodrigues_zero": ("rodrigues", (np.zeros(3, np.float32),)),
    "rotation_x": ("rotation_x", (_AA[:, 0],)),
    "rotation_y": ("rotation_y", (_AA[:, 1],)),
    "rotation_z": ("rotation_z", (_AA[:, 2],)),
    "perspective": ("perspective_projection", (0.1, 20.0, 0.045, 0.75)),
    "orthographic": ("orthographic_projection", (0.5, 9.0, 2.0, 1.25)),
    "pad_3x3": ("pad_3x3_to_4x4", (_M3,)),
}


@pytest.mark.parametrize("case", sorted(_MATRIX_CASES))
def test_matrices_match(case):
    name, args = _MATRIX_CASES[case]
    _close(getattr(jm, name)(*args), getattr(tm, name)(*args))


def test_compose_and_transform_match():
    mats = [np.asarray(jm.rodrigues(_AA[0])), np.asarray(jm.translation(
        _AA[1])), np.asarray(jm.perspective_projection(0.1, 20.0, 0.5, 1.0))]
    _close(jm.compose(*mats), tm.compose(*mats))
    _close(jm.transform_homogeneous(_V3, mats[0]),
           tm.transform_homogeneous(_V3, mats[0]))


def test_mesh_is_a_copy():
    for a, b in zip(jmesh.uv_sphere(9, 13), tmesh.uv_sphere(9, 13)):
        np.testing.assert_array_equal(a, b)
    for fn in ("unit_quad", "cube"):
        for a, b in zip(getattr(jmesh, fn)(), getattr(tmesh, fn)()):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jmesh.checkerboard_texture(),
                                  tmesh.checkerboard_texture())


def _setup_inputs():
    """Bench-camera sphere faces plus degenerate and w <= 0 faces."""
    clip, colors, faces = sphere_scene()
    fv = np.asarray(jt.screen_from_clip(clip, SIZE, SIZE))[faces]
    soup, soup_attrs = screen_soup(12, SIZE, SIZE, seed=5)
    soup[0, 2] = soup[0, 0]                    # zero area
    soup[1, 1, 3] = -0.5                       # a vertex behind the eye
    soup[2, :, 2] = 1.5                        # beyond the far plane
    fv = np.concatenate([fv, soup])
    fa = np.concatenate([colors[faces], soup_attrs])
    return fv, fa


def test_screen_from_clip_matches():
    clip, _, _ = sphere_scene(distance=0.9)
    clip = np.concatenate([clip, [[0.3, 0.2, 0.1, 0.0],
                                  [0.3, 0.2, 0.1, -2.0]]]).astype(np.float32)
    _close(jt.screen_from_clip(clip, SIZE, 96),
           tt.screen_from_clip(torch.tensor(clip), SIZE, 96))


def test_setup_planes_match():
    fv, fa = _setup_inputs()
    geo_j, att_j, valid_j = jt.setup_planes(fv, fa)
    geo_t, att_t, valid_t = tt.setup_planes(torch.tensor(fv),
                                            torch.tensor(fa))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    assert not valid_t[-12:-10].any() and bool(valid_t[-10])
    _close(geo_j, geo_t)
    _close(att_j, att_t)


def test_edge_filter_and_bbox_columns_match():
    fv, fa = _setup_inputs()
    for a, b in zip(jt.edge_filter_cols(fv),
                    tt.edge_filter_cols(torch.tensor(fv))):
        _close(a, b)
    valid = tt.setup_planes(torch.tensor(fv), torch.tensor(fa))[2]
    valid_j = jnp.asarray(valid.numpy())
    for a, b in zip(jt.face_bbox_cols(fv, valid_j, SIZE, 96),
                    tt.face_bbox_cols(torch.tensor(fv), valid, SIZE, 96)):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(
        tt.face_bboxes(torch.tensor(fv), valid, SIZE, 96).numpy(),
        np.asarray(jt.face_bboxes(fv, valid_j, SIZE, 96)))


def test_bbox_of_far_off_screen_vertices_matches():
    """Screen coordinates beyond the int32 range saturate as in JAX: a
    valid face with one vertex far to the right or below stays binned."""
    base = np.float32([[10.0, 10.0], [50.0, 20.0], [30.0, 60.0]])
    far = [(2, 0, 3e9), (2, 1, 5e9), (0, 0, -3e9), (1, 1, -4e9),
           (2, 0, np.inf), (2, 1, np.nan)]
    xy = np.repeat(base[None], len(far), axis=0)
    for k, (corner, axis, value) in enumerate(far):
        xy[k, corner, axis] = value
    fv = np.concatenate([xy, np.zeros((len(far), 3, 1), np.float32),
                         np.ones((len(far), 3, 1), np.float32)], axis=-1)
    fa = np.zeros((len(far), 3, 1), np.float32)
    valid = tt.setup_planes(torch.tensor(fv), torch.tensor(fa))[2]
    assert valid[:4].all()
    got = tt.face_bbox_cols(torch.tensor(fv), valid, SIZE, 96)
    want = jt.face_bbox_cols(fv, jnp.asarray(valid.numpy()), SIZE, 96)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert (got[1][:4] >= got[0][:4]).all()    # none of the four culled


def _crossing_faces():
    clip, colors, faces = sphere_scene(distance=0.9)
    return clip[faces], colors[faces]


def test_clipping_matches():
    fvc, fa = _crossing_faces()
    n_in = np.asarray(jc.inside_counts(fvc))
    np.testing.assert_array_equal(tc.inside_counts(torch.tensor(fvc)).numpy(),
                                  n_in)
    assert (n_in == 2).any() and (n_in == 1).any() and (n_in == 0).any()
    assert bool(tc.needs_clipping(torch.tensor(fvc))) is True
    assert bool(tc.needs_clipping(torch.tensor(fvc[n_in == 3]))) is False

    v2_j, a2_j = jc.clip_faces(fvc, fa)
    v2_t, a2_t = tc.clip_faces(torch.tensor(fvc), torch.tensor(fa))
    _close(v2_j, v2_t)
    _close(a2_j, a2_t)

    live = int((n_in == 2).sum())
    for cap in (live + 3, live - 2):
        out_j = jc.compact_clipped(v2_j, a2_j, jnp.asarray(n_in), cap)
        out_t = tc.compact_clipped(v2_t, a2_t, torch.tensor(n_in), cap)
        assert bool(out_t[3]) == bool(out_j[3]) == (cap < live)
        np.testing.assert_array_equal(out_t[2][:len(n_in) + min(cap, live)],
                                      np.asarray(out_j[2])[:len(n_in)
                                                           + min(cap, live)])
        _close(out_j[0], out_t[0])
        _close(out_j[1], out_t[1])

        scr_j = jc.clip_compact_screen(fvc, fa, cap, SIZE, 96)
        scr_t = tc.clip_compact_screen(torch.tensor(fvc), torch.tensor(fa),
                                       cap, SIZE, 96)
        _close(scr_j[0], scr_t[0])
        _close(scr_j[1], scr_t[1])
        assert bool(scr_t[3]) == bool(scr_j[3])


def test_import_loads_no_jax():
    code = ("import sys, dirt_tpu_torch, dirt_tpu_torch.convert; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_config_from_jax_round_trips():
    cfgs = [
        jr.RasterConfig(),
        jr.RasterConfig(engine="packed", budget=512, expand_cap=15,
                        pool_cap=2296, work_cap=1662, clip_cap=8,
                        streaming=False).concrete(SIZE),
    ]
    store = json.loads((REPO / "bench_cache" / "configs.json").read_text())
    entries = [v for k, v in store.items() if k != "format"]
    assert entries
    for c in cfgs + entries:
        port = convert.config_from_jax(c)
        want = c._asdict() if hasattr(c, "_asdict") else c
        assert port._asdict() == want
        assert jr.RasterConfig(**port._asdict())._asdict() == want
    with pytest.raises(ValueError, match="unknown"):
        convert.config_from_jax({"tile_hh": 8})


def test_scene_from_numpy_types():
    clip, colors, faces = sphere_scene(4, 6)
    bg = np.zeros((8, 8, 3), np.float64)
    bg_t, v, c, f = convert.scene_from_numpy(bg, clip, colors, faces, "cpu")
    assert (bg_t.dtype, v.dtype, c.dtype, f.dtype) == (
        torch.float32, torch.float32, torch.float32, torch.int64)
    np.testing.assert_array_equal(f.numpy(), faces)
    assert convert.scene_from_numpy(None, clip, colors, faces, "cpu")[0] \
        is None
