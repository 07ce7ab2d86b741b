"""The packed raster kernel's plain version vs dirt_tpu's packed forward.

The JAX side runs ``raster_forward_packed`` (the Pallas kernel in
interpret mode plus its two layout swaps); the port's side gets the same
bins and face table as tensors on the CPU, so its wrapper takes the plain
version; both get the same plane coefficients. Tolerance: fid equal;
pixels and zbuf within 1e-5 absolute (identical expressions, ~2e-6 seen:
XLA may fuse a multiply into an add where PyTorch rounds each step).

Also here: the no-fallback rules (a tensor on another device raises, a
missing CUDA toolchain raises, the engine that is not ported raises). The kernel itself is checked against its plain version in
tests/test_torch_cuda.py.
"""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_scene import SIZE, screen_soup, sphere_scene
from dirt_tpu.ops import binning as jb
from dirt_tpu.ops import raster_fwd as jf
from dirt_tpu.ops import triangle_setup as jt
from dirt_tpu_torch.ops import _build
from dirt_tpu_torch.ops import binning as tb
from dirt_tpu_torch.ops import raster as tr
from dirt_tpu_torch.ops import raster_fwd as tf
from dirt_tpu_torch.ops import triangle_setup as tt

ATOL = 1e-5


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _jax_forward(fv, height, width, tile_h, budget, expand, fa, bg_chw):
    geo, att, valid = jt.setup_planes(fv, fa)
    bbox = jt.face_bbox_cols(fv, valid, height, width)
    bins = jb.bin_faces_packed(bbox, height, width, tile_h, 128, budget,
                               expand, edges=jt.edge_filter_cols(fv))
    table2 = jf.pack_face_table_v2(geo, att)
    out = jf.raster_forward_packed(table2, bins, bg_chw, tile_h=tile_h,
                                   tile_w=128)
    return out, table2, bins, geo, att


def _both(fv, fa, height, width, tile_h, seed=0):
    """Run both forwards on identical bins; returns (jax, torch) outputs."""
    channels = fa.shape[-1]
    bg = np.random.RandomState(seed).rand(channels, height, width)
    bg = bg.astype(np.float32)
    nf = fv.shape[0]
    grid = tb.packed_grid(height, width, tile_h, 128)
    expand = tb.auto_packed_expand(nf, grid[0] * grid[1] * grid[2] * grid[3])
    budget = tb.auto_packed_budget(nf, height, width, tile_h, 128, expand)
    (pix_j, fid_j, z_j), table2_j, bins_j, geo, att = _jax_forward(
        jnp.asarray(fv), height, width, tile_h, budget, expand,
        jnp.asarray(fa), jnp.asarray(bg))
    assert not bool(bins_j.overflow)

    # Same planes on both sides (setup parity is test_torch_setup's), so
    # the face tables are equal and the kernels see identical inputs.
    table2 = tf.pack_face_table_v2(torch.tensor(np.asarray(geo)),
                                   torch.tensor(np.asarray(att)))
    np.testing.assert_array_equal(table2.numpy(), np.asarray(table2_j))
    bins = tb.PackedBins(*(
        None if v is None else torch.tensor(np.asarray(v))
        for v in bins_j
    ))
    out_t = tf.raster_forward_packed(table2, bins, torch.tensor(bg),
                                     tile_h=tile_h, tile_w=128)
    return (np.asarray(pix_j), np.asarray(fid_j), np.asarray(z_j)), out_t


def _assert_match(out_j, out_t):
    pix_j, fid_j, z_j = out_j
    pix_t, fid_t, z_t = (o.numpy() for o in out_t)
    assert fid_t.dtype == np.int32
    np.testing.assert_array_equal(fid_t, fid_j)
    np.testing.assert_allclose(pix_t, pix_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(z_t, z_j, rtol=0, atol=ATOL)
    assert (fid_t >= 0).any() and (fid_t < 0).any()


def test_plain_matches_jax_on_sphere():
    clip, colors, faces = sphere_scene()
    fv = np.asarray(jt.screen_from_clip(clip, SIZE, SIZE))[faces]
    _assert_match(*_both(fv, colors[faces], SIZE, SIZE, 32))


def test_plain_matches_jax_on_soup():
    fv, fa = screen_soup(90, 192, 256, seed=7, channels=2, spread=40.0)
    _assert_match(*_both(fv, fa, 192, 256, 64, seed=1))


def test_coplanar_tie_goes_to_lower_id():
    """Overlapping faces in one plane: every shared pixel goes to the
    lower face id, whichever of the two is listed first."""
    # Quarter-pixel coordinates: every setup step is exact, so the three
    # depth planes are exactly equal.
    tri = np.array([[10.25, 50.25], [54.0, 49.75], [32.25, 10.5]], np.float32)
    shifted = tri + np.float32([9.0, 3.0])
    xy = np.stack([tri, shifted, tri])
    fv = np.concatenate([xy, np.full((3, 3, 1), 0.25, np.float32),
                         np.ones((3, 3, 1), np.float32)], axis=-1)
    fa = np.stack([np.full((3, 1), v, np.float32) for v in (0.2, 0.5, 0.9)])
    out_j, out_t = _both(fv, fa, 64, 128, 32)
    _assert_match(out_j, out_t)
    fid = out_t[1].numpy()
    assert set(np.unique(fid)) == {-1, 0, 1}     # face 2 copies face 0
    assert (fid == 1).any()
    # Face 1 wins only where face 0 does not cover.
    fid0 = _both(fv[:1], fa[:1], 64, 128, 32)[1][1].numpy()
    assert not ((fid == 1) & (fid0 == 0)).any()


def test_other_devices_raise():
    """No fallback: only CPU tensors take the plain version."""
    clip, colors, faces = sphere_scene(4, 6)
    fv = torch.tensor(np.asarray(jt.screen_from_clip(clip, 32, 128))[faces])
    cfg = tr.RasterConfig(engine="packed")
    table2, bins, bg_chw, cfg = tr.prepare_packed(
        fv, torch.tensor(colors[faces]), torch.zeros(32, 128, 3), cfg)
    meta = tb.PackedBins(*(v if v is None else v.to("meta") for v in bins))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tf.raster_forward_packed(table2.to("meta"), meta, bg_chw.to("meta"),
                                 tile_h=cfg.tile_h, tile_w=cfg.tile_w)


def test_cuda_build_without_toolchain_raises(monkeypatch, tmp_path):
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolchain is installed here")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("raster_fwd_packed")


def test_backward_raises_not_implemented():
    """The CSR engine (forward and backward) raises, naming its later PR;
    the packed engine's backward runs."""
    clip, colors, faces = sphere_scene(4, 6)
    fv = torch.tensor(
        np.asarray(jt.screen_from_clip(clip, 32, 128))[faces],
        requires_grad=True)
    args = (fv, torch.tensor(colors[faces]), torch.zeros(32, 128, 3))
    with pytest.raises(NotImplementedError, match="later PR"):
        tr.rasterize_screen(*args, tr.RasterConfig(engine="csr"))
    pixels, _, _, _ = tr.rasterize_screen(*args,
                                          tr.RasterConfig(engine="packed"))
    pixels.sum().backward()
    assert torch.isfinite(fv.grad).all() and fv.grad.abs().max() > 0
