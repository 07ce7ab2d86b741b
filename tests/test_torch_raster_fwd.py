"""The packed raster kernel's plain version vs dirt_tpu's packed forward.

The JAX side runs ``raster_forward_packed`` (the Pallas kernel in
interpret mode plus its two layout swaps); the port's side gets the same
bins and face table as tensors on the CPU, so its wrapper takes the plain
version; both get the same plane coefficients. Tolerance: fid equal;
pixels and zbuf within 1e-5 absolute (identical expressions, ~2e-6 seen:
XLA may fuse a multiply into an add where PyTorch rounds each step).

Also here: the no-fallback rules (a tensor on another device raises, a
missing CUDA toolchain raises, the engine that is not ported raises), and
the image <-> flat-subtile layout swap against ``flat_subtile_swap`` and
``flat_subtile_swap_pallas`` (interpret mode): a permutation, so equal bit
for bit. The kernels themselves are checked against their plain versions
in tests/test_torch_cuda.py.
"""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_scene import (SIZE, budget_row_gathers, screen_soup,
                               sphere_scene)
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


def _row_path(table2, bins, bg_chw, **geom):
    """The forward as it read the face table before the kernels read it
    through the entries: every budget row's face row gathered
    (``table2[entries // 8]``) and read in budget-row order. Run through
    the same plain version, with the gathered rows as its table and each
    budget row as its own entry (the strip bits kept); fid comes from the
    rows' id column either way."""
    rows = table2[bins.entries.long() // 8]
    own = torch.arange(rows.shape[0], dtype=torch.int32) * 8 \
        + (bins.entries & 7)
    return tf.raster_forward_packed_plain(
        rows, bins._replace(entries=own, pool_offs=None, table=None),
        bg_chw, **geom)


def _packed_case(case):
    """(table2, bins, background, tile geometry) of a port forward on the
    CPU: the sphere under suggested caps, a soup at C = 2 with one tile
    row of 64, or the sphere binned under half its budget, so the
    binning overflows."""
    if case == "soup":
        fv, fa = screen_soup(90, 192, 256, seed=7, channels=2, spread=40.0)
        fv, fa = torch.tensor(fv), torch.tensor(fa)
        height, width, tile_h = 192, 256, 64
    else:
        clip, colors, faces = sphere_scene(16, 24)
        fv = tt.screen_from_clip(torch.tensor(clip), SIZE, SIZE)[faces]
        fa = torch.tensor(colors)[faces]
        height = width = SIZE
        tile_h = 32
    bg = torch.rand(height, width, fa.shape[-1],
                    generator=torch.Generator().manual_seed(3))
    config = tr.suggest_config(
        fv, height, width, tr.RasterConfig(engine="packed", tile_h=tile_h))
    if case == "overflow":
        config = config._replace(budget=config.budget // 2)
    else:
        config = config._replace(budget=2 * config.budget)
    table2, bins, bg_chw, cfg = tr.prepare_packed(fv, fa, bg, config)
    assert bool(bins.overflow) is (case == "overflow")
    return table2, bins, bg_chw, dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)


@pytest.mark.parametrize("case", ["sphere", "soup", "overflow"])
def test_forward_through_entries_equals_the_row_path(case):
    """The wrapper's plain path, which reads each job's face row through
    its entry, gives the gathered rows' result bit for bit: fid, zbuf and
    pixels. The bins hold sentinel entries (the face past the last) in
    live iterations and padding rows past the tiles' runs."""
    table2, bins, bg_chw, geom = _packed_case(case)
    assert bins.table is table2
    num_faces = table2.shape[0] - 1
    assert bool((bins.entries >> 3 == num_faces).any())
    assert int(bins.n_iters.sum()) * 8 < bins.entries.shape[0]
    got = tf.raster_forward_packed(table2, bins, bg_chw, **geom)
    want = _row_path(table2, bins, bg_chw, **geom)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1] >= 0).any() and (got[1] < 0).any()


def test_packed_step_gathers_no_row_per_budget_row():
    """A packed forward and backward through the raster op makes no copy
    of the face table in budget-row order: no gather of the step outputs
    [budget_rows, *] (the check sees one where a step makes it)."""
    table2, bins, bg_chw, geom = _packed_case("sphere")
    budget_rows = bins.entries.shape[0]
    clip, colors, faces = sphere_scene(16, 24)
    fv = tt.screen_from_clip(torch.tensor(clip), SIZE, SIZE)[faces]
    fa = torch.tensor(colors)[faces].requires_grad_()
    fv.requires_grad_()
    config = tr.suggest_config(
        fv, SIZE, SIZE, tr.RasterConfig(engine="packed", tile_h=32))
    config = config._replace(budget=2 * config.budget)
    bg = torch.rand(SIZE, SIZE, 3)

    def step():
        pixels = tr.rasterize_screen(fv, fa, bg, config)[0]
        (pixels * pixels).sum().backward()

    assert budget_row_gathers(step, budget_rows) == []
    assert fv.grad.abs().max() > 0 and fa.grad.abs().max() > 0
    assert ("index", (budget_rows, 32)) in budget_row_gathers(
        lambda: _row_path(table2, bins, bg_chw, **geom), budget_rows)


def test_table_of_other_faces_raises():
    """The packed forward and backward take only the face table of the
    binning's faces: F + 1 rows (the sentinel last)."""
    table2, bins, bg_chw, geom = _packed_case("sphere")
    with pytest.raises(ValueError, match="the faces and the sentinel"):
        tf.raster_forward_packed(table2[:-1], bins, bg_chw, **geom)
    with pytest.raises(ValueError, match="the faces and the sentinel"):
        tf.raster_forward_packed(table2[None], bins, bg_chw, **geom)


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
    """Nothing raises any more: the CSR engine's backward runs, and so does
    the packed engine's."""
    clip, colors, faces = sphere_scene(4, 6)
    fv = torch.tensor(
        np.asarray(jt.screen_from_clip(clip, 32, 128))[faces],
        requires_grad=True)
    args = (fv, torch.tensor(colors[faces]), torch.zeros(32, 128, 3))
    for engine in ("csr", "packed"):
        fv.grad = None
        pixels, _, _, _ = tr.rasterize_screen(
            *args, tr.RasterConfig(engine=engine))
        pixels.sum().backward()
        assert torch.isfinite(fv.grad).all() and fv.grad.abs().max() > 0


# --- the layout swap ------------------------------------------------------------


def _swap_arrays(hp, wp, seed=3):
    """The halo path's five fields: fid, bits (int32), pix, grad, sval."""
    rng = np.random.RandomState(seed)
    return [rng.randint(-2, 50, (hp, wp)).astype(np.int32),
            rng.randint(0, 16, (hp, wp)).astype(np.int32),
            rng.randn(3, hp, wp).astype(np.float32),
            rng.randn(3, hp, wp).astype(np.float32),
            rng.randn(4, hp, wp).astype(np.float32)]


@pytest.mark.parametrize("hp,wp", [(8, 128), (24, 256), (64, 384)])
def test_flat_subtile_swap_matches_jax(hp, wp):
    arrays = _swap_arrays(hp, wp)
    got = tf.flat_subtile_swap([torch.tensor(a) for a in arrays])
    pallas = jf.flat_subtile_swap_pallas([jnp.asarray(a) for a in arrays])
    assert len(got) == len(arrays)
    for a, g, p in zip(arrays, got, pallas):
        assert g.shape == a.shape and g.numpy().dtype == a.dtype
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(jf.flat_subtile_swap(jnp.asarray(a))))
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
        assert not np.array_equal(g.numpy(), a)
    back = tf.flat_subtile_swap(got)
    for a, b in zip(arrays, back):
        np.testing.assert_array_equal(b.numpy(), a)


def test_flat_subtile_swap_moves_a_subtile_to_a_row():
    """Pixel (r, 16 k + c) of a strip lands at (k, 16 r + c)."""
    image = torch.arange(16 * 256, dtype=torch.int32).reshape(16, 256)
    (flat,) = tf.flat_subtile_swap([image])
    for s, tx, r, k, c in [(0, 0, 3, 5, 7), (1, 1, 7, 0, 15), (1, 0, 0, 7, 0)]:
        assert flat[8 * s + k, 128 * tx + 16 * r + c] == \
            image[8 * s + r, 128 * tx + 16 * k + c]
    subtile = image[8:16, 128 + 32:128 + 48]            # strip 1, tile 1, k=2
    assert torch.equal(flat[8 + 2, 128:256], subtile.reshape(-1))


def test_flat_subtile_swap_rejects_bad_inputs():
    ok = torch.zeros(8, 128)
    assert tf.flat_subtile_swap([]) == []
    with pytest.raises(ValueError, match="not a multiple of 8x128"):
        tf.flat_subtile_swap([torch.zeros(8, 64)])
    with pytest.raises(ValueError, match="array 1 is"):
        tf.flat_subtile_swap([ok, torch.zeros(16, 128)])
    with pytest.raises(ValueError, match="array 0 is torch.float64"):
        tf.flat_subtile_swap([ok.double()])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tf.flat_subtile_swap([ok.to("meta")])
