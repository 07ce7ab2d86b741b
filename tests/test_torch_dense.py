"""The dense whole-tile engine of dirt_tpu_torch vs dirt_tpu's, on the CPU.

The same numpy inputs go through the JAX function (Pallas kernels in
interpret mode, as the root conftest arranges) and the port's (CPU tensors,
so each kernel wrapper takes its plain PyTorch version). Tolerances:

* ``bin_faces`` and ``pack_face_table``: every field equal;
* ``raster_forward``: fid equal; zbuf and pixels within 5e-6 absolute (the
  same expressions in the same order; XLA may fuse a multiply into an add
  where PyTorch rounds each step);
* ``fused_backward_rows`` and ``backward_fused``: within 1e-6 of the
  column's largest magnitude plus 1e-6 (the JAX kernel sums a face's pixels
  through f32 matrix products, the plain version through one float64
  ``index_add_``);
* the op end to end against ``jax.vjp`` with the dense engine, clip off and
  on, and on the sphere so close that faces cross the near plane: fid equal
  except on at most 0.5% of pixels (razor edges, the policy of
  test_torch_pipeline.py); pixels and zbuf of each package within 1e-5 of
  the float64 oracle where its fids equal the oracle's (two float32
  renders may round to opposite sides of it: tests/_torch_port_oracle.py);
  d_background atol 1e-6, d_colors rtol 1e-4 atol 1e-5, d_vertices rtol
  1e-3 atol 1e-3 (the tolerances of tests/test_raster_grad.py), except at
  the vertices of razor faces, where the port's are held to the oracle's
  backward with the same tolerance;
* the port's dense engine against its packed engine (one forward arithmetic,
  two reductions): fid, zbuf equal and pixels within 1e-6; gradients rtol
  1e-4 atol 1e-5;
* central finite differences of a smooth loss (interior term only: a
  full-screen face, so no silhouette moves) within 2% of the gradient's
  largest magnitude.
"""

import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dirt_tpu
import dirt_tpu_torch
from _torch_port_oracle import (assert_near_oracle, jax_planes,
                                oracle_forward, oracle_vertex_grads,
                                port_slots, vertex_keep)
from _torch_port_scene import SIZE, screen_soup, sphere_scene
from dirt_tpu.ops import binning as jbin
from dirt_tpu.ops import fused_bwd as jfb
from dirt_tpu.ops import raster as jr
from dirt_tpu.ops import raster_bwd as jb
from dirt_tpu.ops import raster_fwd as jf
from dirt_tpu.ops import triangle_setup as jt
from dirt_tpu_torch import convert
from dirt_tpu_torch.ops import _build
from dirt_tpu_torch.ops import binning as tbin
from dirt_tpu_torch.ops import fused_bwd as tfb
from dirt_tpu_torch.ops import packed_bwd as tpb
from dirt_tpu_torch.ops import raster as tr
from dirt_tpu_torch.ops import raster_bwd as tb
from dirt_tpu_torch.ops import raster_fwd as tf
from dirt_tpu_torch.ops import triangle_setup as tt

ATOL_FWD = 5e-6
RAZOR = 0.005


def _t(a):
    return torch.tensor(np.asarray(a))


# --- binning and the face table ----------------------------------------------


def _soup_bbox(num_faces, height, width, seed, spread):
    fv, fa = screen_soup(num_faces, height, width, seed, spread=spread)
    _, _, valid = jt.setup_planes(jnp.asarray(fv), jnp.asarray(fa))
    return np.asarray(jt.face_bboxes(jnp.asarray(fv), valid, height, width))


@pytest.mark.parametrize("height,width,tile_h,tile_w,cap", [
    (64, 128, 32, 128, 80),     # roomy cap
    (96, 256, 32, 128, 16),     # a cap the hot tiles overflow
    (100, 130, 8, 128, 40),     # ragged image, short tiles
    (64, 64, 32, 32, 1),        # cap 1
])
def test_bin_faces_matches_jax(height, width, tile_h, tile_w, cap):
    bbox = _soup_bbox(80, height, width, seed=3, spread=35.0)
    want = jbin.bin_faces(jnp.asarray(bbox), height, width, tile_h, tile_w,
                          cap)
    got = tbin.bin_faces(_t(bbox), height, width, tile_h, tile_w, cap)
    assert got.bins.dtype == got.counts.dtype == torch.int32
    np.testing.assert_array_equal(got.bins.numpy(), np.asarray(want.bins))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))
    assert bool(got.overflow.any()) == (cap <= 16)
    # The column form of the boxes bins the same.
    cols = tuple(_t(bbox[:, k]) for k in range(4))
    again = tbin.bin_faces(cols, height, width, tile_h, tile_w, cap)
    assert torch.equal(again.bins, got.bins)


@pytest.mark.parametrize("num_faces,channels", [(5, 1), (8, 3), (13, 9)])
def test_pack_face_table_matches_jax(num_faces, channels):
    rng = np.random.RandomState(num_faces)
    geo = rng.randn(num_faces, 24).astype(np.float32)
    att = rng.randn(num_faces, 3 * channels).astype(np.float32)
    want = np.asarray(jf.pack_face_table(jnp.asarray(geo), jnp.asarray(att)))
    got = tf.pack_face_table(_t(geo), _t(att)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] % 8 == 0 and got.shape[1] == 17 + 3 * channels


# --- forward -------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _jax_dense_forward(fv, fa, height, width, tile_h, tile_w, cap, bg_chw):
    geo, att, valid = jt.setup_planes(fv, fa)
    bbox = jt.face_bbox_cols(fv, valid, height, width)
    bins = jbin.bin_faces(bbox, height, width, tile_h, tile_w, cap)
    table = jf.pack_face_table(geo, att)
    out = jf.raster_forward(table, bins.bins, bins.counts, bg_chw,
                            tile_h=tile_h, tile_w=tile_w)
    return out, table, bins


def _forward_both(fv, fa, height, width, tile_h, tile_w, cap, seed=0):
    """Both dense forwards on identical tables and bins (padded sizes)."""
    channels = fa.shape[-1]
    bg = np.random.RandomState(seed).rand(channels, height, width)
    bg = bg.astype(np.float32)
    out_j, table, bins = _jax_dense_forward(
        jnp.asarray(fv), jnp.asarray(fa), height, width, tile_h, tile_w, cap,
        jnp.asarray(bg))
    out_t = tf.raster_forward(_t(table), _t(bins.bins), _t(bins.counts),
                              _t(bg), tile_h=tile_h, tile_w=tile_w)
    return [np.asarray(o) for o in out_j], [o.numpy() for o in out_t[:3]]


def _assert_forward_match(out_j, out_t):
    (pix_j, fid_j, z_j), (pix_t, fid_t, z_t) = out_j, out_t
    assert fid_t.dtype == np.int32
    np.testing.assert_array_equal(fid_t, fid_j)
    np.testing.assert_allclose(z_t, z_j, rtol=0, atol=ATOL_FWD)
    np.testing.assert_allclose(pix_t, pix_j, rtol=0, atol=ATOL_FWD)
    assert (fid_t >= 0).any() and (fid_t < 0).any()


_FORWARD_CASES = {
    "sphere": (SIZE, SIZE, 32, 128, 96),
    "soup": (64, 256, 32, 128, 48),
    "soup-small-tiles": (64, 64, 8, 32, 60),
}


def _forward_inputs(kind):
    height, width = _FORWARD_CASES[kind][:2]
    if kind == "sphere":
        clip, colors, faces = sphere_scene()
        fv = np.asarray(jt.screen_from_clip(clip, height, width))[faces]
        return fv, colors[faces]
    return screen_soup(60, height, width, seed=11, channels=2, spread=30.0)


@pytest.mark.parametrize("kind", list(_FORWARD_CASES))
def test_raster_forward_plain_matches_jax(kind):
    fv, fa = _forward_inputs(kind)
    _assert_forward_match(*_forward_both(fv, fa, *_FORWARD_CASES[kind]))


def test_forward_ignores_cap_padding():
    """Slots past a tile's count are never read: garbage there changes
    nothing."""
    fv, fa = _forward_inputs("soup")
    height, width, tile_h, tile_w, cap = _FORWARD_CASES["soup"]
    geo, att, valid = tt.setup_planes(_t(fv), _t(fa))
    bbox = tt.face_bboxes(_t(fv), valid, height, width)
    bins = tbin.bin_faces(bbox, height, width, tile_h, tile_w, cap)
    table = tf.pack_face_table(geo, att)
    bg = torch.zeros(2, height, width)
    want = tf.raster_forward(table, bins.bins, bins.counts, bg,
                             tile_h=tile_h, tile_w=tile_w)
    slot = torch.arange(cap)[None, :]
    dirty = torch.where(slot < bins.counts[:, None], bins.bins,
                        torch.zeros_like(bins.bins))
    got = tf.raster_forward(table, dirty, bins.counts, bg, tile_h=tile_h,
                            tile_w=tile_w)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_coplanar_tie_goes_to_lower_id():
    """Overlapping faces in one plane: every shared pixel goes to the
    lower face id (quarter-pixel coordinates make every setup step exact,
    so the depth planes are exactly equal)."""
    tri = np.array([[10.25, 50.25], [54.0, 49.75], [32.25, 10.5]], np.float32)
    shifted = tri + np.float32([9.0, 3.0])
    xy = np.stack([tri, shifted, tri])
    fv = np.concatenate([xy, np.full((3, 3, 1), 0.25, np.float32),
                         np.ones((3, 3, 1), np.float32)], axis=-1)
    fa = np.stack([np.full((3, 1), v, np.float32) for v in (0.2, 0.5, 0.9)])
    out_j, out_t = _forward_both(fv, fa, 64, 128, 32, 128, 3)
    _assert_forward_match(out_j, out_t)
    fid = out_t[1]
    assert set(np.unique(fid)) == {-1, 0, 1}     # face 2 copies face 0
    fid0 = _forward_both(fv[:1], fa[:1], 64, 128, 32, 128, 1)[1][1]
    assert (fid == 1).any() and not ((fid == 1) & (fid0 == 0)).any()


# --- backward ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _backward_case(kind):
    """One forward per scene, shared by the backward tests: numpy inputs of
    ``backward_fused`` (image sizes that need padding for the soup)."""
    if kind == "sphere":
        height, width, tile_h, tile_w, cap = SIZE, SIZE, 32, 128, 96
        fv, fa = _forward_inputs("sphere")
    else:
        height, width, tile_h, tile_w, cap = 50, 140, 32, 128, 40
        fv, fa = screen_soup(40, height, width, seed=5, channels=2,
                             spread=30.0)
    cfg = jr.RasterConfig(tile_h=tile_h, tile_w=tile_w, bin_cap=cap,
                          engine="dense")
    bg = np.random.RandomState(1).rand(height, width, fa.shape[-1])
    pixels, fid, zbuf, bins = jr._forward_impl(
        jnp.asarray(fv), jnp.asarray(fa), jnp.asarray(bg, jnp.float32), cfg)
    geo, att, _ = jt.setup_planes(jnp.asarray(fv), jnp.asarray(fa))
    grad = np.random.RandomState(2).randn(*pixels.shape).astype(np.float32)
    arrays = tuple(np.asarray(a) for a in (
        geo, att, fid, zbuf, pixels, grad, bins.bins, bins.counts))
    return arrays, (tile_h, tile_w)


def _scaled_close(got, want, rel=1e-6):
    """Every column within ``rel`` of its largest magnitude (+ 1e-6)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max(axis=0, keepdims=True)
    assert (np.abs(got - want) <= rel * scale + 1e-6).all(), \
        np.abs(got - want).max()


@pytest.mark.parametrize("kind", ["sphere", "soup"])
def test_backward_fused_matches_jax(kind):
    arrays, (tile_h, tile_w) = _backward_case(kind)
    want = jb.backward_fused(*(jnp.asarray(a) for a in arrays), tile_h,
                             tile_w)
    got = tb.backward_fused(*(_t(a) for a in arrays), tile_h, tile_w)
    for g, w in zip(got, want):
        _scaled_close(g.numpy(), w)
    assert np.abs(np.asarray(want[0])).max() > 0


@pytest.mark.parametrize("kind", ["sphere", "soup"])
def test_fused_backward_rows_plain_matches_jax(kind):
    """The rows themselves: JAX's kernel on its neighbor maps and
    pre-gathered table, the plain version on the prologue's bits."""
    (geo, att, fid, zbuf, pixels, grad, bins, counts), (tile_h, tile_w) = \
        _backward_case(kind)
    num_faces = geo.shape[0]
    height, width = fid.shape
    hp, wp = -(-height // tile_h) * tile_h, -(-width // tile_w) * tile_w
    pad2 = ((0, hp - height), (0, wp - width))
    fid_p = np.pad(fid, pad2, constant_values=-2)
    zbuf_p = np.pad(zbuf, pad2, constant_values=tf.BIG_Z)
    pix_cf = np.pad(pixels.transpose(2, 0, 1), ((0, 0),) + pad2)
    grad_cf = np.pad(grad.transpose(2, 0, 1), ((0, 0),) + pad2)

    nbrs = jb.neighbor_maps(*(jnp.asarray(a) for a in (fid_p, zbuf_p, pix_cf,
                                                      grad_cf)))
    cap = bins.shape[1]
    pad = -cap % jbin.CHUNK
    bins_j = jnp.pad(jnp.asarray(bins), ((0, 0), (0, pad)),
                     constant_values=num_faces)
    geo17 = jnp.concatenate([jnp.asarray(geo)[:, :17],
                             jnp.zeros((1, 17), jnp.float32)])
    want = jfb.fused_backward_rows(
        geo17[bins_j.reshape(-1)], bins_j, jnp.asarray(counts),
        jnp.asarray(fid_p), jnp.asarray(zbuf_p), jnp.asarray(pix_cf),
        jnp.asarray(grad_cf), *(jnp.stack([n[k] for n in nbrs])
                                for k in range(3)),
        num_faces + 1, tile_h=tile_h, tile_w=tile_w)

    _, bits, sval, _, _ = tpb.padded_prologue(
        _t(fid_p), _t(zbuf_p), _t(pix_cf).permute(1, 2, 0),
        _t(grad_cf).permute(1, 2, 0), tile_h, tile_w)
    got = tfb.fused_backward_rows(
        _t(geo), _t(bins), _t(counts), _t(fid_p), bits, sval, _t(pix_cf),
        _t(grad_cf), num_faces + 1, tile_h=tile_h, tile_w=tile_w)
    assert got.shape == want.shape
    _scaled_close(got.numpy(), want)
    assert not got[num_faces:].any()            # sentinel and padding rows


def test_backward_fused_matches_backward_torch():
    """The dense backward against the port's pure engine (no bins, no
    tiles): the same cotangent core, two independent reductions. Within
    1e-5 of the column's scale: the pure engine sums a face's pixels one
    after another in float32."""
    arrays, (tile_h, tile_w) = _backward_case("soup")
    tensors = [_t(a) for a in arrays]
    want = tb.backward_torch(*tensors[:6])
    got = tb.backward_fused(*tensors, tile_h, tile_w)
    for g, w in zip(got, want):
        _scaled_close(g.numpy(), w.numpy(), rel=1e-5)


# --- the op end to end ---------------------------------------------------------

_DISTANCE = {"sphere": 3.0, "crossing": 0.9}


@functools.lru_cache(maxsize=None)
def _scene(kind):
    clip, colors, faces = sphere_scene(distance=_DISTANCE[kind])
    bg = np.random.RandomState(4).rand(SIZE, SIZE, 3).astype(np.float32)
    w = np.random.RandomState(5).randn(SIZE, SIZE, 3).astype(np.float32)
    return bg, clip, colors, faces, w


def _jax_run(kind, clip, engine):
    bg, verts, colors, faces, w = _scene(kind)
    cfg = jr.RasterConfig(engine=engine)
    aux = dirt_tpu.rasterise_with_aux(bg, verts, colors, faces, config=cfg,
                                      clip=clip)
    _, vjp_fn = jax.vjp(
        lambda b, v, c: dirt_tpu.rasterise(b, v, c, faces, config=cfg,
                                           clip=clip),
        jnp.asarray(bg), jnp.asarray(verts), jnp.asarray(colors))
    return [np.asarray(a) for a in aux], \
        [np.asarray(g) for g in vjp_fn(jnp.asarray(w))]


def _torch_run(kind, clip, config):
    bg, verts, colors, faces, w = _scene(kind)
    bg_t, v_t, c_t, f_t = convert.scene_from_numpy(bg, verts, colors, faces,
                                                   "cpu")
    leaves = [t.clone().requires_grad_() for t in (bg_t, v_t, c_t)]
    out = dirt_tpu_torch.rasterise_with_aux(*leaves, f_t, config=config,
                                            clip=clip)
    (out[0] * torch.tensor(w)).sum().backward()
    return [o.detach().numpy() for o in out], [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("kind,clip,engine", [
    ("sphere", False, "dense"),
    ("sphere", True, "auto"),
    ("crossing", True, "dense"),
])
def test_rasterise_dense_matches_jax_vjp(kind, clip, engine):
    (pix_j, fid_j, z_j, ovf_j), (dbg_j, dv_j, dc_j) = _jax_run(kind, clip,
                                                               engine)
    config = tr.RasterConfig(engine=engine)
    (pix_t, fid_t, z_t, ovf_t), (dbg_t, dv_t, dc_t) = _torch_run(
        kind, clip, config)
    assert bool(ovf_t) is bool(ovf_j) is False
    differ = fid_t != fid_j
    assert differ.mean() <= RAZOR, f"{differ.mean():.4%} fids differ"
    bg, verts, colors, faces, w = _scene(kind)
    oracle = oracle_forward(bg, verts, colors, faces, clip)
    for out in ((pix_t, fid_t, z_t), (pix_j, fid_j, z_j)):
        assert_near_oracle(*out, oracle, atol=1e-5, razor=RAZOR)
    assert (fid_t >= 0).mean() > 0.2
    agree = ~differ
    np.testing.assert_allclose(dbg_t[agree], dbg_j[agree], rtol=0, atol=1e-6)
    np.testing.assert_allclose(dc_t, dc_j, rtol=1e-4, atol=1e-5)
    # Vertices of faces on razor pixels see another owner, and those of
    # faces whose boundary decision flips between the packages see
    # another pair term: hold the port to the oracle there instead.
    slots = port_slots(bg, verts, colors, faces, config, clip)
    geo_j = jax_planes(bg, verts, colors, faces, config, clip)
    keep = vertex_keep(faces, len(dv_t), fid_t, fid_j, slots, z_j,
                       geo_j)
    assert keep.mean() > 0.9
    np.testing.assert_allclose(dv_t[keep], dv_j[keep], rtol=1e-3, atol=1e-3)
    if not keep.all():
        dv_o, _ = oracle_vertex_grads(bg, verts, colors, faces, w, slots,
                                      config, clip)
        np.testing.assert_allclose(dv_t[~keep], dv_o[~keep], rtol=1e-3,
                                   atol=1e-3)
    assert np.abs(dv_t).max() > 0.1


@pytest.mark.parametrize("kind,clip", [("sphere", False), ("crossing", True)])
def test_dense_matches_packed_engine(kind, clip):
    """One scene through the port's two engines: the same image, the same
    gradients (counterpart of tests/test_raster_forward.py's and
    tests/test_raster_grad.py's packed-vs-dense checks)."""
    bg, verts, _, faces, _ = _scene(kind)
    packed = dirt_tpu_torch.suggest_raster_config(
        torch.tensor(verts), torch.tensor(faces), SIZE, SIZE,
        config=tr.RasterConfig(engine="packed"), clip=clip)
    out_d, grads_d = _torch_run(kind, clip, tr.RasterConfig(engine="dense"))
    out_p, grads_p = _torch_run(kind, clip, packed)
    assert not out_d[3] and not out_p[3]
    np.testing.assert_array_equal(out_d[1], out_p[1])
    np.testing.assert_array_equal(out_d[2], out_p[2])
    np.testing.assert_allclose(out_d[0], out_p[0], rtol=0, atol=1e-6)
    for g_d, g_p in zip(grads_d, grads_p):
        np.testing.assert_allclose(g_d, g_p, rtol=1e-4, atol=1e-5)


def test_small_bin_cap_raises_the_flag_in_both():
    bg, verts, colors, faces, _ = _scene("sphere")
    small = dict(engine="dense", bin_cap=4)
    ovf_j = dirt_tpu.rasterise_with_aux(
        bg, verts, colors, faces, config=jr.RasterConfig(**small),
        clip=False)[3]
    out_t = dirt_tpu_torch.rasterise_with_aux(
        *convert.scene_from_numpy(bg, verts, colors, faces, "cpu"),
        config=tr.RasterConfig(**small), clip=False)
    assert bool(ovf_j) and bool(out_t[3])
    fv = tt.screen_from_clip(torch.tensor(verts), SIZE, SIZE)[
        torch.tensor(faces).long()]
    flags = tr.check_bin_overflow(fv, torch.tensor(colors)[
        torch.tensor(faces).long()], torch.tensor(bg),
        tr.RasterConfig(**small))
    assert flags.dtype == torch.bool and flags.any() and flags.ndim == 1


@pytest.mark.parametrize("num_faces,num_tiles,bin_cap", [
    (2208, 16, None), (12, 2, None), (10224, 128, None), (500, 4, 64),
    (3, 1, 64), (0, 1, None),
])
def test_resolve_bin_cap_matches_jax(num_faces, num_tiles, bin_cap):
    want = jr.resolve_bin_cap(jr.RasterConfig(bin_cap=bin_cap), num_faces,
                              num_tiles)
    got = tr.resolve_bin_cap(tr.RasterConfig(bin_cap=bin_cap), num_faces,
                             num_tiles)
    assert got == want


def test_finite_differences_interior():
    """A face covering the whole image (no silhouette in view): the loss is
    smooth in the attributes and the depth-preserving vertex moves, and the
    analytic gradient matches central differences."""
    size = 32
    fv = np.array([[[-40.0, -30.0, 0.1, 1.0], [120.0, -20.0, 0.3, 0.8],
                    [10.0, 150.0, 0.2, 1.2]]], np.float32)
    fa = np.random.RandomState(0).rand(1, 3, 2).astype(np.float32)
    w = torch.tensor(np.random.RandomState(1).randn(size, size, 2)
                     .astype(np.float32)).double()
    cfg = tr.RasterConfig(engine="dense", tile_h=8, tile_w=32)

    def loss(fv_t, fa_t):
        pix, fid, _, _ = tr.rasterize_screen(fv_t, fa_t,
                                             torch.zeros(size, size, 2), cfg)
        assert (fid == 0).all()
        return (pix.double() * w).sum()

    fv_t = torch.tensor(fv, requires_grad=True)
    fa_t = torch.tensor(fa, requires_grad=True)
    loss(fv_t, fa_t).backward()
    for leaf, arr, eps in ((fa_t, fa, 1e-2), (fv_t, fv, 5e-2)):
        num = np.zeros_like(arr)
        for idx in np.ndindex(*arr.shape):
            hi, lo = arr.copy(), arr.copy()
            hi[idx] += eps
            lo[idx] -= eps
            args = ((torch.tensor(hi), fa_t.detach()) if leaf is fv_t
                    else (fv_t.detach(), torch.tensor(hi)))
            args_lo = ((torch.tensor(lo), fa_t.detach()) if leaf is fv_t
                       else (fv_t.detach(), torch.tensor(lo)))
            num[idx] = float(loss(*args) - loss(*args_lo)) / (2 * eps)
        got = leaf.grad.numpy()
        assert np.abs(got - num).max() <= 0.02 * np.abs(num).max(), \
            (np.abs(got - num).max(), np.abs(num).max())


# --- the streaming configs, other devices, and the build's hash ---------------


@pytest.mark.parametrize("config", [
    tr.RasterConfig(engine="csr"),
    tr.RasterConfig(streaming=True),
    tr.RasterConfig(engine="dense", streaming=True),
])
def test_streaming_engine_raises(config):
    """These configs used to raise; the streaming engine now renders them,
    fids equal to ``dirt_tpu``'s and both renders near the oracle under the
    end-to-end tolerance above (its own tests are in
    tests/test_torch_csr.py)."""
    bg, verts, colors, faces, _ = _scene("sphere")
    pix_j, fid_j, z_j, ovf_j = (np.asarray(o) for o in (
        dirt_tpu.rasterise_with_aux(
            bg, verts, colors, faces, config=jr.RasterConfig(
                **config._asdict()), clip=False)))
    pix_t, fid_t, z_t, ovf_t = (o.numpy() for o in (
        dirt_tpu_torch.rasterise_with_aux(
            *convert.scene_from_numpy(bg, verts, colors, faces, "cpu"),
            config=config, clip=False)))
    assert bool(ovf_t) is bool(ovf_j) is False
    differ = fid_t != fid_j
    assert differ.mean() <= RAZOR, f"{differ.mean():.4%} fids differ"
    oracle = oracle_forward(bg, verts, colors, faces, clip=False)
    for out in ((pix_t, fid_t, z_t), (pix_j, fid_j, z_j)):
        assert_near_oracle(*out, oracle, atol=1e-5, razor=RAZOR)
    assert (fid_t >= 0).mean() > 0.2


def test_other_devices_raise():
    """No fallback: only CPU tensors take the plain versions."""
    table = torch.zeros(8, 20, device="meta")
    bins = torch.zeros(1, 4, dtype=torch.int32, device="meta")
    counts = torch.zeros(1, dtype=torch.int32, device="meta")
    bg = torch.zeros(1, 8, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tf.raster_forward(table, bins, counts, bg, tile_h=8, tile_w=32)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfb.fused_backward_rows(
            table, bins, counts, bins, bins, bg, bg, bg, 2, tile_h=8,
            tile_w=32)


def test_header_edit_rebuilds_both_backward_kernels(monkeypatch, tmp_path):
    """The library's name hashes the source and the csrc headers it
    includes, directly or through another header: an edited header renames
    the libraries of the kernels that include it and leaves the others."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    names = ("raster_fwd_packed", "packed_prologue", "packed_bwd",
             "raster_fwd_dense", "fused_bwd", "raster_fwd_csr",
             "fused_bwd_csr", "scatter_faces", "scatter_faces_csr",
             "subtile_swap")
    users = {
        "cotangent_core.cuh": {"packed_bwd", "fused_bwd", "fused_bwd_csr"},
        "fused_rows.cuh": {"fused_bwd", "fused_bwd_csr"},
        "scatter_rows.cuh": {"scatter_faces", "scatter_faces_csr",
                             "fused_bwd", "fused_bwd_csr"},
        "raster_tile.cuh": {"raster_fwd_dense", "raster_fwd_csr"},
    }
    for header_name, want in users.items():
        header = csrc / header_name
        assert {n for n in names
                if header in _build.source_files(n)} == want
        before = {n: _build.library_path(n) for n in names}
        header.write_text(header.read_text() + "\n// edited\n")
        changed = {n for n in names if _build.library_path(n) != before[n]}
        assert changed == want
