"""What the H100's packed backward (K2) and dense fused backward (K6) rest
on, held on the CPU on the binning and forward outputs of both packages.

K2 sums each budget row over its own pixels only: a block takes a few 8 x
16 subtiles alone, and a counting sort of each subtile's pixels by owner
lists each row's pixels in the subtile's row-major order. That is right
because every covered pixel has exactly one owner among the live rows of
its own (strip, lane group) run (a face is binned at most once per
subtile, and the forward draws only binned faces), so a row owns pixels of
its own subtile only. K6 takes a tile's list in chunks of slots and finds a
face's slot in each tile by binary search: that is right because each
tile's list ascends, names each face at most once, and holds the owner of
every covered pixel of the tile.

The inputs are seeded scenes: a screen-space soup binned and rendered by
``dirt_tpu`` (JAX on the CPU, Pallas in interpret mode) and handed over as
numpy arrays, and a UV sphere binned and rendered by the port (CPU
tensors, so every kernel wrapper takes its plain version). The checks are
exact (integers, and one sum recomputed in the same order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_scene import SIZE, screen_soup, sphere_scene
from dirt_tpu.ops import binning as jbin
from dirt_tpu.ops import raster as jr
from dirt_tpu.ops import raster_fwd as jf
from dirt_tpu.ops import triangle_setup as jt
from dirt_tpu_torch.ops import binning as tbin
from dirt_tpu_torch.ops import fused_bwd as tfb
from dirt_tpu_torch.ops import packed_bwd as tpb
from dirt_tpu_torch.ops import raster as tr
from dirt_tpu_torch.ops import raster_fwd as tf
from dirt_tpu_torch.ops import triangle_setup as tt
from dirt_tpu_torch.ops.binning import GROUPS, PACK_ITERS, SUB_H, SUB_W
from dirt_tpu_torch.ops.raster_fwd import COL_ID


def _t(a):
    return torch.tensor(np.asarray(a))


# --- the packed engine: one owner per covered pixel, in its own subtile ------


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_packed_forward(fv, fa, bg, gp, config):
    pixels, fid, zbuf, bins = jr._forward_impl(fv, fa, bg, config)
    geo, att, _ = jt.setup_planes(fv, fa)
    return pixels, fid, zbuf, bins, geo, att


def _packed_prep(source):
    """The packed backward's prepared inputs (image layout) and the number
    of faces, on dirt_tpu's bins and forward (a soup) or the port's (a
    sphere)."""
    if source == "dirt_tpu":
        height, width = 96, 160
        fv, fa = screen_soup(80, height, width, seed=21, spread=22.0)
        rng = np.random.RandomState(21)
        bg = rng.rand(height, width, 3).astype(np.float32)
        gp = rng.randn(height, width, 3).astype(np.float32)
        config = jr.suggest_config(jnp.asarray(fv), height, width,
                                   jr.RasterConfig(engine="packed"))
        # Wider than suggested: the reference's count undercounts with two
        # tile columns (ROADMAP Queue 3); these tests check ownership.
        config = config._replace(budget=2 * config.budget)
        out = jax.tree_util.tree_map(np.asarray, _jax_packed_forward(
            jnp.asarray(fv), jnp.asarray(fa), jnp.asarray(bg),
            jnp.asarray(gp), config))
        pixels, fid, zbuf, bins, geo, att = out
        # Without JAX's gathered rows: the port's backward builds its face
        # table from the planes and reads it through the entries.
        bins = tbin.PackedBins(*(None if v is None else _t(v)
                                 for v in bins._replace(rows=None)))
        tile_h, tile_w = config.concrete(height).tile_h, config.tile_w
        geo, att, fid, zbuf, pixels = map(_t, (geo, att, fid, zbuf, pixels))
        num_faces = fv.shape[0]
    else:
        clip, colors, faces = sphere_scene(16, 24)
        fv = tt.screen_from_clip(torch.tensor(clip), SIZE, SIZE)[faces]
        fa = torch.tensor(colors)[faces]
        rng = np.random.RandomState(22)
        bg = torch.tensor(rng.rand(SIZE, SIZE, 3).astype(np.float32))
        gp = rng.randn(SIZE, SIZE, 3).astype(np.float32)
        config = tr.suggest_config(fv, SIZE, SIZE,
                                   tr.RasterConfig(engine="packed"))
        config = config._replace(budget=2 * config.budget)
        table2, bins, bg_chw, cfg = tr.prepare_packed(fv, fa, bg, config)
        tile_h, tile_w = cfg.tile_h, cfg.tile_w
        pix_cf, fid, zbuf = tf.raster_forward_packed(
            table2, bins, bg_chw, tile_h=tile_h, tile_w=tile_w)
        pixels = pix_cf.permute(1, 2, 0)
        geo, att, _ = tt.setup_planes(fv, fa)
        num_faces = fv.shape[0]
    assert not bool(bins.overflow)
    prep = tpb.prepare_backward_packed(geo, att, fid, zbuf, pixels,
                                       torch.tensor(gp), bins, tile_h, tile_w)
    return prep, num_faces


def _live_rows(prep):
    """(tile, strip, budget rows [N, GROUPS]) of every live iteration: the
    strip's run clamped to its tile's n_iters, as the kernel walks it."""
    bins = prep.bins
    _, hp, wp = prep.pix_cf.shape
    tiles = (hp // prep.tile_h) * (wp // prep.tile_w)
    strips = prep.tile_h // SUB_H
    lo = bins.iter_off.long().reshape(tiles, strips)
    hi = torch.minimum(lo + bins.strip_iters.long().reshape(tiles, strips),
                       bins.n_iters.long()[:, None])
    n = torch.clamp(hi - lo, min=0).reshape(-1)
    ts = torch.repeat_interleave(torch.arange(tiles * strips), n)
    first = torch.cumsum(n, 0) - n
    it = lo.reshape(-1)[ts] + torch.arange(ts.numel()) - first[ts]
    t = ts // strips
    rows = ((bins.start_block.long()[t] * PACK_ITERS + it) * GROUPS)[:, None] \
        + torch.arange(GROUPS)
    return t, ts % strips, rows


def _pixel_owners(prep, num_faces):
    """The owning budget row of every pixel of the padded image (-1 where
    none), found by key (subtile, face) among the live rows, the number of
    live rows that match each covered pixel (0 elsewhere), and the live
    rows' ids and keys."""
    _, hp, wp = prep.pix_cf.shape
    tiles_x = wp // prep.tile_w
    strips = prep.tile_h // SUB_H
    t, s, rows = _live_rows(prep)
    table = tpb._entry_table(prep)
    ids = table[prep.bins.entries.long() // 8, COL_ID].long()[rows]  # [N, G]
    span = num_faces + 2
    subtile = ((t * strips + s)[:, None] * GROUPS + torch.arange(GROUPS))
    row_key = (subtile * span + ids).reshape(-1)
    y = torch.arange(hp)[:, None]
    x = torch.arange(wp)[None, :]
    pix_sub = (((y // prep.tile_h) * tiles_x + x // prep.tile_w) * strips
               + (y % prep.tile_h) // SUB_H) * GROUPS + (x % prep.tile_w) // SUB_W
    fid = prep.fid_p.long()
    pix_key = pix_sub * span + torch.clamp(fid, min=0)
    order = torch.argsort(row_key)
    sorted_keys = row_key[order]
    at = torch.searchsorted(sorted_keys, pix_key.reshape(-1))
    upto = torch.searchsorted(sorted_keys, pix_key.reshape(-1), right=True)
    matches = torch.where(fid >= 0, (upto - at).reshape(hp, wp), 0)
    owner = rows.reshape(-1)[order[torch.clamp(at, max=row_key.numel() - 1)]]
    owner = torch.where((fid >= 0) & (matches > 0), owner.reshape(hp, wp), -1)
    return owner, matches, (ids.reshape(-1), row_key)


@pytest.mark.parametrize("source", ["dirt_tpu", "port"])
def test_every_covered_pixel_has_one_owner_in_its_own_subtile_run(source):
    prep, num_faces = _packed_prep(source)
    owner, matches, (ids, row_key) = _pixel_owners(prep, num_faces)
    covered = prep.fid_p >= 0
    assert int(covered.sum()) > 1000
    # Exactly one live row of the pixel's (strip, lane group) run names its
    # face.
    assert bool((matches[covered] == 1).all())
    assert bool((owner[covered] >= 0).all())
    # A run names a real face at most once (padding rows name the
    # sentinel, face num_faces), and names no other id.
    real = ids < num_faces
    assert bool((ids[real] >= 0).all()) and bool((ids[~real] == num_faces)
                                                 .all())
    assert torch.unique(row_key[real]).numel() == int(real.sum())


@pytest.mark.parametrize("source", ["dirt_tpu", "port"])
def test_each_row_sums_its_own_subtile_pixels_in_row_major_order(source):
    """The entry rows are, bit for bit, each row's owned pixels (found by
    key above, so all in the row's own 8 x 16 subtile) summed in the
    subtile's row-major order: what K2's second pass sums."""
    prep, num_faces = _packed_prep(source)
    owner, _, _ = _pixel_owners(prep, num_faces)
    _, hp, wp = prep.pix_cf.shape
    cot = tfb.pixel_rows_plain(prep.geo, prep.fid_p, prep.bits, prep.sval,
                               prep.pix_cf, prep.grad_cf)      # [hp * wp, K]
    n_out = prep.budget_chunks * tbin.PACK_CHUNK
    # Pixels by (subtile, position in the subtile's row-major order).
    sub = owner.reshape(hp // SUB_H, SUB_H, wp // SUB_W, SUB_W)
    sub = sub.permute(0, 2, 1, 3).reshape(-1, SUB_H * SUB_W)
    cot = cot.reshape(hp // SUB_H, SUB_H, wp // SUB_W, SUB_W, -1)
    cot = cot.permute(0, 2, 1, 3, 4).reshape(sub.shape[0], SUB_H * SUB_W, -1)
    dest = torch.where(sub >= 0, sub, n_out)
    want = torch.zeros((n_out + 1, prep.k_cols))
    for p in range(SUB_H * SUB_W):
        want.index_add_(0, dest[:, p], cot[:, p])
    got = tpb.packed_entry_rows(prep)
    assert torch.equal(got, want[:n_out])
    assert int((got != 0).any(1).sum()) > 100


# --- the dense engine: ascending lists that hold every owner -----------------


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _jax_dense_forward(fv, fa, height, width, tile_h, tile_w, cap):
    geo, att, valid = jt.setup_planes(fv, fa)
    bbox = jt.face_bbox_cols(fv, valid, height, width)
    bins = jbin.bin_faces(bbox, height, width, tile_h, tile_w, cap)
    table = jf.pack_face_table(geo, att)
    bg = jnp.zeros((fa.shape[-1], height, width), jnp.float32)
    _, fid, _ = jf.raster_forward(table, bins.bins, bins.counts, bg,
                                  tile_h=tile_h, tile_w=tile_w)
    return fid, bins.bins, bins.counts


def _dense_lists(source):
    """(fid [Hp, Wp], bins [T, cap], counts [T], tile_h, tile_w, faces) of
    dirt_tpu's dense forward on a soup or the port's on a sphere."""
    if source == "dirt_tpu":
        height, width, tile_h, tile_w, cap = 96, 256, 32, 128, 64
        fv, fa = screen_soup(90, height, width, seed=23, spread=28.0)
        fid, bins, counts = (_t(a) for a in _jax_dense_forward(
            jnp.asarray(fv), jnp.asarray(fa), height, width, tile_h, tile_w,
            cap))
        return fid, bins, counts, tile_h, tile_w, fv.shape[0]
    clip, colors, faces = sphere_scene(16, 24)
    fv = tt.screen_from_clip(torch.tensor(clip), SIZE, SIZE)[faces]
    fa = torch.tensor(colors)[faces]
    config = tr.suggest_config(fv, SIZE, SIZE, tr.RasterConfig(engine="dense"))
    table, bins, bg_chw, cfg = tr.prepare_dense(
        fv, fa, torch.zeros((SIZE, SIZE, 3)), config)
    assert not bool(bins.overflow.any())
    _, fid, _, _ = tf.raster_forward(table, bins.bins, bins.counts, bg_chw,
                                     tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    return fid, bins.bins, bins.counts, cfg.tile_h, cfg.tile_w, fv.shape[0]


@pytest.mark.parametrize("source", ["dirt_tpu", "port"])
def test_dense_lists_ascend_and_hold_every_owner(source):
    fid, bins, counts, tile_h, tile_w, num_faces = _dense_lists(source)
    hp, wp = fid.shape
    tiles_x = wp // tile_w
    assert bins.shape[0] == (hp // tile_h) * tiles_x
    assert int(counts.max()) <= bins.shape[1] and int(counts.min()) >= 0
    slot = torch.arange(bins.shape[1])[None, :]
    live = slot < counts[:, None].long()
    # Ascending and each face at most once: strictly increasing live slots,
    # all of them real faces.
    step = bins[:, 1:] > bins[:, :-1]
    assert bool((step | ~live[:, 1:]).all())
    assert bool(((bins >= 0) & (bins < num_faces))[live].all())
    # The owner of every covered pixel is in its tile's list.
    y = torch.arange(hp)[:, None]
    x = torch.arange(wp)[None, :]
    tile = ((y // tile_h) * tiles_x + x // tile_w).expand(hp, wp)
    covered = fid >= 0
    listed = torch.zeros((bins.shape[0], num_faces + 1), dtype=torch.bool)
    t_idx = torch.arange(bins.shape[0])[:, None].expand_as(bins)
    listed[t_idx[live], bins[live].long()] = True
    assert bool(listed[tile[covered], fid[covered].long()].all())
    assert int(covered.sum()) > 1000 and int((counts == 0).sum()) >= 0
