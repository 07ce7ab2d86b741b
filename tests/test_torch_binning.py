"""dirt_tpu_torch packed binning and caps vs dirt_tpu.

Tolerance: none. Binning is integer work, so every ``PackedBins`` field
(entries, chunk map, run offsets and lengths, pool backpointers, the
overflow flag) and every measured cap must be equal to JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_scene import SIZE, screen_soup, sphere_scene
from dirt_tpu.ops import binning as jb
from dirt_tpu.ops import raster as jr
from dirt_tpu.ops import triangle_setup as jt
from dirt_tpu_torch.ops import binning as tb
from dirt_tpu_torch.ops import raster as tr
from dirt_tpu_torch.ops import triangle_setup as tt

_FIELDS = ("entries", "chunk_tile", "start_block", "n_iters", "overflow",
           "iter_off", "strip_iters", "pair_rows", "pool_offs")

_jax_bin = jax.jit(
    jb.bin_faces_packed, static_argnums=(1, 2, 3, 4, 5, 6),
    static_argnames=("pool_cap", "work_cap"),
)


@functools.lru_cache(maxsize=None)
def _scene(kind):
    """(face_verts_screen [F, 3, 4], height, width, tile_h) as numpy."""
    if kind == "sphere":
        clip, _, faces = sphere_scene()
        fv = np.asarray(jt.screen_from_clip(clip, SIZE, SIZE))[faces]
        return fv, SIZE, SIZE, 32
    fv, _ = screen_soup(90, 192, 256, seed=7, spread=40.0)
    return fv, 192, 256, 64


def _bin_inputs(fv, height, width):
    fa = np.zeros(fv.shape[:2] + (1,), np.float32)
    valid = tt.setup_planes(torch.tensor(fv), torch.tensor(fa))[2]
    bbox_t = tt.face_bbox_cols(torch.tensor(fv), valid, height, width)
    bbox_j = tuple(jnp.asarray(c.numpy()) for c in bbox_t)
    edges_j = jt.edge_filter_cols(fv)
    edges_t = tt.edge_filter_cols(torch.tensor(fv))
    return bbox_j, bbox_t, edges_j, edges_t


def _assert_bins_equal(pj, pt):
    for name in _FIELDS:
        a, b = getattr(pj, name), getattr(pt, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert b.dtype in (torch.int32, torch.bool), name
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=name)


# (scene, cap overrides, overflow expected): auto caps, then each cap
# undersized on its own — all four must raise the flag in both packages.
_CASES = {
    "sphere_auto": ("sphere", {}, False),
    "soup_auto": ("soup", {}, False),
    "soup_no_edges": ("soup", {"edges": False}, False),
    "small_budget": ("sphere", {"budget": 256}, True),
    "small_expand": ("sphere", {"expand": 4}, True),
    "small_pool": ("sphere", {"pool_cap": 800}, True),
    "small_work": ("sphere", {"work_cap": 400}, True),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_bin_faces_packed_matches(case):
    kind, kw, want_overflow = _CASES[case]
    fv, height, width, tile_h = _scene(kind)
    bbox_j, bbox_t, edges_j, edges_t = _bin_inputs(fv, height, width)
    if not kw.get("edges", True):
        edges_j = edges_t = None
    tiles_y, tiles_x, strips, groups = tb.packed_grid(
        height, width, tile_h, 128)
    nf = fv.shape[0]
    expand = kw.get("expand", tb.auto_packed_expand(
        nf, tiles_y * tiles_x * strips * groups))
    budget = kw.get("budget", tb.auto_packed_budget(
        nf, height, width, tile_h, 128, expand))
    pj = _jax_bin(bbox_j, height, width, tile_h, 128, budget, expand,
                  edges=edges_j, pool_cap=kw.get("pool_cap"),
                  work_cap=kw.get("work_cap"))
    pt = tb.bin_faces_packed(bbox_t, height, width, tile_h, 128, budget,
                             expand, edges=edges_t,
                             pool_cap=kw.get("pool_cap"),
                             work_cap=kw.get("work_cap"))
    _assert_bins_equal(pj, pt)
    assert bool(pt.overflow) is want_overflow


def test_auto_caps_match():
    for nf in (1, 300, 4096, 4097, 10224, 100_000):
        for height, width, tile_h in ((128, 128, 32), (256, 384, 32),
                                      (1024, 1024, 64)):
            nsid = tb.packed_grid(height, width, tile_h, 128)
            nsid = nsid[0] * nsid[1] * nsid[2] * nsid[3]
            exp = tb.auto_packed_expand(nf, nsid)
            assert exp == jb.auto_packed_expand(nf, nsid)
            for e in (None, exp):
                assert tb.auto_packed_budget(
                    nf, height, width, tile_h, 128, e) == \
                    jb.auto_packed_budget(nf, height, width, tile_h, 128, e)
            assert tb.auto_pool_cap(nf, exp) == jb.auto_pool_cap(nf, exp)
    assert (tb.SUB_H, tb.SUB_W, tb.GROUPS, tb.PACK_CHUNK, tb.PACK_ITERS,
            tb.POOL_ALIGN) == (jb.SUB_H, jb.SUB_W, jb.GROUPS, jb.PACK_CHUNK,
                               jb.PACK_ITERS, jb.POOL_ALIGN)


@pytest.mark.parametrize("kind", ["sphere", "soup"])
def test_suggest_and_count_match(kind):
    fv, height, width, tile_h = _scene(kind)
    base = jr.RasterConfig(engine="packed")
    want = jr.suggest_config(jnp.asarray(fv), height, width, base)
    got = tr.suggest_config(torch.tensor(fv), height, width,
                            tr.RasterConfig(engine="packed"))
    assert got._asdict() == want._asdict()

    bbox = tt.face_bboxes(
        torch.tensor(fv),
        tt.setup_planes(torch.tensor(fv),
                        torch.zeros(fv.shape[:2] + (1,)))[2],
        height, width)
    for th in (32, 64):
        counts_j, span_j = jr.count_bins_exact(
            jnp.asarray(bbox.numpy()), height, width, th, 128)
        counts_t, span_t = tr.count_bins_exact(bbox, height, width, th, 128)
        np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
        assert int(span_t) == int(span_j)
        for margin in (1.0, 1.25):
            assert tr.count_packed_exact(
                bbox, height, width, th, 128, margin) == \
                jr.count_packed_exact(
                    jnp.asarray(bbox.numpy()), height, width, th, 128, margin)
            assert tr.count_packed_exact(
                None, height, width, th, 128, margin,
                face_verts_screen=torch.tensor(fv)) == \
                jr.count_packed_exact(
                    None, height, width, th, 128, margin,
                    face_verts_screen=jnp.asarray(fv))


def test_suggested_caps_clear_the_flag():
    fv, height, width, tile_h = _scene("sphere")
    cfg = tr.suggest_config(torch.tensor(fv), height, width,
                            tr.RasterConfig(engine="packed"))
    bbox_j, bbox_t, _, edges_t = _bin_inputs(fv, height, width)
    pt = tb.bin_faces_packed(bbox_t, height, width, cfg.tile_h, 128,
                             cfg.budget, cfg.expand_cap, edges=edges_t,
                             pool_cap=cfg.pool_cap, work_cap=cfg.work_cap)
    assert not bool(pt.overflow)
