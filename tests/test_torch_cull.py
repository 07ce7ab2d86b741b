"""The fact the streaming forward kernel's cull rests on, on the CPU.

``csrc/raster_tile.cuh::raster_strip_culled`` tests a listed face only at
pixels whose strip and warp span meet the face's cull box
(``raster_fwd.csr_cull_boxes``, worked out from the face's table row with
an allowance for float32 rounding). That gives the un-culled walk's result
bit for bit only if no listed face passes the coverage and depth test
(three edges >= 0, depth in [-1, 1]; the strict z-buffer test only narrows
it) at a pixel of the padded image outside its cull box. These tests
evaluate that test for every listed face at every pixel of its tile, with
the plain version's expressions, and count the pixels outside: on the
streaming scenes of ``tests/test_torch_csr.py`` and ``test_torch_cuda.py``,
on a 37 x 131 image, and on needle-thin faces, whose far corners lie up to
a million pixels off the image. There must be none. The boxes the faces
were binned from (``StreamBins.bbox``, from the corners) do not bound the
passes of such needles. They need no card and no JAX.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import dirt_tpu_torch
from _torch_port_scene import (SIZE, clip_soup, needle_soup, screen_soup,
                               sphere_scene)
from dirt_tpu_torch import convert
from dirt_tpu_torch.ops import raster
from dirt_tpu_torch.ops.binning import CHUNK
from dirt_tpu_torch.ops import raster_fwd as tf
from test_torch_cuda import _CSR_CASES, _csr_forward


def _raster_inputs(bg, verts, colors, faces, config, clip):
    """What the default API hands the raster op: (face_verts_screen,
    face_attrs, background, concrete config)."""
    seen = []
    inner = raster._forward_impl

    def record(face_verts, face_attrs, background, config):
        seen.append((face_verts, face_attrs, background, config))
        return inner(face_verts, face_attrs, background, config)

    tensors = convert.scene_from_numpy(bg, verts, colors, faces, "cpu")
    with mock.patch.object(raster, "_forward_impl", record):
        dirt_tpu_torch.rasterise_with_aux(*tensors, config=config, clip=clip)
    (inputs,) = seen
    return inputs


def _soup(height, width, num_faces, seed, spread, channels=3, needles=None,
          **caps):
    if needles is None:
        fv, fa = screen_soup(num_faces, height, width, seed=seed,
                             channels=channels, spread=spread)
    else:
        fv, fa = needle_soup(num_faces, height, width, seed, *needles,
                             channels=channels)
    bg = np.random.RandomState(seed).rand(height, width, channels)
    config = raster.RasterConfig(streaming=True, **caps)
    return (torch.tensor(fv), torch.tensor(fa),
            torch.tensor(bg.astype(np.float32)), config)


def _scene(name):
    """(face_verts_screen, face_attrs, background, config) of one scene."""
    if name == "kernel-case":
        # tests/test_torch_csr.py::_kernel_case: runs of several chunks.
        return _soup(64, 256, 300, 11, 30.0, tile_h=32, tile_w=128,
                     expand_cap=4)
    if name == "37x131":
        # Off the tile multiple both ways, faces reaching past both edges.
        return _soup(37, 131, 120, 5, 40.0, tile_h=16, tile_w=128)
    if name == "37x131-narrow-tiles":
        # Tiles of 40 columns: warps straddle the rows of a strip.
        return _soup(37, 131, 120, 6, 40.0, tile_h=8, tile_w=40)
    if name.startswith("needles"):
        # Needles 5 to 2,000 pixels long, 1e-6 to 1 pixel wide.
        return _soup(128, 256, 300, int(name[-1]), 0.0, needles=((0.7, 3.3),
                     (-6.0, 0.0)), tile_h=32, tile_w=128, bin_cap=2048,
                     expand_cap=64)
    if name.startswith("far-needles"):
        # Needles 1,000 to 1,000,000 pixels long: their far corners lie far
        # off the image.
        return _soup(128, 256, 200, int(name[-1]), 0.0, needles=((3.0, 6.0),
                     (-6.0, 0.0)), tile_h=32, tile_w=128, bin_cap=2048,
                     expand_cap=64)
    if name.startswith("soup"):
        # tests/test_torch_csr.py's op scenes.
        verts, colors, faces, bg = clip_soup(40, 96, seed=0)
        config = raster.RasterConfig(streaming=True, tile_h=16, tile_w=128,
                                     bin_cap=256)
        return _raster_inputs(bg, verts, colors, faces, config,
                              name == "soup-clip")
    if name == "crossing-clip":
        verts, colors, faces = sphere_scene(distance=0.9)
        bg = np.random.RandomState(4).rand(SIZE, SIZE, 3).astype(np.float32)
        return _raster_inputs(bg, verts, colors, faces,
                              raster.RasterConfig(streaming=True), True)
    raise ValueError(name)


def _outside(table, bins, bg_chw, tile_h, tile_w, box):
    """(pixels of the padded image where a listed face passes the coverage
    and depth test outside its box ``box[face]``, such passes in all)."""
    _, hp, wp = bg_chw.shape
    tiles_x = wp // tile_w
    box = box.long()
    outside = passes = 0
    for t in range(bins.counts.shape[0]):
        start = int(bins.start_block[t]) * CHUNK
        faces = bins.entry_face[start:start + int(bins.counts[t])].long()
        if not faces.numel():
            continue
        xs = (t % tiles_x) * tile_w + torch.arange(tile_w)
        ys = (t // tiles_x) * tile_h + torch.arange(tile_h)
        xf = xs.to(torch.float32)[None, None, :] + 0.5
        yf = ys.to(torch.float32)[None, :, None] + 0.5
        m = table[faces][:, :14, None, None]            # [n, 14, 1, 1]

        def cf(q):
            return m[:, q]

        dx = xf - cf(0)
        dy = yf - cf(1)
        e0 = cf(2) * dx + cf(3) * dy + cf(4)
        e1 = cf(5) * dx + cf(6) * dy + cf(7)
        e2 = cf(8) * dx + cf(9) * dy + cf(10)
        zv = cf(11) * dx + cf(12) * dy + cf(13)
        hit = ((torch.minimum(torch.minimum(e0, e1), e2) >= 0.0)
               & (zv >= -1.0) & (zv <= 1.0))           # [n, h, w]
        b = box[faces]
        inside = ((xs[None, None, :] >= b[:, 0, None, None])
                  & (xs[None, None, :] <= b[:, 1, None, None])
                  & (ys[None, :, None] >= b[:, 2, None, None])
                  & (ys[None, :, None] <= b[:, 3, None, None]))
        outside += int((hit & ~inside).sum())
        passes += int(hit.sum())
    return outside, passes


def _bin_boxes(bins, hp, wp, height, width):
    """The boxes the faces were binned from, a box that reaches the image's
    last column (row) taken to reach the padded array's last."""
    box = bins.bbox.long().clone()
    box[:, 1] = torch.where(box[:, 1] == width - 1, wp - 1, box[:, 1])
    box[:, 3] = torch.where(box[:, 3] == height - 1, hp - 1, box[:, 3])
    return box


_SCENES = ["kernel-case", "37x131", "37x131-narrow-tiles", "soup",
           "soup-clip", "crossing-clip", "needles-0", "needles-1",
           "far-needles-0", "far-needles-1", "far-needles-5"]
_ORDINARY = _SCENES[:6]


def _prepared(name):
    fv, fa, bg, config = _scene(name)
    height, width, _ = bg.shape
    table, bins, bg_chw, cfg = raster.prepare_csr(fv, fa, bg, config)
    assert not bool(bins.overflow)
    return table, bins, bg_chw, cfg, height, width


@pytest.mark.parametrize("name", _SCENES)
def test_no_face_passes_outside_its_box(name):
    table, bins, bg_chw, cfg, _, _ = _prepared(name)
    _, hp, wp = bg_chw.shape
    outside, passes = _outside(table, bins, bg_chw, cfg.tile_h, cfg.tile_w,
                               tf.csr_cull_boxes(table, hp, wp))
    assert passes > 0
    assert outside == 0


@pytest.mark.parametrize("case", list(_CSR_CASES))
def test_no_face_passes_outside_its_box_on_the_card_scenes(case):
    """The scenes of the card tests, ``ragged-c9`` (100 x 130 in 32 x 128
    tiles, compared there on the whole padded arrays) among them."""
    _, _, table, bins, bg_chw, cfg, _, _ = _csr_forward("cpu", case)
    _, hp, wp = bg_chw.shape
    outside, passes = _outside(table, bins, bg_chw, cfg.tile_h, cfg.tile_w,
                               tf.csr_cull_boxes(table, hp, wp))
    assert passes > 0
    assert outside == 0


@pytest.mark.parametrize("name", ["far-needles-0", "far-needles-1"])
def test_binning_boxes_do_not_bound_far_needles(name):
    """Why the cull boxes are worked out from the table rows: a needle
    whose far corners lie thousands of pixels off the image passes, by
    float32 rounding, at pixels past the box of its corners, even with
    that box widened at the image's far edges."""
    table, bins, bg_chw, cfg, height, width = _prepared(name)
    _, hp, wp = bg_chw.shape
    outside, _ = _outside(table, bins, bg_chw, cfg.tile_h, cfg.tile_w,
                          _bin_boxes(bins, hp, wp, height, width))
    assert outside > 0


@pytest.mark.parametrize("name", _ORDINARY)
def test_cull_boxes_are_no_larger_than_the_binning_boxes(name):
    """On faces of ordinary shape the cull keeps no more than culling by
    the binning boxes would: every listed face's cull box lies inside its
    binning box (widened at the image's far edges), or is (0, -1, 0, -1)
    when no pixel centre lies in the face's span (the binning box rounds
    the corners outwards to whole pixels, the cull box to the centres). A
    needle's rounding allowance grows with its length over its width:
    those of "needles-0" get boxes up to the whole array."""
    table, bins, bg_chw, _, height, width = _prepared(name)
    _, hp, wp = bg_chw.shape
    listed = torch.unique(
        bins.entry_face[bins.entry_face < bins.bbox.shape[0]]).long()
    cull = tf.csr_cull_boxes(table, hp, wp).long()[listed]
    binned = _bin_boxes(bins, hp, wp, height, width)[listed]
    empty = (cull[:, 0] > cull[:, 1]) | (cull[:, 2] > cull[:, 3])
    assert cull[empty].tolist() == [[0, -1, 0, -1]] * int(empty.sum())
    cull, binned = cull[~empty], binned[~empty]
    assert bool((cull[:, 0] >= binned[:, 0]).all())
    assert bool((cull[:, 1] <= binned[:, 1]).all())
    assert bool((cull[:, 2] >= binned[:, 2]).all())
    assert bool((cull[:, 3] <= binned[:, 3]).all())


def test_cull_boxes_of_rows_that_never_or_always_pass():
    """An invalid face (all-excluding edges) gets no pixel; a row with a
    non-finite coefficient, or whose edges do not close a triangle, gets
    the whole array; a face off the array gets none."""
    fv, fa = screen_soup(4, 40, 200, seed=3)
    fv[1, 1] = fv[1, 0]                               # zero area: invalid
    fv[3, :, 0] += 1000.0                             # right of the array
    table = raster.prepare_csr(torch.tensor(fv), torch.tensor(fa),
                               torch.zeros(40, 200, 3),
                               raster.RasterConfig(streaming=True))[0]
    table = table.clone()
    table[2, 5] = float("nan")
    wide = table[0].clone()
    wide[[2, 3, 5, 6, 8, 9]] = torch.tensor([1.0, 0.0, 1.0, 0.0, -1.0, 0.0])
    table = torch.cat([table, wide[None]])            # parallel edges
    boxes = tf.csr_cull_boxes(table, 40, 256)
    assert boxes[1].tolist() == [0, -1, 0, -1]
    assert boxes[2].tolist() == [0, 255, 0, 39]
    assert boxes[3].tolist() == [0, -1, 0, -1]
    assert boxes[-1].tolist() == [0, 255, 0, 39]
    assert boxes[0, 0] <= boxes[0, 1] and boxes[0, 2] <= boxes[0, 3]


def test_cull_boxes_of_sphere_slivers_stay_small():
    """The faces of the default API's 99,904-face sphere at 1024 x 1024
    (``mesh.uv_sphere(224, 224)``, the bench camera) include slivers whose
    edges lie millionths of a radian apart: a rounding allowance taken over
    the whole array moves their corners by tens of pixels (a face of 8 x 5
    pixels got a box of 113 x 49, 5,537 pixels, which one warp of the
    backward kernels scans alone). Taken over the first round's box, no
    face's cull box holds more pixels than the largest binning box, and
    together they hold fewer than the binning boxes."""
    from dirt_tpu_torch.ops import triangle_setup as tt

    verts, colors, faces = sphere_scene(224, 224)
    idx = torch.tensor(faces).long()
    fv = tt.screen_from_clip(torch.tensor(verts), 1024, 1024)[idx]
    geo, att, valid = tt.setup_planes(fv, torch.tensor(colors)[idx])
    assert fv.shape[0] == 99904 and bool(valid.all())
    binned = tt.face_bboxes(fv, valid, 1024, 1024).long()
    cull = tf.csr_cull_boxes(tf.pack_face_table(geo, att), 1024,
                             1024).long()[:fv.shape[0]]

    def pixels(box):
        return ((box[:, 1] - box[:, 0] + 1).clamp(min=0)
                * (box[:, 3] - box[:, 2] + 1).clamp(min=0))

    assert int(pixels(cull).max()) <= int(pixels(binned).max())
    assert int(pixels(cull).sum()) < int(pixels(binned).sum())
