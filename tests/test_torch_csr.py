"""The streaming (CSR) engine of dirt_tpu_torch vs dirt_tpu's, on the CPU.

The same numpy inputs go through the JAX function (Pallas kernels in
interpret mode, as the root conftest arranges) and the port's (CPU tensors,
so each kernel wrapper takes its plain PyTorch version). Tolerances:

* ``bin_faces_csr``, ``auto_expand_cap``, ``csr_pad_bound``,
  ``resolve_bin_cap`` and ``suggest_raster_config``: every field equal;
* ``raster_forward_csr``: fid equal; zbuf and pixels within 5e-6 absolute
  (the same expressions in the same order; XLA may fuse a multiply into an
  add where PyTorch rounds each step);
* ``fused_backward_rows_csr``: within 1e-5 of the column's largest magnitude
  plus 1e-6 (the JAX kernel sums a face's pixels through f32 matrix
  products and a ``segment_sum``, the plain version through one float64
  ``index_add_``);
* the op end to end against ``jax.vjp``: no fid differs on the random
  soup (at most 0.5% on the sphere crossing the near plane, whose clipped
  vertices come out of XLA-fused arithmetic: the razor-edge policy of
  test_torch_pipeline.py); pixels and zbuf within 5e-6 where fids agree;
  the overflow flag equal; every gradient within 1e-4 of its largest
  magnitude (the vertices of faces on razor pixels, and of faces whose
  boundary decision flips between the packages, left out: there the
  port is held to the float64 oracle's backward, tests/_torch_port_oracle.py);
* the port's streaming engine against its dense engine (one forward
  arithmetic, two list layouts): fid and zbuf equal, pixels within 1e-6,
  gradients within 1e-4 of the largest magnitude.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dirt_tpu
import dirt_tpu_torch
from _torch_port_oracle import (jax_planes, oracle_vertex_grads, port_slots,
                                vertex_keep)
from _torch_port_scene import SIZE, clip_soup, screen_soup, sphere_scene
from dirt_tpu import rasterise_ops as jro
from dirt_tpu.ops import binning as jbin
from dirt_tpu.ops import fused_bwd as jfb
from dirt_tpu.ops import raster as jr
from dirt_tpu.ops import raster_bwd as jb
from dirt_tpu.ops import raster_fwd as jf
from dirt_tpu.ops import triangle_setup as jt
from dirt_tpu_torch import convert
from dirt_tpu_torch import rasterise_ops as tro
from dirt_tpu_torch.core import mesh
from dirt_tpu_torch.ops import binning as tbin
from dirt_tpu_torch.ops import fused_bwd as tfb
from dirt_tpu_torch.ops import packed_bwd as tpb
from dirt_tpu_torch.ops import raster as tr
from dirt_tpu_torch.ops import raster_bwd as tb
from dirt_tpu_torch.ops import raster_fwd as tf
from dirt_tpu_torch.ops import triangle_setup as tt

ATOL_FWD = 5e-6
RAZOR = 0.005
SOUP = 96                       # image size of the random-soup scenes
# The caps of tests/test_streaming.py: 16-row tiles, so the 96^2 image has
# six tiles, and every soup face is listed in several.
CAPS = dict(tile_h=16, tile_w=128, bin_cap=256)


def _t(a):
    return torch.tensor(np.asarray(a))


# --- binning and the caps ------------------------------------------------------


def _random_boxes(num_faces, height, width, seed=3, reach=40):
    """Boxes as tests/test_streaming.py makes them, clipped to the image."""
    rng = np.random.RandomState(seed)
    xmin = rng.randint(0, width - 1, num_faces)
    xmax = xmin + rng.randint(0, reach, num_faces)
    ymin = rng.randint(0, height - 1, num_faces)
    ymax = ymin + rng.randint(0, reach, num_faces)
    return np.stack([xmin, np.minimum(xmax, width - 1), ymin,
                     np.minimum(ymax, height - 1)], -1).astype(np.int32)


def _boxes(kind):
    """(bbox, height, width, tile_h, tile_w, cap, expand_cap, overflows)."""
    if kind == "random":
        return _random_boxes(200, 128, 256), 128, 256, 16, 128, 128, 16, False
    if kind == "tile-over-cap":
        # 700 faces on 16 tiles with a cap of 128: the hot tiles are cut.
        return (_random_boxes(700, 128, 256, seed=4, reach=90), 128, 256, 16,
                128, 100, 16, True)
    if kind == "face-over-expand-cap":
        bbox = _random_boxes(60, 128, 256, seed=5)
        bbox[7] = [0, 255, 0, 127]              # all 16 tiles, cap is 4
        return bbox, 128, 256, 16, 128, 128, 4, True
    if kind == "empty-box":
        bbox = _random_boxes(50, 100, 130, seed=6)
        bbox[0] = bbox[17] = bbox[49] = [0, -1, 0, -1]
        return bbox, 100, 130, 8, 32, 256, 32, False
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "tile-over-cap",
                                  "face-over-expand-cap", "empty-box"])
def test_bin_faces_csr_matches_jax(kind):
    bbox, height, width, tile_h, tile_w, cap, expand, overflows = _boxes(kind)
    want = jbin.bin_faces_csr(jnp.asarray(bbox), height, width, tile_h,
                              tile_w, cap, expand)
    got = tbin.bin_faces_csr(_t(bbox), height, width, tile_h, tile_w, cap,
                             expand)
    assert got.entry_face.dtype == got.start_block.dtype == torch.int32
    assert got.counts.dtype == torch.int32 and got.overflow.ndim == 0
    for field in ("entry_face", "start_block", "counts", "overflow"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), field)
    assert bool(got.overflow) is overflows
    nf = bbox.shape[0]
    assert got.entry_face.shape == (tbin.csr_pad_bound(
        nf, expand, got.counts.shape[0]),)
    # Every run is ascending and is followed by sentinels up to its chunk.
    ef, sb, cc = (f.numpy() for f in got[:3])
    for t in range(len(cc)):
        run = ef[sb[t] * 128: sb[t] * 128 + cc[t]]
        assert (np.diff(run) > 0).all() and (run < nf).all()
        end = sb[t] * 128 + -(-cc[t] // 128) * 128
        assert (ef[sb[t] * 128 + cc[t]: end] == nf).all()
    # The column form of the boxes bins the same.
    cols = tuple(_t(bbox[:, k]) for k in range(4))
    again = tbin.bin_faces_csr(cols, height, width, tile_h, tile_w, cap,
                               expand)
    assert torch.equal(again.entry_face, got.entry_face)


def test_bin_faces_csr_runs_match_the_dense_bins():
    """Each tile's run is the dense engine's list of that tile
    (counterpart of tests/test_streaming.py's binning check)."""
    bbox, height, width, tile_h, tile_w, cap, expand, _ = _boxes("random")
    dense = tbin.bin_faces(_t(bbox), height, width, tile_h, tile_w, cap)
    csr = tbin.bin_faces_csr(_t(bbox), height, width, tile_h, tile_w, cap,
                             expand)
    for t in range(dense.bins.shape[0]):
        start = int(csr.start_block[t]) * tbin.CHUNK
        n = int(csr.counts[t])
        assert n == int(dense.counts[t])
        assert torch.equal(csr.entry_face[start:start + n], dense.bins[t, :n])


_SIZES = [(0, 1), (3, 1), (12, 2), (40, 6), (500, 4), (2208, 16),
          (10224, 128), (16385, 128), (65536, 128), (65537, 128),
          (99904, 128), (1000000, 512)]


@pytest.mark.parametrize("num_faces,num_tiles", _SIZES)
def test_csr_caps_match_jax(num_faces, num_tiles):
    assert tbin.auto_expand_cap(num_faces, num_tiles) == \
        jbin.auto_expand_cap(num_faces, num_tiles)
    for expand in (1, 5, 16):
        assert tbin.csr_pad_bound(num_faces, expand, num_tiles) == \
            jbin.csr_pad_bound(num_faces, expand, num_tiles)
    for bin_cap in (None, 64, 7424):
        for streaming in (True, False):
            assert tr.resolve_bin_cap(
                tr.RasterConfig(bin_cap=bin_cap), num_faces, num_tiles,
                streaming,
            ) == jr.resolve_bin_cap(
                jr.RasterConfig(bin_cap=bin_cap), num_faces, num_tiles,
                streaming)


# --- the kernels' plain versions ----------------------------------------------


@functools.lru_cache(maxsize=None)
def _kernel_case(channels):
    """One streaming forward of dirt_tpu on a crowded soup: 300 faces on a
    64 x 256 image in 32 x 128 tiles, so a tile's run spans several
    128-row chunks. Returns the numpy pieces both packages' kernels take."""
    height, width, tile_h, tile_w = 64, 256, 32, 128
    fv, fa = screen_soup(300, height, width, seed=11, channels=channels,
                         spread=30.0)
    cfg = jr.RasterConfig(tile_h=tile_h, tile_w=tile_w, streaming=True,
                          expand_cap=4)
    bg = np.random.RandomState(1).rand(height, width, channels)
    bg = bg.astype(np.float32)
    pixels, fid, zbuf, bins = jr._forward_impl(
        jnp.asarray(fv), jnp.asarray(fa), jnp.asarray(bg), cfg)
    geo, att, _ = jt.setup_planes(jnp.asarray(fv), jnp.asarray(fa))
    table = jf.pack_face_table(geo, att)
    grad = np.random.RandomState(2).randn(height, width, channels)
    arrays = dict(
        fv=fv, fa=fa, bg=bg, geo=geo, att=att, table=table, pixels=pixels,
        fid=fid, zbuf=zbuf, grad=grad.astype(np.float32),
        entry_face=bins.entry_face, start_block=bins.start_block,
        counts=bins.counts)
    assert not bool(bins.overflow)
    return {k: np.asarray(v) for k, v in arrays.items()}, (tile_h, tile_w)


@pytest.mark.parametrize("channels", [3, 9])
def test_raster_forward_csr_plain_matches_jax(channels):
    a, (tile_h, tile_w) = _kernel_case(channels)
    assert a["counts"].max() > 128             # more than one chunk per tile
    bg_chw = a["bg"].transpose(2, 0, 1).copy()
    cap = -(-int(a["counts"].max()) // 128) * 128
    want = jf.raster_forward_csr(
        jnp.asarray(a["table"])[jnp.asarray(a["entry_face"])],
        jnp.asarray(a["entry_face"]), jnp.asarray(a["start_block"]),
        jnp.asarray(a["counts"]), jnp.asarray(bg_chw), tile_h=tile_h,
        tile_w=tile_w, max_chunks=cap // 128)
    got = tf.raster_forward_csr(
        _t(a["table"]), _t(a["entry_face"]), _t(a["start_block"]),
        _t(a["counts"]), _t(bg_chw), tile_h=tile_h, tile_w=tile_w)
    pix_j, fid_j, z_j = (np.asarray(o) for o in want)
    pix_t, fid_t, z_t, _ = (o.numpy() for o in got)
    assert fid_t.dtype == np.int32
    np.testing.assert_array_equal(fid_t, fid_j)
    np.testing.assert_allclose(z_t, z_j, rtol=0, atol=ATOL_FWD)
    np.testing.assert_allclose(pix_t, pix_j, rtol=0, atol=ATOL_FWD)
    assert (fid_t >= 0).any() and (fid_t < 0).any()
    # The forward the case was made with is this one.
    np.testing.assert_array_equal(fid_t, a["fid"])


def test_forward_csr_ignores_padding_slots():
    """Slots past a run's count are never read: garbage there changes
    nothing."""
    a, (tile_h, tile_w) = _kernel_case(3)
    bg_chw = _t(a["bg"].transpose(2, 0, 1).copy())
    args = (_t(a["start_block"]), _t(a["counts"]), bg_chw)
    want = tf.raster_forward_csr(_t(a["table"]), _t(a["entry_face"]), *args,
                                 tile_h=tile_h, tile_w=tile_w)
    dirty = a["entry_face"].copy()
    dirty[dirty == a["fv"].shape[0]] = 0
    got = tf.raster_forward_csr(_t(a["table"]), _t(dirty), *args,
                                tile_h=tile_h, tile_w=tile_w)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _scaled_close(got, want, rel):
    """Every column within ``rel`` of its largest magnitude (+ 1e-6)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max(axis=0, keepdims=True)
    assert (np.abs(got - want) <= rel * scale + 1e-6).all(), \
        np.abs(got - want).max()


@pytest.mark.parametrize("channels", [3, 9])
def test_fused_backward_rows_csr_plain_matches_jax(channels):
    """The rows themselves: JAX's kernel and segment_sum on its neighbor
    maps and pre-gathered table, the plain version on the prologue's
    bits."""
    a, (tile_h, tile_w) = _kernel_case(channels)
    num_faces = a["geo"].shape[0]
    fid_p, zbuf_p = a["fid"], a["zbuf"]        # 64 x 256: nothing to pad
    pix_cf = a["pixels"].transpose(2, 0, 1).copy()
    grad_cf = a["grad"].transpose(2, 0, 1).copy()
    nbrs = jb.neighbor_maps(*(jnp.asarray(x) for x in (fid_p, zbuf_p, pix_cf,
                                                      grad_cf)))
    geo17 = jnp.concatenate([jnp.asarray(a["geo"])[:, :17],
                             jnp.zeros((1, 17), jnp.float32)])
    cap = -(-int(a["counts"].max()) // 128) * 128
    want = jfb.fused_backward_rows_csr(
        geo17[jnp.asarray(a["entry_face"])], jnp.asarray(a["entry_face"]),
        jnp.asarray(a["start_block"]), jnp.asarray(a["counts"]),
        jnp.asarray(fid_p), jnp.asarray(zbuf_p), jnp.asarray(pix_cf),
        jnp.asarray(grad_cf),
        *(jnp.stack([n[k] for n in nbrs]) for k in range(3)),
        num_faces, tile_h=tile_h, tile_w=tile_w, max_chunks=cap // 128)

    _, bits, sval, _, _ = tpb.padded_prologue(
        _t(fid_p), _t(zbuf_p), _t(pix_cf).permute(1, 2, 0),
        _t(grad_cf).permute(1, 2, 0), tile_h, tile_w)
    got = tfb.fused_backward_rows_csr(
        _t(a["geo"]), _t(a["entry_face"]), _t(a["start_block"]),
        _t(a["counts"]), _t(fid_p), bits, sval, _t(pix_cf), _t(grad_cf),
        num_faces, tile_h=tile_h, tile_w=tile_w)
    assert got.shape == want.shape == (num_faces, 12 + 3 * channels)
    _scaled_close(got.numpy(), want, rel=1e-5)
    assert np.abs(np.asarray(want)).max() > 0


def test_backward_fused_csr_matches_backward_torch():
    """The streaming backward against the port's pure engine (no bins, no
    tiles) on an image that needs padding: the same cotangent core, two
    independent reductions. Within 1e-5 of the column's scale."""
    height, width = 50, 140
    fv, fa = screen_soup(40, height, width, seed=5, channels=2, spread=30.0)
    cfg = tr.RasterConfig(tile_h=32, tile_w=128, streaming=True)
    bg = _t(np.random.RandomState(1).rand(height, width, 2)
            .astype(np.float32))
    pixels, fid, zbuf, bins, cfg = tr._forward_impl(_t(fv), _t(fa), bg, cfg)
    assert isinstance(bins, tr.StreamBins) and not bool(bins.overflow)
    geo, att, _ = tt.setup_planes(_t(fv), _t(fa))
    grad = _t(np.random.RandomState(2).randn(height, width, 2)
              .astype(np.float32))
    want = tb.backward_torch(geo, att, fid, zbuf, pixels, grad)
    got = tb.backward_fused_csr(geo, att, fid, zbuf, pixels, grad,
                                bins.entry_face, bins.start_block,
                                bins.counts, cfg.tile_h, cfg.tile_w)
    for g, w in zip(got, want):
        _scaled_close(g.numpy(), w.numpy(), rel=1e-5)
    assert want[0].abs().max() > 0


# --- the op end to end ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _scene(kind):
    """(background, vertices, colors, faces, upstream gradient, size)."""
    if kind == "soup":
        verts, colors, faces, bg = clip_soup(40, SOUP, seed=0)
        size = SOUP
    else:
        # The sphere so close that faces cross the near plane.
        verts, colors, faces = sphere_scene(distance=0.9)
        bg = np.random.RandomState(4).rand(SIZE, SIZE, 3).astype(np.float32)
        size = SIZE
    w = np.random.RandomState(9).rand(size, size, 3).astype(np.float32)
    return bg, verts, colors, faces, w, size


@functools.lru_cache(maxsize=None)
def _jax_run(kind, clip, config):
    bg, verts, colors, faces, w, _ = _scene(kind)
    aux = dirt_tpu.rasterise_with_aux(bg, verts, colors, faces, config=config,
                                      clip=clip)
    _, vjp_fn = jax.vjp(
        lambda b, v, c: dirt_tpu.rasterise(b, v, c, faces, config=config,
                                           clip=clip),
        jnp.asarray(bg), jnp.asarray(verts), jnp.asarray(colors))
    return [np.asarray(o) for o in aux], \
        [np.asarray(g) for g in vjp_fn(jnp.asarray(w))]


@functools.lru_cache(maxsize=None)
def _torch_run(kind, clip, config):
    bg, verts, colors, faces, w, _ = _scene(kind)
    bg_t, v_t, c_t, f_t = convert.scene_from_numpy(bg, verts, colors, faces,
                                                   "cpu")
    leaves = [t.clone().requires_grad_() for t in (bg_t, v_t, c_t)]
    out = dirt_tpu_torch.rasterise_with_aux(*leaves, f_t, config=config,
                                            clip=clip)
    (out[0] * torch.tensor(w)).sum().backward()
    return [o.detach().numpy() for o in out], [t.grad.numpy() for t in leaves]


def _grad_close(got, want, rel=1e-4):
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), \
        (np.abs(got - want).max(), np.abs(want).max())


_OP_CASES = {
    "streaming": ("soup", False, dict(streaming=True, **CAPS)),
    "streaming-clip": ("soup", True, dict(streaming=True, **CAPS)),
    "dense-streaming": ("soup", False, dict(engine="dense", streaming=True,
                                            **CAPS)),
    "crossing-clip": ("crossing", True, dict(streaming=True)),
}


@pytest.mark.parametrize("case", list(_OP_CASES))
def test_rasterise_streaming_matches_jax_vjp(case):
    kind, clip, fields = _OP_CASES[case]
    (pix_j, fid_j, z_j, ovf_j), (dbg_j, dv_j, dc_j) = _jax_run(
        kind, clip, jr.RasterConfig(**fields))
    (pix_t, fid_t, z_t, ovf_t), (dbg_t, dv_t, dc_t) = _torch_run(
        kind, clip, tr.RasterConfig(**fields))
    assert bool(ovf_t) is bool(ovf_j) is False
    differ = fid_t != fid_j
    if kind == "soup":
        assert not differ.any(), f"{differ.sum()} fids differ"
    else:
        assert differ.mean() <= RAZOR, f"{differ.mean():.4%} fids differ"
        # Remapped ids name original faces.
        assert fid_t.max() < _scene(kind)[3].shape[0]
    agree = ~differ
    np.testing.assert_allclose(pix_t[agree], pix_j[agree], rtol=0,
                               atol=ATOL_FWD)
    np.testing.assert_allclose(z_t[agree], z_j[agree], rtol=0, atol=ATOL_FWD)
    assert (fid_t >= 0).mean() > 0.1
    np.testing.assert_allclose(dbg_t[agree], dbg_j[agree], rtol=0, atol=1e-6)
    _grad_close(dc_t, dc_j)
    # Vertices of faces on razor pixels see another owner, and those of
    # faces whose boundary decision flips between the packages see
    # another pair term: hold the port to the oracle there instead.
    bg, verts, colors, faces, w, _ = _scene(kind)
    config = tr.RasterConfig(**fields)
    slots = port_slots(bg, verts, colors, faces, config, clip)
    geo_j = jax_planes(bg, verts, colors, faces, config, clip)
    keep = vertex_keep(faces, len(dv_t), fid_t, fid_j, slots, z_j,
                       geo_j)
    assert keep.mean() > 0.9
    _grad_close(dv_t[keep], dv_j[keep])
    if not keep.all():
        dv_o, _ = oracle_vertex_grads(bg, verts, colors, faces, w, slots,
                                      config, clip)
        _grad_close(dv_t[~keep], dv_o[~keep])
    assert np.abs(dv_t).max() > 0.1


@pytest.mark.parametrize("clip", [False, True])
def test_streaming_matches_dense_engine(clip):
    """One scene through the port's streaming and dense engines: the same
    image, the same gradients (counterpart of tests/test_streaming.py)."""
    out_d, grads_d = _torch_run("soup", clip, tr.RasterConfig(
        streaming=False, **CAPS))
    out_s, grads_s = _torch_run("soup", clip, tr.RasterConfig(
        streaming=True, **CAPS))
    assert not out_d[3] and not out_s[3]
    np.testing.assert_array_equal(out_d[1], out_s[1])
    np.testing.assert_array_equal(out_d[2], out_s[2])
    np.testing.assert_allclose(out_d[0], out_s[0], rtol=0, atol=1e-6)
    for g_d, g_s in zip(grads_d, grads_s):
        _grad_close(g_s, g_d)


def test_streaming_quad_spanning_all_tiles():
    """A two-triangle quad covering the whole image: each face overlaps
    every tile, which the auto expand cap must allow (tests/test_streaming.py's
    case)."""
    verts3, faces = mesh.unit_quad()
    verts = np.concatenate([np.asarray(verts3) * 2.0,
                            np.ones((4, 1), np.float32)], axis=-1)
    colors = np.ones((4, 1), np.float32)
    config = dict(streaming=True)
    want = dirt_tpu.rasterise_with_aux(
        np.zeros((64, 256, 1), np.float32), verts, colors, faces,
        config=jr.RasterConfig(**config))
    got = dirt_tpu_torch.rasterise_with_aux(
        torch.zeros(64, 256, 1), _t(verts), _t(colors), _t(faces),
        config=tr.RasterConfig(**config))
    assert float(got[0].min()) > 0.99 and not bool(got[3])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=ATOL_FWD)


def test_undersized_streaming_caps_raise_the_flag_in_both():
    bg, verts, colors, faces, _, _ = _scene("soup")
    small = dict(streaming=True, tile_h=16, tile_w=128, expand_cap=1)
    ovf_j = dirt_tpu.rasterise_with_aux(
        bg, verts, colors, faces, config=jr.RasterConfig(**small))[3]
    scene = convert.scene_from_numpy(bg, verts, colors, faces, "cpu")
    ovf_t = dirt_tpu_torch.rasterise_with_aux(
        *scene, config=tr.RasterConfig(**small))[3]
    assert bool(ovf_j) and bool(ovf_t)
    fv = tt.screen_from_clip(scene[1], SOUP, SOUP)[scene[3]]
    flag = tr.check_bin_overflow(fv, scene[2][scene[3]], scene[0],
                                 tr.RasterConfig(**small))
    assert flag.ndim == 0 and bool(flag)


def test_default_api_routes_to_csr_above_the_threshold(monkeypatch):
    """``rasterise_with_aux`` with no config on a mesh above
    STREAMING_FACES faces runs the csr engine in both packages (the
    threshold is lowered in both rather than rendering 16k faces)."""
    bg, verts, colors, faces, _, _ = _scene("soup")
    assert jr.STREAMING_FACES == tr.STREAMING_FACES == 16384
    for module in (jro, jr, tro, tr):
        monkeypatch.setattr(module, "STREAMING_FACES", faces.shape[0] - 1)
    engines = []
    for package, raster, ops in ((dirt_tpu, jr, jro),
                                 (dirt_tpu_torch, tr, tro)):
        inner = raster._forward_impl

        def spy(fv, fa, background, config, raster=raster, inner=inner):
            engines.append((config.streaming,
                            raster.resolve_engine(config, fv.shape[0])))
            return inner(fv, fa, background, config)

        monkeypatch.setattr(raster, "_forward_impl", spy)
        out = package.rasterise_with_aux(
            *(np.asarray(a) if package is dirt_tpu else _t(a)
              for a in (bg, verts, colors, faces)))
        assert not bool(out[3])
    assert engines == [(True, "csr"), (True, "csr")]
    # And the port's default render is its streaming render.
    want = _torch_run("soup", True, tr.RasterConfig(streaming=True))[0]
    np.testing.assert_array_equal(out[1].numpy(), want[1])


def test_engine_csr_without_streaming_differentiates():
    """``RasterConfig(engine="csr")`` on a small mesh, ``streaming`` unset:
    the port's forward and backward agree on the streaming engine, so the
    gradients are those of ``streaming=True``. ``dirt_tpu`` decides the
    backward by ``use_streaming`` alone and fails there (ROADMAP Queue 3)."""
    out_s, grads_s = _torch_run("soup", False, tr.RasterConfig(
        streaming=True, **CAPS))
    out_c, grads_c = _torch_run("soup", False, tr.RasterConfig(
        engine="csr", **CAPS))
    for o_c, o_s in zip(out_c, out_s):
        np.testing.assert_array_equal(o_c, o_s)
    for g_c, g_s in zip(grads_c, grads_s):
        np.testing.assert_array_equal(g_c, g_s)
    assert np.abs(grads_c[1]).max() > 0.1

    bg, verts, colors, faces, w, _ = _scene("soup")
    cfg = jr.RasterConfig(engine="csr", **CAPS)
    fid_j = dirt_tpu.rasterise_with_aux(bg, verts, colors, faces, config=cfg,
                                        clip=False)[1]
    np.testing.assert_array_equal(np.asarray(fid_j), out_c[1])
    with pytest.raises(AttributeError, match="bins"):
        jax.grad(lambda v: jnp.sum(dirt_tpu.rasterise(
            bg, v, colors, faces, config=cfg, clip=False) * w))(
                jnp.asarray(verts))


@pytest.mark.parametrize("clip", [False, True])
def test_suggest_raster_config_streaming_matches_jax(clip):
    _, verts, _, faces, _, size = _scene("soup")
    base = dict(streaming=True, tile_h=16)
    want = dirt_tpu.suggest_raster_config(
        verts, faces, size, size, config=jr.RasterConfig(**base), clip=clip)
    got = dirt_tpu_torch.suggest_raster_config(
        _t(verts), _t(faces), size, size, config=tr.RasterConfig(**base),
        clip=clip)
    assert got == convert.config_from_jax(want)
    assert got.streaming is True and got.expand_cap >= 6
    assert got.bin_cap % tbin.CHUNK == 0
    assert tr.resolve_engine(got, faces.shape[0]) == "csr"
    # The suggested caps render untruncated.
    out = _torch_run("soup", clip, got)[0]
    assert not out[3]


def test_config_from_jax_carries_the_streaming_fields():
    cfg = jr.RasterConfig(tile_h=64, bin_cap=7424, streaming=True,
                          expand_cap=5, engine="csr", clip_cap=8)
    got = convert.config_from_jax(cfg)
    assert got == tr.RasterConfig(**cfg._asdict())
    assert (got.streaming, got.expand_cap, got.engine) == (True, 5, "csr")


def test_rasterise_batch_streams():
    """``rasterise_batch`` under a streaming config: every view equals its
    single render."""
    bg, verts, colors, faces, _, _ = _scene("soup")
    cfg = tr.RasterConfig(streaming=True, **CAPS)
    views = np.stack([verts, verts * np.float32([0.8, 0.9, 1.0, 1.0])])
    batch = dirt_tpu_torch.rasterise_batch(
        _t(np.stack([bg, bg])), _t(views), _t(np.stack([colors, colors])),
        _t(faces), config=cfg)
    assert batch.shape == (2, SOUP, SOUP, 3)
    for k in range(2):
        single = dirt_tpu_torch.rasterise(_t(bg), _t(views[k]), _t(colors),
                                          _t(faces), config=cfg)
        assert torch.equal(batch[k], single)
    assert not torch.equal(batch[0], batch[1])


def test_other_devices_raise():
    """No fallback: only CPU tensors take the plain versions."""
    table = torch.zeros(8, 20, device="meta")
    ids = torch.zeros(128, dtype=torch.int32, device="meta")
    one = torch.zeros(1, dtype=torch.int32, device="meta")
    bg = torch.zeros(1, 8, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tf.raster_forward_csr(table, ids, one, one, bg, tile_h=8, tile_w=32)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfb.fused_backward_rows_csr(table, ids, one, one, one, one, bg, bg,
                                    bg, 2, tile_h=8, tile_w=32)
