"""The scatter engine of dirt_tpu_torch vs dirt_tpu's, on the CPU.

The same numpy inputs go through the JAX functions (the Pallas scatter
kernels in interpret mode, as the root conftest arranges) and the port's
(CPU tensors, so each kernel wrapper takes its plain PyTorch version), on
the bins dirt_tpu's own forward made: the scene of
``tests/test_raster_grad.py::test_scatter_engine_matches_jax_engine`` (60
faces at 96 x 96 in 16 x 128 tiles, cap 128) and a crowded soup at 96 x 160
whose caps cut the lists (bin_cap 16 the dense tiles', expand_cap 2 the
streaming faces'; a cut face owns no pixel where it was cut). Tolerances:

* ``scatter_to_faces_plain`` / ``scatter_to_faces_csr_plain`` against
  ``scatter_to_faces`` / ``scatter_to_faces_csr``: rtol = atol = 1e-5 (JAX
  sums a face's pixels through f32 matrix products, the plain version
  through one float64 ``index_add_``);
* ``pack_cotangent_tiles``: equal;
* ``backward_scatter`` and ``backward_scatter_halo`` against JAX's and
  against the port's ``backward_torch(own_mask=...)``: plane gradients
  within 1e-5 of the column's largest magnitude plus 1e-6, d_background
  equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_scene import screen_soup
from dirt_tpu.ops import raster as jr
from dirt_tpu.ops import raster_bwd as jb
from dirt_tpu.ops import triangle_setup as jt
from dirt_tpu_torch.ops import raster as tr
from dirt_tpu_torch.ops import raster_bwd as tb
from dirt_tpu_torch.ops import scatter as ts

TILE = dict(tile_h=16, tile_w=128)
CASES = ["grad-scene", "soup-over-cap"]
ENGINES = ["dense", "csr"]


def _t(a):
    return torch.tensor(np.asarray(a))


def _scene(case):
    """(face_verts [F, 3, 4], face_attrs [F, 3, 3], height, width, caps,
    overflows). The streaming engine rounds its tile cap up to 128, so
    there a small ``expand_cap`` does the cutting."""
    if case == "grad-scene":
        rng = np.random.RandomState(7)
        nf, size = 60, 96
        verts = rng.uniform(-1.1, 1.1, (3 * nf, 4)).astype(np.float32)
        verts[:, 2] = rng.uniform(-0.8, 0.8, 3 * nf)
        verts[:, 3] = 1.0
        colors = rng.rand(3 * nf, 3).astype(np.float32)
        fv = np.asarray(jt.screen_from_clip(jnp.asarray(verts), size, size))
        return (fv.reshape(nf, 3, 4), colors.reshape(nf, 3, 3), size, size,
                dict(bin_cap=128), False)
    fv, fa = screen_soup(150, 96, 160, seed=9, spread=30.0)
    return fv, fa, 96, 160, dict(bin_cap=16, expand_cap=2), True


def _jax_scatter_fn(config, bins, num_faces, height, width, streaming):
    bin_res = ((bins.entry_face, bins.start_block, bins.counts) if streaming
               else (bins.bins, bins.counts))
    return jr.make_scatter_fn(config, bin_res, num_faces, height, width)


def _port_bins(bins, streaming):
    """The JAX forward's bins as the port's record (the plain versions read
    no boxes)."""
    if streaming:
        return tr.StreamBins(_t(bins.entry_face), _t(bins.start_block),
                             _t(bins.counts), _t(bins.overflow), None, None)
    return tr.DenseBins(_t(bins.bins), _t(bins.counts), _t(bins.overflow),
                        None, None)


@functools.lru_cache(maxsize=None)
def _case(case, engine):
    """One forward of dirt_tpu and everything both packages' scatter
    engines take and give, as numpy."""
    fv, fa, height, width, caps, overflows = _scene(case)
    streaming = engine == "csr"
    config = jr.RasterConfig(streaming=streaming, **caps, **TILE)
    rng = np.random.RandomState(1)
    bg = rng.rand(height, width, 3).astype(np.float32)
    grad = rng.randn(height, width, 3).astype(np.float32)
    pixels, fid, zbuf, bins = jr._forward_impl(
        jnp.asarray(fv), jnp.asarray(fa), jnp.asarray(bg), config)
    assert bool(jnp.any(bins.overflow)) is overflows
    geo, att, _ = jt.setup_planes(jnp.asarray(fv), jnp.asarray(fa))
    covered = fid >= 0
    g16 = jnp.transpose(geo[jnp.where(covered, fid, 0)], (2, 0, 1))
    d_geo_cols, d_att_cols = jb.pixel_cotangents(
        g16, covered, fid, zbuf, jnp.transpose(pixels, (2, 0, 1)),
        jnp.transpose(jnp.asarray(grad), (2, 0, 1)))
    cot, fid_p = jb.pack_cotangent_tiles(d_geo_cols, d_att_cols, covered,
                                         fid, TILE["tile_h"], TILE["tile_w"])
    scatter_fn = _jax_scatter_fn(config, bins, fv.shape[0], height, width,
                                 streaming)
    own = rng.rand(height, 1) < 0.7
    own = np.broadcast_to(own, (height, width))
    arrays = dict(
        fv=fv, fa=fa, geo=geo, att=att, pixels=pixels, fid=fid, zbuf=zbuf,
        grad=grad, cot=cot, fid_p=fid_p, rows=scatter_fn(cot, fid_p),
        own=own,
        bwd=jb.backward_scatter(geo, att, fid, zbuf, pixels,
                                jnp.asarray(grad), scatter_fn, **TILE),
        bwd_own=jb.backward_scatter(geo, att, fid, zbuf, pixels,
                                    jnp.asarray(grad), scatter_fn,
                                    own_mask=jnp.asarray(own), **TILE),
    )
    out = {k: ([np.asarray(x) for x in v] if isinstance(v, tuple)
               else np.asarray(v)) for k, v in arrays.items()}
    return out, _port_bins(bins, streaming), config


def _close_by_column(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max(axis=0, keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * scale + 1e-6).all(), what


def _port_scatter_fn(config, bins, num_faces):
    return tr.make_scatter_fn(tr.RasterConfig(**config._asdict()), bins,
                              num_faces)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", CASES)
def test_scatter_plain_matches_jax(case, engine):
    a, bins, _ = _case(case, engine)
    nf = a["fv"].shape[0]
    cot, fid_p = _t(a["cot"]), _t(a["fid_p"])
    if engine == "csr":
        got = ts.scatter_to_faces_csr(
            cot, fid_p, bins.entry_face, bins.start_block, bins.counts, nf,
            **TILE)
        assert got.shape == (nf, 21)
    else:
        got = ts.scatter_to_faces(cot, fid_p, bins.bins, bins.counts, nf + 1,
                                  **TILE)
        assert got.shape == (-(-(nf + 1) // 8) * 8, 21)
        assert not got[nf:].any()               # sentinel and padding rows
        got = got[:nf]
    np.testing.assert_allclose(got.numpy(), a["rows"], rtol=1e-5, atol=1e-5)
    assert np.abs(a["rows"]).max() > 1.0


@pytest.mark.parametrize("case", CASES)
def test_pack_cotangent_tiles_matches_jax(case):
    a, _, _ = _case(case, "dense")
    fid, covered = _t(a["fid"]), _t(a["fid"]) >= 0
    geo = _t(a["geo"])
    d_geo_cols, d_att_cols = tb.pixel_cotangents(
        geo[torch.where(covered, fid, 0).long()].permute(2, 0, 1), covered,
        fid, _t(a["zbuf"]), _t(a["pixels"]).permute(2, 0, 1),
        _t(a["grad"]).permute(2, 0, 1))
    cot, fid_p = tb.pack_cotangent_tiles(d_geo_cols, d_att_cols, covered,
                                         fid, **TILE)
    assert cot.is_contiguous() and fid_p.is_contiguous()
    assert fid_p.dtype == torch.int32
    np.testing.assert_array_equal(fid_p.numpy(), a["fid_p"])
    assert cot.shape == a["cot"].shape
    np.testing.assert_allclose(cot.numpy(), a["cot"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", CASES)
def test_backward_scatter_matches_jax_and_backward_torch(case, engine,
                                                         masked):
    a, bins, config = _case(case, engine)
    own = _t(a["own"]) if masked else None
    args = [_t(a[k]) for k in ("geo", "att", "fid", "zbuf", "pixels",
                               "grad")]
    got = tb.backward_scatter(
        *args, _port_scatter_fn(config, bins, a["fv"].shape[0]),
        own_mask=own, **TILE)
    want_jax = a["bwd_own" if masked else "bwd"]
    want_torch = tb.backward_torch(*args, own_mask=own)
    for g, w_j, w_t, name in zip(got, want_jax, want_torch,
                                 ("d_geo", "d_att")):
        _close_by_column(g, w_j, f"{name} vs jax")
        _close_by_column(g, w_t, f"{name} vs backward_torch")
        assert np.abs(w_j).max() > 0
    np.testing.assert_array_equal(got[2].numpy(), want_jax[2])
    assert torch.equal(got[2], want_torch[2])


@functools.lru_cache(maxsize=None)
def _halo_case(engine):
    """The middle one of three 32-row slabs of the grad scene, as the
    row-sharded renderer sees it: each slab rendered by dirt_tpu on
    geometry shifted into its rows, the middle slab's arrays extended by
    its neighbours' rows, the planes set up one row further down."""
    fv, fa, height, width, caps, _ = _scene("grad-scene")
    streaming = engine == "csr"
    config = jr.RasterConfig(streaming=streaming, **caps, **TILE)
    rng = np.random.RandomState(2)
    bg = rng.rand(height, width, 3).astype(np.float32)
    grad = rng.randn(height, width, 3).astype(np.float32)
    slab_h = 32
    outs = []
    for s in range(3):
        local = jnp.asarray(fv) - jnp.array([0.0, s * slab_h, 0.0, 0.0])
        outs.append(jr._forward_impl(
            local, jnp.asarray(fa),
            jnp.asarray(bg[s * slab_h:(s + 1) * slab_h]), config))
    pixels, fid, zbuf = (jnp.concatenate([o[k] for o in outs])
                         for k in range(3))
    rows = slice(slab_h - 1, 2 * slab_h + 1)
    fid_e, zbuf_e, pixels_e = fid[rows], zbuf[rows], pixels[rows]
    grad_e = jnp.asarray(grad[rows])
    own = np.zeros((slab_h + 2, width), bool)
    own[1:-1] = True
    shifted = jnp.asarray(fv) - jnp.array([0.0, slab_h - 1.0, 0.0, 0.0])
    geo, att, _ = jt.setup_planes(shifted, jnp.asarray(fa))
    bins = outs[1][3]
    want = jb.backward_scatter_halo(
        geo, att, fid_e, zbuf_e, pixels_e, grad_e, jnp.asarray(own),
        _jax_scatter_fn(config, bins, fv.shape[0], slab_h, width, streaming),
        **TILE)
    arrays = dict(geo=geo, att=att, fid_e=fid_e, zbuf_e=zbuf_e,
                  pixels_e=pixels_e, grad_e=grad_e, own=own)
    return ({k: np.asarray(v) for k, v in arrays.items()},
            [np.asarray(w) for w in want], _port_bins(bins, streaming),
            config, fv.shape[0])


@pytest.mark.parametrize("engine", ENGINES)
def test_backward_scatter_halo_matches_jax_and_backward_torch(engine):
    a, want_jax, bins, config, nf = _halo_case(engine)
    args = [_t(a[k]) for k in ("geo", "att", "fid_e", "zbuf_e", "pixels_e",
                               "grad_e")]
    own = _t(a["own"])
    got = tb.backward_scatter_halo(
        *args, own, _port_scatter_fn(config, bins, nf), **TILE)
    want_torch = tb.backward_torch(*args, own_mask=own)
    for g, w_j, w_t, name in zip(got, want_jax, want_torch,
                                 ("d_geo", "d_att")):
        _close_by_column(g, w_j, f"{name} vs jax")
        _close_by_column(g, w_t, f"{name} vs backward_torch")
        assert np.abs(w_j).max() > 0
    assert got[2].shape == (34, 96, 3)
    np.testing.assert_array_equal(got[2].numpy(), want_jax[2])
    # A pair that crosses the slab's edge counts: without the halo rows the
    # gradients differ.
    blind = [t.clone() for t in args]
    blind[2][0] = blind[2][-1] = -2
    cut = tb.backward_scatter_halo(
        *blind, own, _port_scatter_fn(config, bins, nf), **TILE)
    assert not torch.allclose(cut[0], got[0], rtol=1e-3, atol=1e-3)


def test_make_scatter_fn_picks_the_kernel_by_the_kind_of_bins():
    fv, fa = (_t(x) for x in screen_soup(40, 64, 128, seed=3))
    bg = torch.zeros((64, 128, 3))
    noise = torch.randn(21, 64, 128,
                        generator=torch.Generator().manual_seed(0))
    rows = {}
    for engine, streaming in (("dense", False), ("csr", True)):
        config = tr.RasterConfig(bin_cap=128, streaming=streaming, **TILE)
        pixels, fid, zbuf, bins, config = tr._forward_impl(fv, fa, bg,
                                                           config)
        assert isinstance(bins, tr.StreamBins if streaming else tr.DenseBins)
        cot = noise * (fid >= 0)
        fn = tr.make_scatter_fn(config, bins, fv.shape[0])
        rows[engine] = fn(cot, torch.where(fid >= 0, fid, -1))
        assert rows[engine].shape == (40, 21)
    assert torch.equal(rows["dense"], rows["csr"])
    packed = tr.RasterConfig(engine="packed", expand_cap=64, budget=1024,
                             **TILE)
    bins = tr._forward_impl(fv, fa, bg, packed)[3]
    with pytest.raises(TypeError, match="DenseBins or StreamBins"):
        tr.make_scatter_fn(packed, bins, fv.shape[0])


def test_scatter_plain_drops_unowned_pixels_and_rounds_once():
    cot = torch.full((12, 16, 128), 0.1)
    fid = torch.full((16, 128), -1, dtype=torch.int32)
    fid[:, :64] = 2
    fid[0, 0] = -2
    rows = ts.scatter_to_faces_plain(cot, fid, 5)
    assert rows.shape == (8, 12) and rows.dtype == torch.float32
    assert not rows[[0, 1, 3, 4, 5, 6, 7]].any()
    want = np.float32(np.float64(np.float32(0.1)) * (16 * 64 - 1))
    assert (rows[2] == float(want)).all()
    assert torch.equal(ts.scatter_to_faces_csr_plain(cot, fid, 4), rows[:4])
    for fn, args in ((ts.scatter_to_faces, (None, None, 5)),
                     (ts.scatter_to_faces_csr, (None, None, None, 4))):
        with pytest.raises(ValueError, match="no kernel for device"):
            fn(cot.to("meta"), fid.to("meta"), *args, **TILE)
