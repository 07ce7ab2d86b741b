"""dirt_tpu_torch.ops.packed_bwd (plain versions of K3 and K2) vs dirt_tpu.

The JAX side runs its packed backward as its own tests run it on the CPU
(Pallas in interpret mode); the port's side gets the same forward outputs,
bins and face rows as CPU tensors, so its wrappers take the plain
versions. Tolerances, each with its reason:

* the prologue: bits equal (integer tests), sval allclose(rtol=1e-6,
  atol=1e-6) (same expressions; the JAX kernel's outputs are in the
  flat-subtile layout and are swapped back with ``flat_subtile_swap``);
* entry rows: allclose(rtol=1e-4, atol=1e-5 * max |row|): JAX gathers and
  scatters through f32-faithful 3-pass bf16 one-hot matmuls, whose sums
  over a row's pixels run in another order than the port's ordered sum;
* face gradients (``backward_packed``): allclose(rtol=1e-4, atol=1e-5 *
  max |gradient|), the entry rows' tolerance carried through the reduce;
* the port's ``backward_packed`` against its own ``backward_torch``: the
  same, for the same reason (per-face sums in another order);
* end to end through ``rasterize_screen`` on the soup scene of
  tests/test_raster_grad.py: that file's tolerances (d_background atol
  1e-6, d_attrs rtol 1e-4 atol 1e-5, d_verts rtol 1e-3 atol 1e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_scene import SIZE, sphere_scene
from dirt_tpu.ops import binning as jbin
from dirt_tpu.ops import packed_bwd as jp
from dirt_tpu.ops import raster as jr
from dirt_tpu.ops import raster_bwd as jrb
from dirt_tpu.ops import raster_fwd as jf
from dirt_tpu.ops import triangle_setup as jt
from dirt_tpu_torch import convert
from dirt_tpu_torch.ops import binning as tbin
from dirt_tpu_torch.ops import packed_bwd as tp
from dirt_tpu_torch.ops import raster as tr
from dirt_tpu_torch.ops import raster_bwd as trb
from dirt_tpu_torch.ops import raster_fwd as tf
from dirt_tpu_torch.ops import triangle_setup as tt
from dirt_tpu_torch.ops.raster_fwd import BIG_Z, COL_ID
from dirt_tpu_torch.ops.triangle_setup import GEO_USED

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close_scaled(got, want, rtol=1e-4, scale=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=scale * np.abs(want).max())


# --- K3: the prologue -----------------------------------------------------------


def _prologue_inputs():
    """The inputs of tests/test_raster_grad.py's prologue test."""
    rng = np.random.RandomState(17)
    hp, wp, c = 32, 256, 3
    fid_p = rng.randint(-2, 9, (hp, wp)).astype(np.int32)
    zbuf_p = np.where(rng.rand(hp, wp) < 0.2, BIG_Z,
                      rng.randn(hp, wp)).astype(np.float32)
    pix_cf = rng.rand(c, hp, wp).astype(np.float32)
    grad_cf = rng.randn(c, hp, wp).astype(np.float32)
    return fid_p, zbuf_p, pix_cf, grad_cf


def test_prologue_plain_matches_jax_kernel():
    args = _prologue_inputs()
    _, bits_f, _, _, sval_f = jp.fused_neighbor_prologue(
        *(jnp.asarray(a) for a in args))
    fid_p, zbuf_p, pix_cf, grad_cf = (torch.tensor(a) for a in args)
    _, bits, sval, _, _ = tp.padded_prologue(
        fid_p, zbuf_p, pix_cf.permute(1, 2, 0), grad_cf.permute(1, 2, 0),
        *fid_p.shape)
    assert bits.dtype == torch.int32 and sval.shape == (4, 32, 256)
    # flat_subtile_swap is an involution: it takes the kernel's outputs
    # back to image layout.
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jf.flat_subtile_swap(bits_f)))
    np.testing.assert_allclose(
        sval.numpy(), np.asarray(jf.flat_subtile_swap(sval_f)), **TOL)
    assert (bits.numpy() != 0).mean() > 0.3


def test_prologue_tie_rule_and_image_border():
    """Equal depths: the left / upper pixel of a pair is front (right and
    below are strict, left and above are not); out-of-image neighbors
    never pair."""
    fid = torch.tensor([[0, 1], [2, 2]], dtype=torch.int32)
    zbuf = torch.full((2, 2), 0.25)
    pix = torch.rand(1, 2, 2)
    _, bits, sval, _, _ = tp.padded_prologue(
        fid, zbuf, pix.permute(1, 2, 0), torch.ones(2, 2, 1), 2, 2)
    # Pixel (0, 0) pairs right with face 1 (strict: tie -> not front) and
    # below with face 2 (strict: not front); pixel (0, 1) pairs left with
    # face 0 (non-strict: front) and below; pixel (1, 0) pairs above.
    assert bits.tolist() == [[0, 0b0010], [0b1000, 0b1000]]
    # Neighbors outside the image give sval = 0.5 * g * p.
    torch.testing.assert_close(sval[0, :, 1], 0.5 * pix[0, :, 1])


def test_other_devices_raise():
    """No fallback: only CPU tensors take the plain versions."""
    fid, zbuf, pix, grad = (torch.tensor(a).to("meta")
                            for a in _prologue_inputs())
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tp.padded_prologue(fid, zbuf, pix.permute(1, 2, 0),
                           grad.permute(1, 2, 0), 32, 128)
    ints = fid.new_zeros(512)
    bins = tbin.PackedBins(ints, ints[:1], ints[:1], ints[:1],
                           ints[:1].bool(), ints[:4], ints[:4],
                           table=zbuf.new_zeros(91, 32))
    prep = tp._PackedBwdPrep(fid, fid, zbuf.expand(4, -1, -1), pix, grad,
                             bins, None, None, 3, 21, 32, 128)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tp.packed_entry_rows(prep)


# --- K2 and the whole packed backward on the soup scene -----------------------


def _soup(seed=5, num_faces=90, height=96, width=160, channels=3):
    """The soup scene of tests/test_raster_grad.py (perspective-varying
    invw, overlapping faces)."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform([10, 10], [width - 10, height - 10],
                          (num_faces, 1, 2))
    xy = (centers + rng.uniform(-22, 22, (num_faces, 3, 2))).astype(
        np.float32)
    z = rng.uniform(-0.9, 0.9, (num_faces, 1)).astype(np.float32)
    z = np.broadcast_to(z, (num_faces, 3))
    face_verts = np.concatenate(
        [xy, z[..., None], np.ones((num_faces, 3, 1), np.float32)], axis=-1)
    face_verts[..., 3] = rng.uniform(0.4, 1.6, (num_faces, 3))
    face_attrs = rng.rand(num_faces, 3, channels).astype(np.float32)
    background = rng.rand(height, width, channels).astype(np.float32)
    grad_pixels = rng.randn(height, width, channels).astype(np.float32)
    return face_verts, face_attrs, background, grad_pixels


@functools.lru_cache(maxsize=None)
def _config():
    fv = _soup()[0]
    config = jr.suggest_config(jnp.asarray(fv), 96, 160,
                               jr.RasterConfig(engine="packed"))
    # Wider than suggested: the reference's count undercounts with two
    # tile columns (ROADMAP Queue 3), and this test checks the backward.
    return config._replace(budget=2 * config.budget)


def _bmax(config, num_faces, height, width):
    hp = -(-height // config.tile_h) * config.tile_h
    wp = -(-width // config.tile_w) * config.tile_w
    _, _, strips, groups = jbin.packed_grid(hp, wp, config.tile_h,
                                            config.tile_w)
    nsid = (hp // config.tile_h) * (wp // config.tile_w) * strips * groups
    expand = config.expand_cap or jbin.auto_packed_expand(num_faces, nsid)
    return -(-expand // jbin.POOL_ALIGN)


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_packed(fv, fa, bg, gp, config):
    """JAX's forward, entry rows and backward_packed (plain and with the
    halo path's precomputed neighbor maps)."""
    height, width, _ = bg.shape
    pixels, fid, zbuf, bins = jr._forward_impl(fv, fa, bg, config)
    geo, att, _ = jt.setup_planes(fv, fa)
    config = config.concrete(height)
    tile_h, tile_w = config.tile_h, config.tile_w
    num_faces = fv.shape[0]
    bmax = _bmax(config, num_faces, height, width)
    prep = jp.prepare_backward_packed(geo, att, fid, zbuf, pixels, gp, bins,
                                      tile_h, tile_w)
    rows = jp.packed_entry_rows(prep)
    grads = jp.backward_packed(geo, att, fid, zbuf, pixels, gp, bins,
                               num_faces, tile_h, tile_w, bmax=bmax)
    hp = -(-height // tile_h) * tile_h
    wp = -(-width // tile_w) * tile_w
    pad2 = ((0, hp - height), (0, wp - width))
    nbrs = jrb.neighbor_maps(
        jnp.pad(fid, pad2, constant_values=-2),
        jnp.pad(zbuf, pad2, constant_values=BIG_Z),
        jnp.pad(jnp.transpose(pixels, (2, 0, 1)), ((0, 0),) + pad2),
        jnp.pad(jnp.transpose(gp, (2, 0, 1)), ((0, 0),) + pad2))
    stacks = tuple(jnp.stack([n[k] for n in nbrs]) for k in range(3))
    grads_halo = jp.backward_packed(geo, att, fid, zbuf, pixels, gp, bins,
                                    num_faces, tile_h, tile_w, nbrs=stacks,
                                    bmax=bmax)
    return (pixels, fid, zbuf, bins, geo, att), rows, grads, grads_halo, stacks


@functools.lru_cache(maxsize=None)
def _both():
    """(JAX results as numpy, the port's prep on the same inputs)."""
    fv, fa, bg, gp = _soup()
    config = _config()
    fwd, rows, grads, grads_halo, stacks = jax.tree_util.tree_map(
        np.asarray, _jax_packed(jnp.asarray(fv), jnp.asarray(fa),
                                jnp.asarray(bg), jnp.asarray(gp), config))
    pixels, fid, zbuf, bins, geo, att = fwd
    assert not bool(bins.overflow)
    # Without JAX's gathered rows: the port's backward builds its face
    # table from the planes and reads it through the entries.
    bins_t = tbin.PackedBins(*(None if v is None else _t(v)
                               for v in bins._replace(rows=None)))
    args = dict(geo=_t(geo), att=_t(att), fid=_t(fid), zbuf=_t(zbuf),
                pixels=_t(pixels), grad_pixels=_t(gp), bins=bins_t)
    config = config.concrete(96)
    return dict(rows=rows, grads=grads, grads_halo=grads_halo,
                stacks=stacks, args=args, config=config,
                bmax=_bmax(config, fv.shape[0], 96, 160))


def _port_prep(**kw):
    b = _both()
    return tp.prepare_backward_packed(
        **b["args"], tile_h=b["config"].tile_h, tile_w=b["config"].tile_w,
        **kw)


def test_entry_rows_plain_match_jax_kernel():
    b = _both()
    got = tp.packed_entry_rows(_port_prep())
    assert got.shape == b["rows"].shape
    _close_scaled(got.numpy(), b["rows"])
    assert (got.abs().sum(1) > 0).sum() > 50


def test_entry_rows_chunk_slices_compose_exactly():
    prep = _port_prep()
    full = tp.packed_entry_rows(prep)
    cut = [0, 1, prep.budget_chunks // 2, prep.budget_chunks]
    parts = [tp.packed_entry_rows(prep, lo, hi)
             for lo, hi in zip(cut[:-1], cut[1:])]
    assert torch.equal(torch.cat(parts), full)
    with pytest.raises(ValueError, match="chunk slice"):
        tp.packed_entry_rows(prep, 2, 1)


def _row_path(prep, c_lo, c_hi):
    """The entry rows as K2 found its owners before it read the face table
    through the entries: every budget row's face row gathered
    (``table2[entries // 8]``), owners matched by the gathered rows' float
    id column, their geometry read from the owner's gathered row."""
    rows = tp._entry_table(prep)[prep.bins.entries.long() // 8]
    owner = tp._owners_plain(prep, rows[:, COL_ID], c_lo, c_hi)
    geo = rows[:, :GEO_USED][torch.clamp(owner, min=0)]
    return tp._owned_sums_plain(prep, owner, geo, c_lo, c_hi)


def _sphere_prep(overflow):
    """The port's backward inputs for its own forward of a UV sphere on
    the CPU (the face table on the bins), under twice the suggested budget
    or, with ``overflow``, half of it, so the binning overflows."""
    clip, colors, faces = sphere_scene(16, 24)
    fv = tt.screen_from_clip(torch.tensor(clip), SIZE, SIZE)[faces]
    fa = torch.tensor(colors)[faces]
    gen = torch.Generator().manual_seed(8)
    bg = torch.rand(SIZE, SIZE, 3, generator=gen)
    grad = torch.randn(SIZE, SIZE, 3, generator=gen)
    config = tr.suggest_config(fv, SIZE, SIZE,
                               tr.RasterConfig(engine="packed"))
    config = config._replace(budget=config.budget // 2 if overflow
                             else 2 * config.budget)
    pixels, fid, zbuf, bins, cfg = tr._forward_impl(fv, fa, bg, config)
    assert bool(bins.overflow) is overflow
    assert bins.table is not None
    return tp.prepare_backward_packed(bins.geo, bins.att, fid, zbuf, pixels,
                                      grad, bins, cfg.tile_h, cfg.tile_w)


@pytest.mark.parametrize("case", ["soup", "soup flat", "sphere", "overflow"])
def test_entry_rows_through_entries_equal_the_row_path(case):
    """The wrapper's plain path (owners by ``entries >> 3``, geometry from
    the table at the owner's face) gives the gathered rows' entry rows bit
    for bit, over the whole budget and over chunk slices: on the soup's
    JAX bins (no table on them: the backward builds it from the planes),
    in image and flat-subtile layout, and on the port's own bins of a
    sphere, which hold sentinel entries in live iterations and padding
    rows past the tiles' runs, with and without an overflowing binning."""
    if case.startswith("soup"):
        prep = _port_prep(**({"nbrs": tuple(_t(s) for s in _both()["stacks"])}
                             if case == "soup flat" else {}))
        assert prep.bins.table is None and prep.flat is (case == "soup flat")
    else:
        prep = _sphere_prep(case == "overflow")
    bins = prep.bins
    assert bool((bins.entries >> 3 == prep.geo.shape[0]).any())
    assert int(bins.n_iters.sum()) * 8 < bins.entries.shape[0]
    n = prep.budget_chunks
    for lo, hi in ((0, n), (0, 1), (1, n // 2), (n // 2, n)):
        got = tp.packed_entry_rows(prep, lo, hi)
        assert torch.equal(got, _row_path(prep, lo, hi))
    assert int((tp.packed_entry_rows(prep) != 0).any(1).sum()) > 20


def _port_backward(**kw):
    b = _both()
    return tp.backward_packed(
        **b["args"], num_faces=90, tile_h=b["config"].tile_h,
        tile_w=b["config"].tile_w, **kw)


def test_backward_packed_matches_jax():
    b = _both()
    got = _port_backward(bmax=b["bmax"])
    for g, w in zip(got, b["grads"]):
        _close_scaled(g.numpy(), w)
    assert np.abs(got[0].numpy()[:, 2:11]).max() > 0      # edge terms


def test_backward_packed_matches_backward_torch():
    b = _both()
    got = _port_backward(bmax=b["bmax"])
    args = b["args"]
    want = trb.backward_torch(args["geo"], args["att"], args["fid"],
                              args["zbuf"], args["pixels"],
                              args["grad_pixels"])
    for g, w in zip(got, want):
        _close_scaled(g.numpy(), w.numpy())


def test_backward_packed_reduces_without_pair_rows():
    """The index_add_ branch (binning dropped the pool backpointers)
    gives the pool reduce's result."""
    b = _both()
    pool = _port_backward(bmax=b["bmax"])
    args = dict(b["args"])
    args["bins"] = args["bins"]._replace(pair_rows=None, pool_offs=None)
    flat = tp.backward_packed(**args, num_faces=90,
                              tile_h=b["config"].tile_h,
                              tile_w=b["config"].tile_w, bmax=b["bmax"])
    for g, w in zip(flat, pool):
        _close_scaled(g.numpy(), w.numpy(), rtol=1e-5)


def test_halo_neighbor_maps_path_matches():
    """``nbrs`` precomputed by neighbor_maps (the sharded halo path's
    input) gives the prologue's result, and JAX's; its fields are in
    flat-subtile layout, as JAX's halo path hands them to its kernel."""
    b = _both()
    stacks = tuple(_t(s) for s in b["stacks"])
    halo = _port_backward(bmax=b["bmax"], nbrs=stacks)
    plain = _port_backward(bmax=b["bmax"])
    prep_h = _port_prep(nbrs=stacks)
    prep_p = _port_prep()
    assert prep_h.flat and not prep_p.flat
    swap = tf.flat_subtile_swap_plain
    assert torch.equal(swap(prep_h.bits), prep_p.bits)
    assert torch.equal(swap(prep_h.fid_p), prep_p.fid_p)
    assert torch.equal(swap(prep_h.pix_cf), prep_p.pix_cf)
    assert torch.equal(swap(prep_h.grad_cf), prep_p.grad_cf)
    torch.testing.assert_close(swap(prep_h.sval), prep_p.sval, **TOL)
    for g_h, g_p, w in zip(halo, plain, b["grads_halo"]):
        _close_scaled(g_h.numpy(), g_p.numpy(), rtol=1e-5)
        _close_scaled(g_h.numpy(), w)


# --- end to end through rasterize_screen ---------------------------------------


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_vjp(fv, fa, bg, gp, config):
    def render(fv, fa, bg):
        return jr.rasterize_screen(fv, fa, bg, config)[0]

    _, vjp_fn = jax.vjp(render, fv, fa, bg)
    return vjp_fn(gp)


def test_autograd_matches_jax_vjp_on_soup():
    fv, fa, bg, gp = _soup(seed=9)
    config = jr.suggest_config(jnp.asarray(fv), 96, 160,
                               jr.RasterConfig(engine="packed"))
    config = config._replace(budget=2 * config.budget)
    d_fv_j, d_fa_j, d_bg_j = (np.asarray(a) for a in _jax_vjp(
        jnp.asarray(fv), jnp.asarray(fa), jnp.asarray(bg), jnp.asarray(gp),
        config))
    leaves = [torch.tensor(a, requires_grad=True) for a in (fv, fa, bg)]
    pixels, _, _, overflow = tr.rasterize_screen(
        *leaves, convert.config_from_jax(config))
    assert not bool(overflow)
    (pixels * torch.tensor(gp)).sum().backward()
    d_fv, d_fa, d_bg = (t.grad.numpy() for t in leaves)
    np.testing.assert_allclose(d_bg, d_bg_j, atol=1e-6)
    np.testing.assert_allclose(d_fa, d_fa_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(d_fv, d_fv_j, rtol=1e-3, atol=1e-3)
    assert np.abs(d_fv).max() > 0


def test_sixteen_channels_through_the_api_match_jax():
    """More channels than one launch of the backward kernel stages on an
    H100 (14): ``rasterise_with_aux`` on the packed engine gives dirt_tpu's
    image and gradients at C = 16 (on the CPU through the plain version;
    the card test holds the kernel's column groups against it). The scene
    and caps are tests/test_sharding.py's; tolerances as above."""
    import dirt_tpu
    import dirt_tpu_torch
    from _torch_port_scene import SHARDING_CAPS, sharding_scene

    verts, _, faces, _ = sharding_scene(3)
    rng = np.random.RandomState(4)
    colors = rng.rand(verts.shape[0], 16).astype(np.float32)
    bg = rng.rand(128, 128, 16).astype(np.float32)
    weights = rng.randn(128, 128, 16).astype(np.float32)

    def jax_loss(v, c, b):
        pixels, fid, _, overflow = dirt_tpu.rasterise_with_aux(
            b, v, c, jnp.asarray(faces),
            config=jr.RasterConfig(**SHARDING_CAPS["packed"]), clip=False)
        return jnp.sum(pixels * weights), (pixels, fid, overflow)

    (_, (pix_j, fid_j, ovf_j)), grads_j = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(verts), jnp.asarray(colors), jnp.asarray(bg))
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (verts, colors, bg)]
    pixels, fid, _, overflow = dirt_tpu_torch.rasterise_with_aux(
        leaves[2], leaves[0], leaves[1], torch.tensor(faces),
        config=tr.RasterConfig(**SHARDING_CAPS["packed"]), clip=False)
    (pixels * torch.tensor(weights)).sum().backward()
    assert not bool(overflow) and not bool(ovf_j)
    np.testing.assert_array_equal(fid.numpy(), np.asarray(fid_j))
    # Pixels as tests/test_torch_pipeline.py holds the API's: 1e-5 (the
    # scene's faces span the image, far from their anchors).
    np.testing.assert_allclose(pixels.detach().numpy(), np.asarray(pix_j),
                               atol=1e-5)
    for leaf, want in zip(leaves, grads_j):
        _close_scaled(leaf.grad.numpy(), want)
    assert np.abs(np.asarray(grads_j[0])).max() > 0
