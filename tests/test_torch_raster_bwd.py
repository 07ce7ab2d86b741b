"""dirt_tpu_torch.ops.raster_bwd and the op's autograd vs dirt_tpu's.

Pieces first, on identical random inputs made with numpy: the neighbor
maps, the cotangent core (both neighbor forms), the anchor terms and the
face assembly. Tolerance: integers equal, floats allclose(rtol=1e-6,
atol=1e-6) (the same expressions in the same order; XLA may fuse a
multiply into an add where PyTorch rounds each step).

Then ``backward_torch`` against ``backward_jax`` (the pure engines) on a
real forward, and the whole op end to end: ``torch.autograd`` through
``rasterise_with_aux`` against ``jax.vjp`` of ``dirt_tpu``'s, packed
engine, on the small sphere with ``clip`` off and on, and on the same
sphere so close that faces cross the near plane (``clip`` on: the clip's
interpolation and compaction carry gradients). Tolerances of
tests/test_raster_grad.py (packed vs dense): d_background atol 1e-6,
d_colors rtol 1e-4 atol 1e-5, d_vertices rtol 1e-3 atol 1e-3 (the two
packed backwards sum per-entry rows in different orders, JAX through
f32-faithful bf16 matmuls). Where fids differ on razor edges (at most 0.5%
of pixels, the policy of test_torch_pipeline.py), and where a face's
boundary-pair decision flips between the packages
(tests/_torch_port_oracle.py), the vertices of those faces are
left out of the comparison, and the port's are held to the float64
oracle's backward there instead, with the same tolerances.

Last, the port against the ``slowref`` oracle on the occlusion and
perspective scenes of tests/test_raster_grad.py, forced to the packed
engine, with that file's tolerances.
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
from _torch_port_scene import SIZE, screen_soup, sphere_scene
from dirt_tpu.ops import raster_bwd as jb
from dirt_tpu.ops.raster import RasterConfig as JaxConfig
from dirt_tpu.ref import slowref
from dirt_tpu_torch import convert
from dirt_tpu_torch.ops import raster as tr
from dirt_tpu_torch.ops import raster_bwd as tb
from dirt_tpu_torch.ops.raster_fwd import BIG_Z
from dirt_tpu_torch.ops.triangle_setup import setup_planes

TOL = dict(rtol=1e-6, atol=1e-6)
RAZOR = 0.005


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _image_fields(seed, height=16, width=24, channels=3):
    """fid [H, W] in -2..8, zbuf with BIG_Z holes, pixels/grad [C, H, W]."""
    rng = np.random.RandomState(seed)
    fid = rng.randint(-2, 9, (height, width)).astype(np.int32)
    zbuf = np.where(rng.rand(height, width) < 0.2, BIG_Z,
                    rng.randn(height, width)).astype(np.float32)
    # A few exact depth ties, to exercise the strict / non-strict rule.
    zbuf[:, 5] = zbuf[:, 4]
    zbuf[7] = zbuf[6]
    pix = rng.rand(channels, height, width).astype(np.float32)
    grad = rng.randn(channels, height, width).astype(np.float32)
    return fid, zbuf, pix, grad


def _geo_planes(seed, height=16, width=24):
    """[24, H, W] per-pixel plane rows: anchors near the pixels, edge
    slopes of either sign, a positive denominator plane."""
    rng = np.random.RandomState(seed)
    g = rng.uniform(-1.0, 1.0, (24, height, width)).astype(np.float32)
    g[0] = rng.uniform(0, width, (height, width))
    g[1] = rng.uniform(0, height, (height, width))
    for j in range(3):
        g[4 + 3 * j] = rng.uniform(-3, 3, (height, width))
    g[14:16] *= 0.01
    g[16] = rng.uniform(0.5, 1.5, (height, width))
    g[5, 0, :3] = 0.0          # a vertical edge: a = 0 takes the guard
    return g


def test_boundary_cases_match():
    assert tb.boundary_cases() == jb.boundary_cases()
    assert (tb.GEO_USED_END, tb.A_EPS) == (jb.GEO_USED_END, jb.A_EPS)


def test_neighbor_maps_match_jax():
    fid, zbuf, pix, grad = _image_fields(3)
    want = jb.neighbor_maps(jnp.asarray(fid), jnp.asarray(zbuf),
                            jnp.asarray(pix), jnp.asarray(grad))
    got = tb.neighbor_maps(torch.tensor(fid), torch.tensor(zbuf),
                           torch.tensor(pix), torch.tensor(grad))
    for (nf_t, nz_t, sv_t), (nf_j, nz_j, sv_j) in zip(got, want):
        assert nf_t.dtype == torch.int32
        np.testing.assert_array_equal(nf_t.numpy(), np.asarray(nf_j))
        np.testing.assert_array_equal(nz_t.numpy(), np.asarray(nz_j))
        _close(sv_t.numpy(), sv_j)


@pytest.mark.parametrize("form", ["triple", "pair"])
def test_pixel_cotangents_core_matches_jax(form):
    height, width = 16, 24
    fid, zbuf, pix, grad = _image_fields(5, height, width)
    g16 = _geo_planes(6, height, width)
    rng = np.random.RandomState(7)
    covered = rng.rand(height, width) < 0.8
    xg = np.broadcast_to(np.arange(width, dtype=np.float32) + 0.5,
                         (height, width))
    yg = np.broadcast_to(np.arange(height, dtype=np.float32)[:, None] + 0.5,
                         (height, width))
    if form == "triple":
        nbr_j = jb.neighbor_maps(jnp.asarray(fid), jnp.asarray(zbuf),
                                 jnp.asarray(pix), jnp.asarray(grad))
        nbr_np = [tuple(np.asarray(a) for a in n) for n in nbr_j]
        fid_pair, z = fid, zbuf
    else:
        nbr_np = [(rng.rand(height, width) < 0.3,
                   rng.randn(height, width).astype(np.float32))
                  for _ in range(4)]
        fid_pair = z = None

    def run(mod, arr):
        return mod.pixel_cotangents_core(
            arr(g16), arr(covered),
            None if fid_pair is None else arr(fid_pair),
            None if z is None else arr(z), arr(pix), arr(grad),
            [tuple(arr(a) for a in n) for n in nbr_np], arr(xg), arr(yg))

    geo_j, att_j = run(jb, jnp.asarray)
    geo_t, att_t = run(tb, lambda a: torch.tensor(np.array(a)))
    assert len(geo_t) == len(geo_j) and len(att_t) == len(att_j) == 9
    for got, want in zip(geo_t + att_t, list(geo_j) + list(att_j)):
        _close(got.numpy(), want)
    # The boundary term did real work.
    assert sum(float(np.abs(np.asarray(geo_j[k])).sum())
               for k in range(2, 11)) > 0


def _face_arrays(seed, num_faces=40, channels=3):
    rng = np.random.RandomState(seed)
    geo = rng.randn(num_faces, 24).astype(np.float32)
    geo[:, 17:] = 0.0
    att = rng.randn(num_faces, 3 * channels).astype(np.float32)
    rows = rng.randn(num_faces, 12 + 3 * channels).astype(np.float32)
    return geo, att, rows


def test_anchor_cotangents_match_jax():
    geo, att, _ = _face_arrays(8)
    rng = np.random.RandomState(9)
    d_geo = rng.randn(*geo.shape).astype(np.float32)
    d_att = rng.randn(*att.shape).astype(np.float32)
    want = jb.anchor_cotangents(jnp.asarray(geo), jnp.asarray(att),
                                jnp.asarray(d_geo), jnp.asarray(d_att))
    got = tb.anchor_cotangents(*(torch.tensor(a)
                                 for a in (geo, att, d_geo, d_att)))
    _close(got.numpy(), want)


def test_assemble_face_gradients_match_jax():
    geo, att, rows = _face_arrays(10)
    want = jb.assemble_face_gradients(jnp.asarray(geo), jnp.asarray(att),
                                      jnp.asarray(rows), 3)
    got = tb.assemble_face_gradients(torch.tensor(geo), torch.tensor(att),
                                     torch.tensor(rows), 3)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@functools.lru_cache(maxsize=None)
def _soup_forward():
    """A real packed forward (port, CPU) on a soup with depth overlaps."""
    fv, fa = screen_soup(70, 80, 200, seed=11, channels=3, spread=25.0)
    bg = np.random.RandomState(12).rand(80, 200, 3).astype(np.float32)
    config = tr.suggest_config(torch.tensor(fv), 80, 200,
                               tr.RasterConfig(engine="packed"))
    pixels, fid, zbuf, bins, _ = tr._forward_impl(
        torch.tensor(fv), torch.tensor(fa), torch.tensor(bg), config)
    assert not bool(bins.overflow)
    geo, att, _ = setup_planes(torch.tensor(fv), torch.tensor(fa))
    grad = np.random.RandomState(13).randn(80, 200, 3).astype(np.float32)
    return (geo.numpy(), att.numpy(), fid.numpy(), zbuf.numpy(),
            pixels.numpy(), grad)


@pytest.mark.parametrize("own", [False, True])
def test_backward_torch_matches_backward_jax(own):
    geo, att, fid, zbuf, pixels, grad = _soup_forward()
    own_mask = None
    if own:
        own_mask = np.zeros(fid.shape, bool)
        own_mask[10:60] = True
    want = jax.jit(jb.backward_jax)(
        geo, att, fid, zbuf, pixels, grad,
        None if own_mask is None else jnp.asarray(own_mask))
    got = tb.backward_torch(
        *(torch.tensor(a) for a in (geo, att, fid, zbuf, pixels, grad)),
        own_mask=None if own_mask is None else torch.tensor(own_mask))
    # Per-face sums of ~10^2 pixel terms in another order (segment_sum
    # vs index_add_): f32 reassociation, scaled to each array.
    for g, w in zip(got, want):
        w = np.asarray(w)
        _close(g.numpy(), w, rtol=1e-5, atol=1e-6 * np.abs(w).max())
    assert np.abs(got[0].numpy()[:, 2:11]).max() > 0   # edge terms


# --- end to end ---------------------------------------------------------------


_DISTANCE = {"sphere": 3.0, "crossing": 0.9}


@functools.lru_cache(maxsize=None)
def _sphere_inputs(kind, clip):
    verts, colors, faces = sphere_scene(distance=_DISTANCE[kind])
    bg = np.random.RandomState(4).rand(SIZE, SIZE, 3).astype(np.float32)
    w = np.random.RandomState(14).randn(SIZE, SIZE, 3).astype(np.float32)
    config = dirt_tpu.suggest_raster_config(
        verts, faces, SIZE, SIZE, config=JaxConfig(engine="packed"),
        clip=clip)
    return bg, verts, colors, faces, w, config


@functools.lru_cache(maxsize=None)
def _jax_grads(kind, clip):
    bg, verts, colors, faces, w, config = _sphere_inputs(kind, clip)

    def render(b, v, c):
        pixels, fid, zbuf, overflow = dirt_tpu.rasterise_with_aux(
            b, v, c, faces, config=config, clip=clip)
        return pixels, (fid, zbuf, overflow)

    _, vjp_fn, (fid, zbuf, overflow) = jax.vjp(
        render, jnp.asarray(bg), jnp.asarray(verts), jnp.asarray(colors),
        has_aux=True)
    d_bg, d_v, d_c = vjp_fn(jnp.asarray(w))
    return (np.asarray(fid), np.asarray(zbuf), bool(overflow),
            np.asarray(d_v), np.asarray(d_c), np.asarray(d_bg))


def _torch_grads(kind, clip):
    bg, verts, colors, faces, w, config = _sphere_inputs(kind, clip)
    bg_t, v_t, c_t, f_t = convert.scene_from_numpy(bg, verts, colors, faces,
                                                   "cpu")
    leaves = [t.clone().requires_grad_() for t in (bg_t, v_t, c_t)]
    pixels, fid, _, overflow = dirt_tpu_torch.rasterise_with_aux(
        leaves[0], leaves[1], leaves[2], f_t,
        config=convert.config_from_jax(config), clip=clip)
    (pixels * torch.tensor(w)).sum().backward()
    return (fid.numpy(), bool(overflow), leaves[1].grad.numpy(),
            leaves[2].grad.numpy(), leaves[0].grad.numpy())


@pytest.mark.parametrize("kind,clip", [("sphere", False), ("sphere", True),
                                       ("crossing", True)])
def test_autograd_matches_jax_vjp_on_sphere(kind, clip):
    fid_j, z_j, ovf_j, d_v_j, d_c_j, d_bg_j = _jax_grads(kind, clip)
    fid_t, ovf_t, d_v_t, d_c_t, d_bg_t = _torch_grads(kind, clip)
    assert ovf_t is ovf_j is False
    differ = fid_t != fid_j
    assert differ.mean() <= RAZOR
    bg, verts, colors, faces, w, config = _sphere_inputs(kind, clip)
    config = convert.config_from_jax(config)
    slots = port_slots(bg, verts, colors, faces, config, clip)
    geo_j = jax_planes(bg, verts, colors, faces, config, clip)
    keep = vertex_keep(faces, d_v_t.shape[0], fid_t, fid_j, slots, z_j,
                       geo_j)
    assert keep.mean() > 0.9
    np.testing.assert_allclose(d_bg_t, d_bg_j, atol=1e-6)
    np.testing.assert_allclose(d_c_t[keep], d_c_j[keep], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(d_v_t[keep], d_v_j[keep], rtol=1e-3,
                               atol=1e-3)
    if not keep.all():
        d_v_o, d_c_o = oracle_vertex_grads(bg, verts, colors, faces, w,
                                           slots, config, clip)
        np.testing.assert_allclose(d_c_t[~keep], d_c_o[~keep], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(d_v_t[~keep], d_v_o[~keep], rtol=1e-3,
                                   atol=1e-3)
    assert np.abs(d_v_t).max() > 0 and np.abs(d_c_t).max() > 0


@pytest.mark.parametrize("kind,clip", [("sphere", False),
                                       ("crossing", True)])
def test_autograd_matches_oracle_on_sphere(kind, clip):
    """Every vertex and color gradient of the port against the float64
    oracle's backward, fed the port's own face ids, depth and pixels and
    chained through ``dirt_tpu``'s clip and screen transform, with the
    tolerances above. On the clipped sphere ``dirt_tpu``'s own gradient
    can land 0.42 off the oracle at vertex 98, where its jitted clip rounds
    the face table so that a boundary pair's crossing test, 7e-7 px from
    the edge, picks no edge (tests/_torch_port_oracle.py); the port's must
    not."""
    bg, verts, colors, faces, w, config = _sphere_inputs(kind, clip)
    config = convert.config_from_jax(config)
    _, _, d_v_t, d_c_t, _ = _torch_grads(kind, clip)
    slots = port_slots(bg, verts, colors, faces, config, clip)
    d_v_o, d_c_o = oracle_vertex_grads(bg, verts, colors, faces, w, slots,
                                       config, clip)
    np.testing.assert_allclose(d_c_t, d_c_o, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(d_v_t, d_v_o, rtol=1e-3, atol=1e-3)
    assert np.abs(d_v_o).max() > 1.0


def test_backward_twice_with_retain_graph_is_equal():
    bg, verts, colors, faces, w, config = _sphere_inputs("sphere", False)
    v = torch.tensor(verts, requires_grad=True)
    pixels = dirt_tpu_torch.rasterise(
        torch.tensor(bg), v, torch.tensor(colors), torch.tensor(faces),
        config=convert.config_from_jax(config), clip=False)
    loss = (pixels * torch.tensor(w)).sum()
    first, = torch.autograd.grad(loss, v, retain_graph=True)
    second, = torch.autograd.grad(loss, v)
    assert torch.equal(first, second) and first.abs().max() > 0


# --- the slowref oracle -------------------------------------------------------


def _screen_face(verts_xy, z=0.0, invw=1.0):
    verts_xy = np.asarray(verts_xy, np.float32)
    f = verts_xy.shape[0]
    z_arr = np.broadcast_to(np.asarray(z, np.float32), (f, 3))
    w_arr = np.broadcast_to(np.asarray(invw, np.float32), (f, 3))
    return np.concatenate([verts_xy, z_arr[..., None], w_arr[..., None]],
                          axis=-1).astype(np.float32)


def _oracle_scene(kind):
    """The occlusion and perspective scenes of tests/test_raster_grad.py."""
    if kind == "occlusion":
        face_verts = np.stack([
            _screen_face([[[8.4, 55.1], [56.2, 53.8], [30.1, 9.2]]], z=0.5)[0],
            _screen_face([[[20.3, 48.2], [44.6, 47.1], [33.8, 20.4]]],
                         z=-0.5)[0],
        ])
        face_attrs = np.array(
            [[[0.9], [0.9], [0.9]], [[0.1], [0.2], [0.3]]], np.float32)
        background = np.zeros((64, 64, 1), np.float32)
        grad = np.random.RandomState(1).randn(64, 64, 1).astype(np.float32)
    else:
        face_verts = np.array(
            [[[6.2, 6.3, -0.5, 1.0], [57.6, 6.1, 0.5, 0.25],
              [30.9, 57.8, 0.0, 0.6]]], np.float32)
        face_attrs = np.array([[[0.1, 0.8], [0.9, 0.2], [0.5, 0.5]]],
                              np.float32)
        background = np.zeros((64, 64, 2), np.float32)
        grad = np.random.RandomState(2).randn(64, 64, 2).astype(np.float32)
    return face_verts, face_attrs, background, grad


@pytest.mark.parametrize("kind", ["occlusion", "perspective"])
def test_packed_backward_matches_slowref_oracle(kind):
    face_verts, face_attrs, background, grad = _oracle_scene(kind)
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (face_verts, face_attrs, background)]
    pixels, _, _, overflow = tr.rasterize_screen(
        *leaves, tr.RasterConfig(engine="packed"))
    assert not bool(overflow)
    (pixels * torch.tensor(grad)).sum().backward()
    ref_pix, fid, zbuf = slowref.oracle_forward(face_verts, face_attrs,
                                                background)
    ref_d_fv, ref_d_fa, ref_d_bg = slowref.oracle_backward(
        face_verts, face_attrs, background, fid, zbuf, ref_pix, grad)
    np.testing.assert_allclose(pixels.detach().numpy(), ref_pix, atol=1e-5)
    np.testing.assert_allclose(leaves[1].grad.numpy(), ref_d_fa, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(leaves[0].grad.numpy(), ref_d_fv, rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(leaves[2].grad.numpy(), ref_d_bg, atol=1e-6)
    if kind == "perspective":
        assert np.abs(ref_d_fv[0, :, 3]).max() > 0
