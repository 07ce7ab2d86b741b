"""The float64 oracle of ``dirt_tpu.ref.slowref`` as the parity tests use it.

Two float32 renders of one scene may round to opposite sides of the exact
value: on the bench camera's sphere one pixel comes out 0.6737749 in the
port and 0.6737856 in ``dirt_tpu``, around the oracle's 0.67378004. Each is
within 5.6e-6 of the oracle, but 1.07e-5 from the other. So the forward
checks hold each package to the oracle (:func:`assert_near_oracle`) and
compare only the face ids of the two packages with each other.

A boundary pair's decisions can flip between the two packages the same
way: which of the two pixels is in front (their depths), and which edge of
the front face the pair crosses (the sign of an edge's value at a pixel
centre, in float32 from each package's own plane table; ``dirt_tpu``'s
jitted clip and screen transform round the face table differently from the
port's, by up to 1.4e-6 relative on the clipped sphere).
:func:`razor_decision_faces` names the faces whose decision differs, from
both packages' depth maps and plane tables (:func:`jax_planes`). Their
vertices leave the two packages' comparison, and
:func:`oracle_vertex_grads` gives what the port is held to on them instead:
``slowref.oracle_backward`` fed the port's own face ids, depth and pixels,
chained to the vertices through ``dirt_tpu``'s clip and screen transform.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dirt_tpu import rasterise_ops as jro
from dirt_tpu.ops import raster as jr
from dirt_tpu.ops import triangle_setup as jts
from dirt_tpu.ref import slowref
from dirt_tpu_torch import convert
from dirt_tpu_torch import rasterise_ops as tro
from dirt_tpu_torch.ops import raster as tr
from dirt_tpu_torch.ops import triangle_setup as tts
from dirt_tpu_torch.ops.raster_fwd import BIG_Z
from dirt_tpu_torch.ops.triangle_setup import GEO_AX, GEO_AY, GEO_EDGE


def oracle_forward(bg, verts, colors, faces, clip):
    """(pixels, fid, zbuf) of the float64 oracle, fid in original face ids
    and zbuf BIG_Z on the background, as both packages return them."""
    faces = np.asarray(faces)
    if clip:
        pix, fid, z = slowref.oracle_forward_clipped(
            verts[faces], colors[faces], bg)
    else:
        height, width = bg.shape[:2]
        fv = slowref.screen_from_clip(verts, height, width)[faces]
        pix, fid, z = slowref.oracle_forward(fv, colors[faces], bg)
    return pix, fid, np.where(fid >= 0, z, np.float32(BIG_Z))


def assert_near_oracle(pix, fid, z, oracle, atol, razor):
    """One package's render against the oracle's: face ids equal except on
    at most ``razor`` of the pixels (edge tests within float32 rounding of
    zero); where they are equal, pixels and depth within ``atol``."""
    o_pix, o_fid, o_z = oracle
    same = fid == o_fid
    assert (~same).mean() <= razor, f"{(~same).mean():.4%} fids differ"
    np.testing.assert_allclose(pix[same], o_pix[same], rtol=0, atol=atol)
    np.testing.assert_allclose(z[same], o_z[same], rtol=0, atol=atol)


def port_slots(bg, verts, colors, faces, config, clip):
    """The port's render at the rasterizer's slots (clipped faces keep a
    primary slot per face and compact their second triangles behind):
    (face_verts [S, 3, 4], face_attrs [S, 3, C], fid [H, W] slot ids, zbuf,
    pixels, orig_id [S])."""
    bg_t, v_t, c_t, f_t = convert.scene_from_numpy(bg, verts, colors, faces,
                                                   "cpu")
    height, width = bg.shape[:2]
    fv, fa, config, orig_id, _ = tro._clip_space_faces(
        v_t, c_t, f_t, height, width, config, clip)
    pix, fid, z, _ = tr.rasterize_screen(fv, fa, bg_t, config)
    orig = (np.arange(len(faces)) if orig_id is None
            else orig_id.numpy())
    return (fv.numpy(), fa.numpy(), fid.numpy(), z.numpy(), pix.numpy(),
            orig)


def jax_planes(bg, verts, colors, faces, config, clip):
    """``dirt_tpu``'s plane table [S, 24] at the rasterizer's slots: its
    jitted clip and screen transform, then its triangle setup, as its
    backward computes them. Fusion rounds the face table differently from
    the port's (up to 1.4e-6 relative on the clipped sphere), and the
    jitted table is the one ``dirt_tpu``'s ``rasterise_with_aux`` keeps
    for its backward (equal bit for bit on the clipped sphere)."""
    height, width = bg.shape[:2]
    jconfig = jr.RasterConfig(**config._asdict())

    @jax.jit
    def planes(v, c):
        fv, fa = jro._clip_space_faces(v, c, jnp.asarray(faces), height,
                                       width, jconfig, clip)[:2]
        return jts.setup_planes(fv, fa)[0]

    return np.asarray(planes(jnp.asarray(verts), jnp.asarray(colors)))


def _pairs(height, width):
    """Every ordered pair (own pixel, neighbour) of 4-adjacent pixels, as
    flat index arrays, with whether the pair is horizontal and the
    neighbour's offset (+1 right or below, -1 left or above)."""
    idx = np.arange(height * width).reshape(height, width)
    own = [idx[:, :-1], idx[:, 1:], idx[:-1], idx[1:]]
    nbr = [idx[:, 1:], idx[:, :-1], idx[1:], idx[:-1]]
    sizes = [a.size for a in own]
    return (np.concatenate([a.ravel() for a in own]),
            np.concatenate([a.ravel() for a in nbr]),
            np.repeat([True, True, False, False], sizes),
            np.repeat(np.float32([1, -1, 1, -1]), sizes))


def crossing_edges(geo, slot, pix, width, horizontal, offset):
    """The edge of face ``slot`` that the pair from own pixel ``pix`` to
    its neighbour crosses, picked as the backward picks it
    (``dirt_tpu.ops.raster_bwd.pixel_cotangents_core``): the first edge
    whose value, in float32 from the plane table ``geo``, is >= 0 at the
    own pixel centre and < 0 at the neighbour's; -1 where none is."""
    g = geo[slot]
    dx = (pix % width).astype(np.float32) + np.float32(0.5) - g[:, GEO_AX]
    dy = (pix // width).astype(np.float32) + np.float32(0.5) - g[:, GEO_AY]
    edge = np.full(len(slot), -1)
    for j in range(3):
        a, b, c = (g[:, GEO_EDGE + 3 * j + k] for k in range(3))
        e = a * dx + b * dy + c
        e_back = e + offset * np.where(horizontal, a, b)
        edge = np.where((edge < 0) & (e >= 0) & (e_back < 0), j, edge)
    return edge


def razor_decision_faces(slots, z_other, geo_other):
    """Original ids of the faces whose boundary-pair decision flips between
    the packages.

    ``slots`` is :func:`port_slots`' result; ``z_other`` and ``geo_other``
    are the other package's depth map and plane table (:func:`jax_planes`).
    Over the pairs of neighbouring pixels the port owns with different
    slots: (a) the front test, where the sign of the depth difference
    differs between the port's and the other package's depths (both
    pixels' faces); (b) the crossing-edge test of the own pixel's face
    (:func:`crossing_edges`), where the port's plane table and the other
    package's pick different edges.
    """
    fv, fa, fid, z, _, orig = slots
    height, width = fid.shape
    own, nbr, horizontal, offset = _pairs(height, width)
    fid, z, z_other = fid.ravel(), z.ravel(), np.asarray(z_other).ravel()
    pair = (fid[own] != fid[nbr]) & (fid[own] >= 0)
    own, nbr = own[pair], nbr[pair]
    horizontal, offset = horizontal[pair], offset[pair]
    flip = (np.sign(z[own] - z[nbr])
            != np.sign(z_other[own] - z_other[nbr]))
    razor = set(fid[own][flip].tolist() + fid[nbr][flip].tolist())
    geo = tts.setup_planes(torch.tensor(fv), torch.tensor(fa))[0].numpy()
    f = fid[own]
    edges = [crossing_edges(g, f, own, width, horizontal, offset)
             for g in (geo, np.asarray(geo_other))]
    razor.update(f[edges[0] != edges[1]].tolist())
    razor.discard(-1)
    return np.unique(orig[np.asarray(sorted(razor), int)])


def oracle_vertex_grads(bg, verts, colors, faces, w, slots, config, clip):
    """(d_vertices, d_colors) of the float64 oracle's backward fed the
    port's own slot ids, depth and pixels (``slots``), chained to the
    vertices through ``dirt_tpu``'s gather, clip and screen transform."""
    fv, fa, fid, z, pix, _ = slots
    d_fv, d_fa, _ = slowref.oracle_backward(fv, fa, bg, fid, z, pix, w)
    height, width = bg.shape[:2]
    jconfig = jr.RasterConfig(**config._asdict())
    _, vjp = jax.vjp(
        lambda v, c: jro._clip_space_faces(
            v, c, jnp.asarray(faces), height, width, jconfig, clip)[:2],
        jnp.asarray(verts), jnp.asarray(colors))
    d_v, d_c = vjp((jnp.asarray(d_fv), jnp.asarray(d_fa)))
    return np.asarray(d_v), np.asarray(d_c)


def vertex_keep(faces, num_verts, fid_t, fid_j, slots, z_j, geo_j):
    """[V] bool: False at the vertices of the faces on pixels whose face ids
    differ between the packages (``fid_t``, ``fid_j``) and of
    :func:`razor_decision_faces`."""
    differ = fid_t != fid_j
    razor = np.concatenate([fid_t[differ], fid_j[differ],
                            razor_decision_faces(slots, z_j, geo_j)]
                           ).astype(int)
    keep = np.ones(num_verts, bool)
    keep[np.asarray(faces)[np.unique(razor[razor >= 0])].reshape(-1)] = False
    return keep
