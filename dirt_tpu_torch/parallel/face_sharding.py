"""Face-list sharding: each member of a group renders a share of the faces.

Counterpart of ``dirt_tpu/parallel/face_sharding.py``. Member i of the
group owns the contiguous global face ids ``[i F / n, (i + 1) F / n)`` and
renders them over the whole image (``raster._forward_impl``, on whatever
engine that face count resolves to). The members' partial images composite
by the lexicographic minimum over (depth, global face id), two elementwise
minima over the group (``group.all_reduce_min``) and one masked sum: at
equal depth the lower global id wins, as on one device, so the composite is
the single-device render.

Backward (rows x faces): member i takes the composite's row band i (H / n
rows, starting at ``r0 = i H / n``) with one halo row from each neighbouring
band (``group.exchange_rows``, as the row-sharded renderer's slabs do), so a
boundary pair across bands is evaluated once, by the band of its front
pixel. It gathers every member's plane rows (``group.all_gather``), runs the
per-pixel cotangents of its band over all global faces
(``raster_bwd.backward_torch`` with ``own_mask``: the halo rows supply
neighbour data only; its face sum is a float32 ``index_add_``, where
``dirt_tpu`` uses ``segment_sum``), and routes each face's row to the member
that owns the face (``group.reduce_scatter``), which pulls it back through
its own setup. The planes are set up in global screen space, as the forward
renders; the band's arrays start at image row ``r0 - 1``, so the gathered
planes are moved ``r0 - 1`` rows up (their anchor row, the only column a
translation changes) to meet ``backward_torch``'s band-local pixel
coordinates. A translation has unit Jacobian: the moved planes' cotangents
are the global planes' ones. ``backward_torch`` adds the anchor cotangents
before the reduce-scatter; they are linear in the face rows and read only
the slopes, which the move leaves alone, so that equals ``dirt_tpu``
adding them after it. The background's gradient is nonzero on each
member's own band only; the vertices' and colors' gradients are summed over
the group once, by ``group.replicated``.
"""

from __future__ import annotations

import torch

from dirt_tpu_torch.ops import raster, raster_bwd
from dirt_tpu_torch.ops.raster import RasterConfig
from dirt_tpu_torch.ops.raster_fwd import BIG_Z
from dirt_tpu_torch.ops.triangle_setup import (
    GEO_AY,
    GEO_WIDTH,
    screen_from_clip,
    setup_planes,
)
from dirt_tpu_torch.parallel.sharding import (
    _exchange_halo_rows,
    _exchange_halos,
    _split_rows,
)
from dirt_tpu_torch.rasterise_ops import _as_inputs

# The global face id of a pixel no member covers, above every real one.
_BIG_ID = 2**30


class _FaceShardOp(torch.autograd.Function):
    """Global screen-space faces -> the composited image of the members'
    partial renders (with fid, depth and the overflow flag), replicated on
    every member."""

    @staticmethod
    def forward(ctx, face_verts, face_attrs, background, config, group):
        f_local = face_verts.shape[0] // group.size
        neutral = torch.zeros_like(background)
        zkeys, gids, parts, overflows = [], [], [], []
        for m in group.local:
            own = slice(m * f_local, (m + 1) * f_local)
            pixels, fid, zbuf, bins, _ = raster._forward_impl(
                face_verts[own], face_attrs[own], neutral, config)
            covered = fid >= 0
            gids.append(torch.where(covered, fid + m * f_local, _BIG_ID))
            zkeys.append(torch.where(covered, zbuf, BIG_Z))
            parts.append(pixels)
            overflows.append(torch.any(bins.overflow).to(torch.float32)
                             .reshape(1))
        zmins = group.all_reduce_min(zkeys)
        gmins = group.all_reduce_min([
            torch.where(z == zmin, g, _BIG_ID)
            for z, zmin, g in zip(zkeys, zmins, gids)])
        parts = [torch.where(((z == zmin) & (g == gmin))[..., None], p, 0.0)
                 .contiguous()
                 for z, zmin, g, gmin, p in zip(zkeys, zmins, gids, gmins,
                                                parts)]
        group.all_reduce_async_(parts).wait()
        group.all_reduce_async_(overflows).wait()
        covered = gmins[0] < _BIG_ID
        # Over the true background inside the op: the boundary gradients
        # need the image and its cotangent at background pixels too.
        pixels = torch.where(covered[..., None], parts[0], background)
        fid = torch.where(covered, gmins[0], -1)
        zbuf = torch.where(covered, zmins[0], BIG_Z)
        overflow = overflows[0][0] > 0
        ctx.mark_non_differentiable(fid, zbuf, overflow)
        ctx.save_for_backward(face_verts.detach(), face_attrs.detach(),
                              pixels, fid, zbuf)
        ctx.group = group
        return pixels, fid, zbuf, overflow

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_pixels, *_):
        face_verts, face_attrs, pixels, fid, zbuf = ctx.saved_tensors
        group = ctx.group
        need_fv, need_fa, need_bg = ctx.needs_input_grad[:3]
        members = list(group.local)
        band_h = fid.shape[0] // group.size
        f_local = face_verts.shape[0] // group.size
        bands = _split_rows((fid, zbuf, pixels, grad_pixels.to(torch.float32)),
                            group.size)
        bands = [bands[m] for m in members]
        d_bg = None
        if need_bg:
            d_bg = torch.zeros_like(pixels)
            for m, (fid_b, _, _, grad_b) in zip(members, bands):
                d_bg[m * band_h:(m + 1) * band_h] = torch.where(
                    (fid_b >= 0)[..., None], 0.0, grad_b)
        if not (need_fv or need_fa):
            return None, None, d_bg, None, None

        tops, bottoms = _exchange_halos(group, bands)
        setups = []
        with torch.enable_grad():
            for m in members:
                own = slice(m * f_local, (m + 1) * f_local)
                fv = face_verts[own].detach().requires_grad_(need_fv)
                fa = face_attrs[own].detach().requires_grad_(need_fa)
                setups.append((fv, fa, *setup_planes(fv, fa)[:2]))
        gathered = group.all_gather(
            [torch.cat([geo.detach(), att.detach()], dim=1)
             for _, _, geo, att in setups])
        rows = []
        for i, m in enumerate(members):
            extended = _exchange_halo_rows(*bands[i], tops[i], bottoms[i])
            own_mask = torch.zeros_like(extended[0], dtype=torch.bool)
            own_mask[1:-1].fill_(True)
            geo_band = gathered[i][:, :GEO_WIDTH].clone()
            geo_band[:, GEO_AY] -= m * band_h - 1
            d_geo, d_att, _ = raster_bwd.backward_torch(
                geo_band, gathered[i][:, GEO_WIDTH:], *extended,
                own_mask=own_mask)
            rows.append(torch.cat([d_geo, d_att], dim=1))
        owned = group.reduce_scatter(rows)

        d_fv = torch.zeros_like(face_verts) if need_fv else None
        d_fa = torch.zeros_like(face_attrs) if need_fa else None
        for (fv, fa, geo, att), m, row in zip(setups, members, owned):
            own = slice(m * f_local, (m + 1) * f_local)
            cots = ((geo, row[:, :GEO_WIDTH]), (att, row[:, GEO_WIDTH:]))
            cots = [(o, d) for o, d in cots if o.requires_grad]
            wanted = [x for x, need in ((fv, need_fv), (fa, need_fa)) if need]
            grads = iter(torch.autograd.grad([o for o, _ in cots], wanted,
                                             [d for _, d in cots]))
            if need_fv:
                d_fv[own] = next(grads)
            if need_fa:
                d_fa[own] = next(grads)
        return d_fv, d_fa, d_bg, None, None


def rasterise_face_sharded(background, vertices, vertex_colors, faces, group,
                           config: RasterConfig | None = None,
                           with_aux: bool = False):
    """Face-sharded equivalent of ``dirt_tpu_torch.rasterise`` (without the
    near-plane clip, as in ``dirt_tpu``).

    Args:
        background: [H, W, C], the full image's (equal on every process); H
            must be divisible by ``group.size``.
        vertices: [V, 4] clip space (replicated).
        vertex_colors: [V, C] (replicated).
        faces: [F, 3] integer vertex indices (replicated); F must be
            divisible by ``group.size`` (pad with degenerate faces upstream).
        group: the face group (``parallel.group``): member i renders faces
            ``[i F / n, (i + 1) F / n)`` and back-propagates row band i.
        with_aux: also return (fid, zbuf, overflow) of the held rows.
    Returns:
        The rows this process holds (``group.local`` bands, top to bottom:
        the whole [H, W, C] image for a ``LocalGroup``), equal to the
        single-device render; differentiable w.r.t. background (its
        gradient is nonzero on the held bands only), vertices and
        vertex_colors (summed over the group).
    """
    vertices, vertex_colors, faces = _as_inputs(vertices, vertex_colors,
                                                faces)
    background = torch.as_tensor(background, dtype=torch.float32,
                                 device=vertices.device)
    height, width, _ = background.shape
    config = (config or RasterConfig()).concrete(height)
    n = group.size
    num_faces = faces.shape[0]
    if num_faces % n:
        raise ValueError(f"faces ({num_faces}) must divide by {n}")
    if height % n:
        raise ValueError(f"height ({height}) must divide by {n}")
    vertices = group.replicated(vertices)
    vertex_colors = group.replicated(vertex_colors)
    out = _FaceShardOp.apply(
        screen_from_clip(vertices, height, width)[faces],
        vertex_colors[faces], background, config, group)
    held = list(group.local)
    if len(held) < n:
        bands = _split_rows(out[:3], n)
        out = (*(torch.cat([bands[m][k] for m in held]) for k in range(3)),
               out[3])
    return out if with_aux else out[0]
