"""Row-sharded rendering: the image's rows split into slabs over a group.

Counterpart of ``dirt_tpu/parallel/sharding.py``:

* The image's row axis is split into ``group.size`` horizontal slabs
  (``parallel.group``). Each slab is rasterized by the ordinary
  single-device forward; vertices, faces and attributes are replicated (they
  are tiny next to pixel buffers).
* Geometry is shifted, not re-projected, per slab: subtracting the slab's
  first row from screen-space y renders global rows in local coordinates and
  leaves gradients untouched (a translation has unit Jacobian).
* Backward: boundary (silhouette) gradients need one halo row from each
  neighbouring slab. An adjacent-pixel pair that crosses a slab boundary is
  computed by the slab that owns the pair's front pixel, on the neighbour's
  row of (fid, zbuf, pixels, upstream gradient), which the group supplies.
  The packed engine splices the rows into its neighbour maps
  (``packed_bwd.prepare_backward_packed(nbrs=...)``); the dense and the
  streaming engine compute the per-pixel cotangents on the extended arrays
  and reduce them onto faces with the scatter kernels
  (``raster_bwd.backward_scatter_halo``, ``ops.scatter``).
* Gradients of the replicated inputs are summed over the group
  (``group.replicated``), the counterpart of ``shard_map``'s transpose.

``rasterise_sharded(overlap_chunks=N)`` runs ``parallel.overlap``'s op
instead, which reuses this module's per-slab forward and halo exchange.
"""

from __future__ import annotations

import torch

from dirt_tpu_torch.ops import binning, packed_bwd, raster, raster_bwd
from dirt_tpu_torch.ops.raster import DenseBins, RasterConfig, StreamBins
from dirt_tpu_torch.ops.raster_fwd import BIG_Z
from dirt_tpu_torch.ops.triangle_setup import screen_from_clip
from dirt_tpu_torch.rasterise_ops import _as_inputs

_pad = torch.nn.functional.pad


def _pack_row(fid, zbuf, pixels, grad_pixels, row: int):
    """One row of the four fields as a single int32 buffer [W, 2 + 2C] (the
    floats' bits), so a halo travels as one message."""
    return torch.cat([
        fid[row, :, None],
        zbuf[row, :, None].view(torch.int32),
        pixels[row].contiguous().view(torch.int32),
        grad_pixels[row].contiguous().view(torch.int32),
    ], dim=1)


def _shift_rows(face_verts, rows: int):
    """Screen-space faces moved ``rows`` rows up: global rows in the
    coordinates of a slab whose first row is ``rows``."""
    return raster.move_rows(face_verts, -float(rows))


def _split_rows(arrays, parts: int):
    """Each of ``parts`` equal row blocks of every array: [(a0, b0, ...),
    (a1, b1, ...), ...]."""
    height = arrays[0].shape[0] // parts
    return [tuple(a[i * height:(i + 1) * height] for a in arrays)
            for i in range(parts)]


def _exchange_halos(group, fields):
    """The halo rows of each held slab or band from the group: (tops,
    bottoms) of packed rows (:func:`_pack_row`). ``fields`` holds each
    one's (fid, zbuf, pixels, grad_pixels)."""
    return group.exchange_rows(
        [_pack_row(*f, 0) for f in fields],
        [_pack_row(*f, f[0].shape[0] - 1) for f in fields])


def _exchange_halo_rows(fid, zbuf, pixels, grad_pixels, top, bottom):
    """The slab's arrays with one halo row prepended and appended:
    [H + 2, W, ...]. ``top`` / ``bottom`` are the neighbours' packed rows
    (:func:`_pack_row`); None marks an end of the image, which gets a
    sentinel halo (fid -2, z BIG_Z, pixels and gradient 0)."""
    channels = pixels.shape[-1]

    def halo(packed):
        if packed is None:
            row = fid.new_full((1, fid.shape[1]), -2)
            return (row, zbuf.new_full(row.shape, BIG_Z),
                    pixels.new_zeros((1, *pixels.shape[1:])),
                    pixels.new_zeros((1, *pixels.shape[1:])))
        floats = packed[:, 1:].contiguous().view(torch.float32)
        return (packed[None, :, 0], floats[None, :, 0],
                floats[None, :, 1:1 + channels],
                floats[None, :, 1 + channels:])

    return tuple(
        torch.cat([above, own, below])
        for above, own, below in zip(halo(top),
                                     (fid, zbuf, pixels, grad_pixels),
                                     halo(bottom))
    )


def _halo_neighbor_stacks(fid_e, zbuf_e, pixels_e, grad_e, hp: int, wp: int):
    """Boundary-pair neighbour stacks [4, hp, wp] with the halo rows spliced
    in: (nfid4, nz4, sval4).

    ``raster_bwd.neighbor_maps`` on the extended arrays, cut back to the
    slab's own rows: the vertical neighbour data of the slab's first and
    last rows comes from the adjacent slabs, so every cross-slab boundary
    pair is evaluated, exactly once, by the slab that owns the pair's front
    pixel. Width and height are padded to the tile multiples with
    excluded-pair sentinels, as ``prepare_backward_packed`` pads its fields.
    """
    height, width = fid_e.shape[0] - 2, fid_e.shape[1]
    padw = (0, wp - width)
    nbrs = raster_bwd.neighbor_maps(
        _pad(fid_e, padw, value=-2), _pad(zbuf_e, padw, value=BIG_Z),
        _pad(pixels_e.permute(2, 0, 1), padw),
        _pad(grad_e.permute(2, 0, 1), padw),
    )
    padh = (0, 0, 0, hp - height)
    return tuple(
        _pad(torch.stack([n[k][1:-1] for n in nbrs]), padh, value=fill)
        for k, fill in enumerate((-2, BIG_Z, 0.0))
    )


def _slab_forwards(face_verts, face_attrs, bg_rows, config, slabs):
    """The single-device forward of each held slab, on the faces shifted
    into its rows: (pixels, fid, zbuf of the held rows, top to bottom;
    overflow []; the slabs' bins)."""
    slab_h = bg_rows.shape[0] // len(slabs)
    outs = [raster._forward_impl(
        _shift_rows(face_verts, slab * slab_h), face_attrs,
        bg_rows[i * slab_h:(i + 1) * slab_h], config)[:4]
        for i, slab in enumerate(slabs)]
    pixels, fid, zbuf = (torch.cat([o[k] for o in outs]) for k in range(3))
    overflow = torch.stack([torch.any(o[3].overflow) for o in outs]).any()
    return pixels, fid, zbuf, overflow, [o[3] for o in outs]


def _held_rows(background, held, slab_h: int):
    """The background rows of the slabs ``held``, top to bottom."""
    return torch.cat([background[s * slab_h:(s + 1) * slab_h] for s in held])


def _slab_backward(config, fv_local, fa, pixels, fid, zbuf, bins,
                   grad_pixels, top, bottom, need_fv: bool, need_fa: bool):
    """(d_face_verts, d_face_attrs, d_background) of one slab.

    ``fid`` / ``zbuf`` come with the rows past the image height already
    taken out of the pair graph; ``top`` / ``bottom`` are the neighbours'
    packed halo rows.
    """
    num_faces = fv_local.shape[0]
    slab_h, width = fid.shape
    tile_h, tile_w = config.tile_h, config.tile_w
    extended = _exchange_halo_rows(fid, zbuf, pixels, grad_pixels, top,
                                   bottom)
    if not isinstance(bins, (DenseBins, StreamBins)):
        # Packed engine: the fused backward takes the forward's PackedBins
        # as they are; only the boundary-pair neighbour maps need the halo
        # splice, and the geometry stays slab-local.
        hp = -(-slab_h // tile_h) * tile_h
        wp = -(-width // tile_w) * tile_w
        nbrs = _halo_neighbor_stacks(*extended, hp, wp)
        expand, _ = raster._packed_caps(config, num_faces, hp, wp)

        def plane_cotangents(geo, att):
            return packed_bwd.backward_packed(
                geo, att, fid, zbuf, pixels, grad_pixels, bins, num_faces,
                tile_h, tile_w, nbrs=nbrs,
                bmax=-(-expand // binning.POOL_ALIGN))

        return raster.chain_through_setup(fv_local, fa, need_fv, need_fa,
                                          plane_cotangents)

    fid_e = extended[0]
    own_mask = torch.zeros_like(fid_e, dtype=torch.bool)
    own_mask[1:-1].fill_(True)
    scatter_fn = raster.make_scatter_fn(config, bins, num_faces)

    def plane_cotangents(geo_shift, att_shift):
        return raster_bwd.backward_scatter_halo(
            geo_shift, att_shift, *extended, own_mask, scatter_fn, tile_h,
            tile_w)

    # Extended-array row i is slab-local row i - 1 (the halo is row 0), so
    # the planes are set up one row further down; the +1 translation has
    # unit Jacobian and chains to the local vertices exactly.
    d_fv, d_fa, d_bg_e = raster.chain_through_setup(
        fv_local, fa, need_fv, need_fa, plane_cotangents, row_shift=1.0)
    return d_fv, d_fa, d_bg_e[1:-1]


class _SlabOp(torch.autograd.Function):
    """The slab rasterizer with halo-exchanged boundary gradients, over the
    slabs this process holds.

    Takes global screen-space faces and the local slabs' background rows
    (concatenated); each slab's forward is the single-device path on the
    faces shifted into its rows. The backward extends every slab by the
    halo rows the group supplies before the boundary-gradient pass.
    """

    @staticmethod
    def forward(ctx, face_verts, face_attrs, bg_rows, config, group,
                total_height):
        slabs = list(group.local)
        slab_h = bg_rows.shape[0] // len(slabs)
        pixels, fid, zbuf, overflow, ctx.bins = _slab_forwards(
            face_verts, face_attrs, bg_rows, config, slabs)
        ctx.mark_non_differentiable(fid, zbuf, overflow)
        ctx.save_for_backward(face_verts.detach(), face_attrs.detach(),
                              pixels, fid, zbuf)
        ctx.static = (config, group, total_height, slabs, slab_h)
        return pixels, fid, zbuf, overflow

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_pixels, *_):
        face_verts, face_attrs, pixels, fid, zbuf = ctx.saved_tensors
        config, group, total_height, slabs, slab_h = ctx.static
        need_fv, need_fa, need_bg = ctx.needs_input_grad[:3]
        grad_pixels = grad_pixels.to(torch.float32)

        # Rows past the true image height are padding: take them out of
        # the pair graph (the single-device crop semantics).
        rows = torch.cat([torch.arange(s * slab_h, (s + 1) * slab_h,
                                       device=fid.device) for s in slabs])
        in_image = (rows < total_height)[:, None]
        fid = torch.where(in_image, fid, -2)
        zbuf = torch.where(in_image, zbuf, BIG_Z)
        if not (need_fv or need_fa):
            d_bg = torch.where((fid >= 0)[..., None], 0.0, grad_pixels)
            return None, None, d_bg if need_bg else None, None, None, None

        fields = _split_rows((fid, zbuf, pixels, grad_pixels), len(slabs))
        tops, bottoms = _exchange_halos(group, fields)
        d_fv = d_fa = None
        d_bg = []
        for i, slab in enumerate(slabs):
            fid_i, zbuf_i, pixels_i, grad_i = fields[i]
            g_fv, g_fa, g_bg = _slab_backward(
                config, _shift_rows(face_verts, slab * slab_h), face_attrs,
                pixels_i, fid_i, zbuf_i,
                ctx.bins[i], grad_i, tops[i], bottoms[i], need_fv, need_fa)
            if need_fv:
                d_fv = g_fv if d_fv is None else d_fv + g_fv
            if need_fa:
                d_fa = g_fa if d_fa is None else d_fa + g_fa
            d_bg.append(g_bg)
        return (d_fv, d_fa, torch.cat(d_bg) if need_bg else None, None,
                None, None)


def slab_render(bg_slab, vertices, vertex_colors, faces, height: int,
                width: int, group, config: RasterConfig | None = None,
                with_aux: bool = False):
    """Render the image slabs this process holds.

    Args:
        bg_slab: [len(group.local) * slab_h, W, C] the background rows of
            the slabs this process holds, top to bottom: one slab for a
            ``DistGroup`` rank, all ``group.size`` of a ``LocalGroup``.
        vertices / vertex_colors: replicated [V, 4] / [V, C].
        faces: [F, 3] integer vertex indices.
        height, width: FULL image dimensions; slabs may reach past
            ``height`` (their rows there are padding).
        group: the row group (``parallel.group``).
        with_aux: also return (fid, zbuf, overflow) of the held rows.
    Returns:
        [len(group.local) * slab_h, W, C] the rendered rows, differentiable;
        boundary gradients are halo-exchanged over ``group`` and the
        gradients of ``vertices`` and ``vertex_colors`` summed over it.
    """
    vertices, vertex_colors, faces = _as_inputs(vertices, vertex_colors,
                                                faces)
    bg_slab = torch.as_tensor(bg_slab, dtype=torch.float32,
                              device=vertices.device)
    held = len(group.local)
    if bg_slab.shape[0] % held:
        raise ValueError(f"{bg_slab.shape[0]} background rows do not split "
                         f"into the {held} slabs this process holds")
    config = (config or RasterConfig()).concrete(bg_slab.shape[0] // held)
    vertices = group.replicated(vertices)
    vertex_colors = group.replicated(vertex_colors)
    verts_screen = screen_from_clip(vertices, height, width)
    pixels, fid, zbuf, overflow = _SlabOp.apply(
        verts_screen[faces], vertex_colors[faces], bg_slab, config, group,
        height)
    return (pixels, fid, zbuf, overflow) if with_aux else pixels


def rasterise_sharded(background, vertices, vertex_colors, faces, group,
                      config: RasterConfig | None = None,
                      overlap_chunks: int | None = None,
                      with_aux: bool = False):
    """Row-sharded equivalent of ``dirt_tpu_torch.rasterise`` (without the
    near-plane clip, as in ``dirt_tpu``).

    Args:
        background: [H, W, C], the full image's (equal on every process); H
            must be divisible by ``group.size * config.tile_h`` (pad
            upstream if not).
        vertices: [V, 4] clip space (replicated).
        vertex_colors: [V, C] (replicated).
        faces: [F, 3] integer vertex indices (replicated).
        group: the row group: a ``parallel.group.LocalGroup`` (all slabs in
            this process) or ``DistGroup`` (one slab per rank; for two-level
            layouts the flattened host-major group of
            ``parallel.multihost.make_render_mesh``).
        overlap_chunks: if given, the backward runs in that many chunks
            whose parameter gradients are summed over the group one by one
            (``parallel.overlap.rasterise_overlapped``; packed engine only).
        with_aux: also return (fid, zbuf, overflow) of the held rows.
    Returns:
        The rendered rows this process holds (``group.local`` slabs, top to
        bottom: the whole [H, W, C] image for a ``LocalGroup``),
        differentiable w.r.t. background (its gradient is nonzero on the
        held rows only), vertices and vertex_colors (summed over the group).
    """
    if overlap_chunks is not None:
        from dirt_tpu_torch.parallel.overlap import rasterise_overlapped

        return rasterise_overlapped(background, vertices, vertex_colors,
                                    faces, group, config, overlap_chunks,
                                    with_aux=with_aux)
    background = torch.as_tensor(background, dtype=torch.float32)
    height, width, _ = background.shape
    n = group.size
    config = (config or RasterConfig()).concrete(height // n)
    if height % (n * config.tile_h) != 0:
        raise ValueError(
            f"height {height} must be divisible by devices*tile_h "
            f"({n}*{config.tile_h})"
        )
    slab_h = height // n
    held = list(group.local)
    bg_rows = background if len(held) == n else _held_rows(background, held,
                                                           slab_h)
    return slab_render(bg_rows, vertices, vertex_colors, faces, height,
                       width, group, config, with_aux=with_aux)
