"""Backward pass: exact interior gradients + occlusion-aware edge gradients.

Counterpart of the part of ``dirt_tpu/ops/raster_bwd.py`` that the
packed, dense and streaming engines' backwards need; see that module's
docstring for the semantics:

* interior: the gradient of ``num_plane / den_plane`` with respect to the
  plane coefficients at fixed coverage (exact; chained to the screen
  vertices and attributes through ``triangle_setup.setup_planes_vjp``);
* boundary: for each adjacent pixel pair with differing face ids, the
  frontmost face's crossing edge receives the intensity-difference x
  edge-motion term ``d(a, b, c0) += S * (x* - ax, y* - ay, 1) / (|a|+|b|)``;
  depth ties go to the lower face id (``boundary_cases``).

Anchor cotangents (``d_ax``, ``d_ay``) are derived per face after the
reduction, from ``c_global = c0 - a*ax - b*ay`` (``anchor_cotangents``).

:func:`backward_torch` is the reference's pure engine, per-pixel
cotangents reduced onto faces, and the in-package oracle that the packed
backward (``ops.packed_bwd``) and the dense one are tested against.
:func:`backward_fused` is the dense engine's backward (kernel
``csrc/fused_bwd.cu`` through ``ops.fused_bwd``) and
:func:`backward_fused_csr` the streaming engine's (``csrc/fused_bwd_csr.cu``).
:func:`backward_scatter` and :func:`backward_scatter_halo` are the scatter
engine: per-pixel cotangents over whole arrays (plain tensor ops, as in
``dirt_tpu``), packed by :func:`pack_cotangent_tiles` and reduced onto faces
by ``ops.scatter``'s kernels; the halo form is the row-sharded renderer's
(``parallel.sharding``).
"""

from __future__ import annotations

import torch

from dirt_tpu_torch.ops.raster_fwd import BIG_Z
from dirt_tpu_torch.ops.triangle_setup import (
    GEO_AX,
    GEO_AY,
    GEO_DEN,
    GEO_EDGE,
    GEO_WIDTH,
)

GEO_USED_END = GEO_DEN + 3  # == triangle_setup.GEO_USED

A_EPS = 1e-12


def _shift(arr, axis, offset, fill):
    """Shift ``arr`` by ``offset`` along ``axis`` filling vacated slots."""
    rolled = torch.roll(arr, -offset, dims=axis)
    idx = torch.arange(arr.shape[axis], device=arr.device)
    valid = (idx + offset >= 0) & (idx + offset <= arr.shape[axis] - 1)
    shape = [1] * arr.ndim
    shape[axis] = arr.shape[axis]
    valid = valid.reshape(shape)
    return torch.where(valid, rolled, fill)


def boundary_cases():
    """The four neighbor-pair orientations of the edge term.

    Each entry is (axis, offset, horizontal, strict): the OWN pixel is kept
    as the front pixel and ``offset`` points at the back pixel along
    ``axis``. Tie rule: for a horizontal pair the left pixel is front iff
    z_left < z_right (so own-front with the back pixel on the left requires
    z_own <= z_left); likewise vertically with top/down.
    """
    return [
        (1, +1, True, True),    # back = right neighbor: front iff z < z_r
        (1, -1, True, False),   # back = left:  front iff z <= z_l
        (0, +1, False, True),   # back = below: front iff z < z_d
        (0, -1, False, False),  # back = above: front iff z <= z_u
    ]


def neighbor_maps(fid, zbuf, pixels_cf, grad_cf):
    """Per-direction neighbor data for the boundary term.

    Returns a list over :func:`boundary_cases` of (nfid, nz, sval): the
    neighbor's face id / depth, and the pair's shared intensity gradient
    ``sval = 0.5 * sum_c (g + g_nbr)(p - p_nbr)``. Out-of-image neighbors
    get fid -2 / z BIG_Z / sval 0 (excluded pairs).
    """
    out = []
    for axis, offset, _, _ in boundary_cases():
        nfid = _shift(fid, axis, offset, -2)
        nz = _shift(zbuf, axis, offset, BIG_Z)
        npix = _shift(pixels_cf, axis + 1, offset, 0.0)
        ng = _shift(grad_cf, axis + 1, offset, 0.0)
        sval = 0.5 * torch.sum((grad_cf + ng) * (pixels_cf - npix), dim=0)
        out.append((nfid, nz, sval))
    return out


def pixel_grid(height: int, width: int, device):
    """[H, W] global pixel-center coordinates (x + 0.5, y + 0.5)."""
    col = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    row = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    return (col[None, :].expand(height, width),
            row[:, None].expand(height, width))


def pixel_cotangents(g16cf, covered, fid, zbuf, pixels_cf, grad_cf):
    """Per-pixel cotangent columns w.r.t. the owning face's planes.

    Args:
        g16cf: [>= 17, H, W] the owning face's geometry row per pixel.
        covered: [H, W] bool — pixels that own a face AND are owned by this
            shard (non-owned halo pixels only supply neighbor-side data).
        fid: [H, W] int32; zbuf: [H, W] f32.
        pixels_cf, grad_cf: [C, H, W] forward output / upstream cotangent.
    Returns:
        (d_geo_cols, d_att_cols): lists of [H, W] tensors — geometry plane
        columns 0..23 (anchor columns are zero; they are derived per face
        later) and attribute columns 0..3C-1.
    """
    height, width = fid.shape
    xg, yg = pixel_grid(height, width, fid.device)
    nbrs = neighbor_maps(fid, zbuf, pixels_cf, grad_cf)
    return pixel_cotangents_core(
        g16cf, covered, fid, zbuf, pixels_cf, grad_cf, nbrs, xg, yg
    )


def pixel_cotangents_core(g16cf, covered, fid_pair, zbuf, pixels_cf,
                          grad_cf, nbrs, xg, yg):
    """Shift-free cotangent engine (elementwise over any pixel shape).

    The CUDA kernel ``csrc/packed_bwd.cu`` evaluates the same expressions
    in the same order for one pixel.

    Args:
        g16cf: indexable per-plane maps (``g16cf[k]`` -> pixel shape);
            columns follow the geo layout of ``triangle_setup``.
        fid_pair: int32 face ids for the fid != nfid pair test (may be None
            when every nbrs entry is pre-combined).
        nbrs: list over :func:`boundary_cases` of either (nfid, nz, sval)
            from :func:`neighbor_maps`, or a pre-combined (active, sval)
            pair where ``active`` is the bool pair & front test already
            evaluated (the packed path's bit plane).
        xg, yg: global pixel-center coordinates.
    """
    shape = xg.shape
    channels = pixels_cf.shape[0]

    dxg = xg - g16cf[GEO_AX]
    dyg = yg - g16cf[GEO_AY]

    zero = torch.zeros(shape, dtype=torch.float32, device=xg.device)
    d_geo = [zero] * GEO_WIDTH
    d_att = []

    # ---- interior term -------------------------------------------------
    den = (
        g16cf[GEO_DEN] * dxg
        + g16cf[GEO_DEN + 1] * dyg
        + g16cf[GEO_DEN + 2]
    )
    recip = torch.where(covered, 1.0 / den, 0.0)
    s_acc = zero
    for c in range(channels):
        g_c = grad_cf[c]
        w_c = torch.where(covered, g_c * recip, 0.0)
        d_att += [w_c * dxg, w_c * dyg, w_c]
        # pixels_c == num_c * recip on covered pixels, so
        # t_den = -recip^2 * sum_c g_c * num_c = -recip * sum_c g_c * pixels_c.
        s_acc = s_acc + g_c * pixels_cf[c]
    t_den = torch.where(covered, -recip * s_acc, 0.0)
    d_geo[GEO_DEN] = t_den * dxg
    d_geo[GEO_DEN + 1] = t_den * dyg
    d_geo[GEO_DEN + 2] = t_den

    # ---- boundary term --------------------------------------------------
    a_e = [g16cf[GEO_EDGE + 3 * j] for j in range(3)]
    b_e = [g16cf[GEO_EDGE + 3 * j + 1] for j in range(3)]
    e_own = [
        a_e[j] * dxg + b_e[j] * dyg + g16cf[GEO_EDGE + 3 * j + 2]
        for j in range(3)
    ]

    acc_edge = [[zero, zero, zero] for _ in range(3)]  # [edge][a|b|c0]
    for case, (_, offset, horizontal, strict) in enumerate(boundary_cases()):
        if len(nbrs[case]) == 2:
            abit, s_val = nbrs[case]
            active = abit & covered
        else:
            nfid, nz, s_val = nbrs[case]
            pair = (fid_pair != nfid) & (nfid != -2) & covered
            front = (zbuf < nz) if strict else (zbuf <= nz)
            active = pair & front

        # Crossing-edge selection on the own (front) face's edges.
        chosen = torch.zeros(shape, dtype=torch.bool, device=xg.device)
        for j in range(3):
            a_j, b_j, e_j = a_e[j], b_e[j], e_own[j]
            # Edge function at the back pixel center (one pixel away).
            e_back = e_j + offset * (a_j if horizontal else b_j)
            crossing = (e_j >= 0.0) & (e_back < 0.0) & ~chosen
            chosen = chosen | crossing

            denom = torch.abs(a_j) + torch.abs(b_j)
            d_own = dxg if horizontal else dyg
            slope = a_j if horizontal else b_j
            guard = torch.abs(slope) >= A_EPS
            safe = torch.where(guard, slope, 1.0)
            # Crossing coordinate in anchored form: x* - ax = dx - e/a.
            coord = d_own - e_j / safe
            d_back = d_own + offset
            lo = torch.minimum(d_own, d_back)
            hi = torch.maximum(d_own, d_back)
            cross = torch.minimum(torch.maximum(coord, lo), hi)
            vec = (cross, dyg) if horizontal else (dxg, cross)

            scale = torch.where(
                active & crossing & guard & (denom >= A_EPS),
                s_val / torch.clamp(denom, min=A_EPS),
                0.0,
            )
            acc_edge[j][0] = acc_edge[j][0] + scale * vec[0]
            acc_edge[j][1] = acc_edge[j][1] + scale * vec[1]
            acc_edge[j][2] = acc_edge[j][2] + scale

    for j in range(3):
        for k in range(3):
            d_geo[GEO_EDGE + 3 * j + k] = acc_edge[j][k]

    return d_geo, d_att


# The five geometry planes (three edges, z, denominator) are consecutive
# (a, b, c0) column triples, GEO_EDGE to GEO_USED_END: a strided slice
# takes one coefficient of all five with no index tensor to copy to the
# card, a copy that a CUDA-graph capture refuses.
_PLANES = slice(GEO_EDGE, GEO_USED_END)


def anchor_cotangents(geo, att, d_geo, d_att):
    """Fill the (ax, ay) columns of per-face d_geo from the plane slopes.

    Every plane depends on the anchor only through
    ``c_global = c0 - a*ax - b*ay``, so d_ax = -sum_p a_p * d_c0_p (resp. b
    for ay) over all planes p of the face: the five geometry planes and
    the C attribute numerator planes.
    """
    planes = geo[:, _PLANES]
    d_c0 = d_geo[:, _PLANES][:, 2::3]
    d_ax = -torch.sum(planes[:, 0::3] * d_c0, dim=1)
    d_ay = -torch.sum(planes[:, 1::3] * d_c0, dim=1)
    d_ax = d_ax - torch.sum(att[:, 0::3] * d_att[:, 2::3], dim=1)
    d_ay = d_ay - torch.sum(att[:, 1::3] * d_att[:, 2::3], dim=1)
    out = d_geo.clone()
    out[:, GEO_AX] = d_ax
    out[:, GEO_AY] = d_ay
    return out


def assemble_face_gradients(geo, att, rows, channels: int):
    """Unpack reduced per-face rows into (d_geo, d_att) with anchors.

    ``rows`` columns: 9 edge, 3 denominator, 3C attribute.
    """
    num_faces = geo.shape[0]
    d_geo = torch.zeros((num_faces, GEO_WIDTH), dtype=torch.float32,
                        device=geo.device)
    d_geo[:, GEO_EDGE:GEO_EDGE + 9] = rows[:, 0:9]
    d_geo[:, GEO_DEN:GEO_USED_END] = rows[:, 9:12]
    d_att = rows[:, 12:12 + 3 * channels]
    return anchor_cotangents(geo, att, d_geo, d_att), d_att


def pack_cotangent_tiles(d_geo_cols, d_att_cols, covered, fid,
                         tile_h: int, tile_w: int):
    """Stack the scatterable cotangent columns and pad to whole tiles.

    Column order (the contract with the scatter kernels and
    :func:`assemble_face_gradients`): 9 edge, 3 denominator, 3C attribute.
    Returns (cot [K, Hp, Wp] f32, zero off ``covered``; fid_p [Hp, Wp] int32,
    -1 off ``covered`` and on the padding), both contiguous.
    """
    height, width = fid.shape
    cot = torch.stack(
        [d_geo_cols[GEO_EDGE + k] for k in range(9)]
        + [d_geo_cols[GEO_DEN + k] for k in range(3)]
        + list(d_att_cols), dim=0
    )
    cot = torch.where(covered[None], cot, 0.0)
    hp = -(-height // tile_h) * tile_h
    wp = -(-width // tile_w) * tile_w
    pad2 = (0, wp - width, 0, hp - height)
    pad = torch.nn.functional.pad
    fid_p = pad(torch.where(covered, fid, -1).to(torch.int32), pad2,
                value=-1)
    return pad(cot, pad2).contiguous(), fid_p.contiguous()


def backward_scatter(geo, att, fid, zbuf, pixels, grad_pixels, scatter_fn,
                     tile_h: int, tile_w: int, own_mask=None):
    """Gradients w.r.t. plane coefficients via a per-face scatter kernel.

    Same semantics and returns as :func:`backward_torch`, but the reduction
    of the per-pixel cotangents onto faces is ``scatter_fn``'s.

    Args:
        scatter_fn: callable (cot [K, Hp, Wp], fid [Hp, Wp]) -> [F, K]
            summing each pixel's cotangent row onto its owning face
            (``raster.make_scatter_fn`` over the forward's bins).
    """
    geo = torch.as_tensor(geo, dtype=torch.float32)
    att = torch.as_tensor(att, dtype=torch.float32)
    covered = fid >= 0
    if own_mask is not None:
        covered = covered & own_mask
    safe_fid = torch.where(covered, fid, 0).long()
    d_geo_cols, d_att_cols = pixel_cotangents(
        geo[safe_fid].permute(2, 0, 1), covered, fid, zbuf,
        pixels.permute(2, 0, 1), grad_pixels.permute(2, 0, 1)
    )
    cot, fid_p = pack_cotangent_tiles(d_geo_cols, d_att_cols, covered, fid,
                                      tile_h, tile_w)
    rows = scatter_fn(cot, fid_p)                        # [F, 12 + 3C]
    d_geo, d_att = assemble_face_gradients(geo, att, rows, pixels.shape[-1])
    d_background = torch.where(covered[..., None], 0.0, grad_pixels)
    return d_geo, d_att, d_background


def backward_scatter_halo(geo, att, fid_e, zbuf_e, pixels_e, grad_e,
                          own_mask, scatter_fn, tile_h: int, tile_w: int):
    """Scatter-engine backward over row-halo-extended slab arrays.

    For the row-sharded renderer (``parallel.sharding``): the inputs carry
    one halo row on each side ([H + 2, W, ...]). The per-pixel cotangents
    are computed on the extended arrays, so a boundary pair that crosses
    the slab's edge sees the neighbour's row, and are then cut back to the
    slab's own rows before the per-face scatter; ``own_mask`` is False on
    the halo rows, which therefore own nothing. ``geo`` / ``att`` must be
    expressed in the extended (y + 1) coordinates; ``scatter_fn`` takes the
    slab's own rows. Returns (d_geo, d_att, d_background_e [H + 2, W, C]).
    """
    geo = torch.as_tensor(geo, dtype=torch.float32)
    att = torch.as_tensor(att, dtype=torch.float32)
    covered_e = (fid_e >= 0) & own_mask
    safe_fid = torch.where(covered_e, fid_e, 0).long()
    d_geo_cols, d_att_cols = pixel_cotangents(
        geo[safe_fid].permute(2, 0, 1), covered_e, fid_e, zbuf_e,
        pixels_e.permute(2, 0, 1), grad_e.permute(2, 0, 1)
    )
    cot, fid_p = pack_cotangent_tiles(
        [c[1:-1] for c in d_geo_cols], [c[1:-1] for c in d_att_cols],
        covered_e[1:-1], fid_e[1:-1], tile_h, tile_w
    )
    rows = scatter_fn(cot, fid_p)
    d_geo, d_att = assemble_face_gradients(geo, att, rows,
                                           pixels_e.shape[-1])
    d_background_e = torch.where(covered_e[..., None], 0.0, grad_e)
    return d_geo, d_att, d_background_e


def sum_onto_faces(d_geo_cols, d_att_cols, fid, covered, num_faces: int):
    """Per-pixel cotangent columns summed onto the owning faces, without
    the anchor columns: (d_geo [F, 24], d_att [F, 3C]).

    One float32 ``index_add_`` per column group over the ``covered``
    pixels, where ``dirt_tpu`` uses ``segment_sum`` (on CUDA tensors the
    adds are atomic, so the sums' order is not fixed).
    """
    device = d_att_cols[0].device
    seg = torch.clamp(fid, min=0).long().reshape(-1)
    weight = covered.reshape(-1, 1).to(torch.float32)
    sums = []
    for cols in (d_geo_cols, d_att_cols):
        per_pixel = torch.stack(cols, dim=0).reshape(len(cols), -1).T
        out = torch.zeros((num_faces, len(cols)), dtype=torch.float32,
                          device=device)
        sums.append(out.index_add_(0, seg, per_pixel * weight))
    return tuple(sums)


def backward_torch(geo, att, fid, zbuf, pixels, grad_pixels, own_mask=None):
    """Gradients w.r.t. plane coefficients: the reference's pure engine.

    Counterpart of ``dirt_tpu.ops.raster_bwd.backward_jax``: per-pixel
    cotangents over the whole image (:func:`pixel_cotangents`), then one
    ``index_add_`` per column group onto the owning faces where JAX uses
    ``segment_sum``. It shares no code with the packed path below the
    cotangent core, which makes it the packed backward's oracle.

    Args:
        geo: [F, 24] anchored plane data from ``setup_planes``.
        att: [F, 3*C].
        fid: [H, W] int32 face-id map (-1 background) from the forward.
        zbuf: [H, W] f32 (BIG_Z at background).
        pixels: [H, W, C] forward output.
        grad_pixels: [H, W, C] upstream cotangent.
        own_mask: optional [H, W] bool — pixels this shard OWNS. Non-owned
            (halo) rows supply neighbor-side data for boundary pairs but
            never act as the front/interior pixel.
    Returns:
        (d_geo [F, 24], d_att [F, 3*C], d_background [H, W, C]).
    """
    geo = torch.as_tensor(geo, dtype=torch.float32)
    att = torch.as_tensor(att, dtype=torch.float32)
    num_faces = geo.shape[0]

    covered = fid >= 0
    if own_mask is not None:
        covered = covered & own_mask
    safe_fid = torch.clamp(fid, min=0).long()
    g16cf = geo[safe_fid].permute(2, 0, 1)               # [24, H, W]
    pixels_cf = pixels.permute(2, 0, 1)                  # [C, H, W]
    grad_cf = grad_pixels.permute(2, 0, 1)

    d_geo_cols, d_att_cols = pixel_cotangents(
        g16cf, covered, fid, zbuf, pixels_cf, grad_cf
    )
    d_geo, d_att = sum_onto_faces(d_geo_cols, d_att_cols, fid, covered,
                                  num_faces)
    d_geo = anchor_cotangents(geo, att, d_geo, d_att)
    d_background = torch.where(covered[..., None], 0.0, grad_pixels)
    return d_geo, d_att, d_background


def backward_fused(geo, att, fid, zbuf, pixels, grad_pixels, bins, counts,
                   tile_h: int, tile_w: int, bbox=None, cull=None):
    """Dense-path backward: neighbor prologue + the fused kernel.

    Same semantics and returns as :func:`backward_torch`. The image-space
    fields are padded to whole tiles by the prologue kernel
    (``packed_bwd.padded_prologue``, which also writes the boundary-pair
    bits and ``sval``), and
    ``fused_bwd.fused_backward_rows`` sums the per-pixel cotangents onto
    the owning faces. ``bins`` / ``counts`` are the forward's
    (``binning.bin_faces``), at any cap; ``bbox`` [F, 4] are the boxes they
    were made from and ``cull`` [Fp, 4] the forward's cull boxes
    (``raster.DenseBins.cull``), which the kernel needs on CUDA tensors
    (see ``fused_bwd``).
    """
    from dirt_tpu_torch.ops.fused_bwd import fused_backward_rows
    from dirt_tpu_torch.ops.packed_bwd import padded_prologue

    geo = torch.as_tensor(geo, dtype=torch.float32)
    att = torch.as_tensor(att, dtype=torch.float32)
    num_faces = geo.shape[0]
    fid_p, bits, sval, pix_cf, grad_cf = padded_prologue(
        fid, zbuf, pixels, grad_pixels, tile_h, tile_w)
    rows = fused_backward_rows(
        geo.contiguous(), bins, counts, fid_p, bits, sval, pix_cf, grad_cf,
        num_faces + 1, tile_h=tile_h, tile_w=tile_w, bbox=bbox, cull=cull,
    )[:num_faces]
    d_geo, d_att = assemble_face_gradients(geo, att, rows, pixels.shape[-1])
    d_background = torch.where((fid >= 0)[..., None], 0.0, grad_pixels)
    return d_geo, d_att, d_background


def backward_fused_csr(geo, att, fid, zbuf, pixels, grad_pixels, entry_face,
                       start_block, counts, tile_h: int, tile_w: int,
                       bbox=None, cull=None):
    """Streaming-path backward: neighbor prologue + the fused CSR kernel.

    :func:`backward_fused` over the forward's CSR bins
    (``binning.bin_faces_csr``) through
    ``fused_bwd.fused_backward_rows_csr``. ``dirt_tpu``'s function also
    takes the face count and a static chunk bound; here the first is
    ``geo``'s and the kernel needs no second.
    """
    from dirt_tpu_torch.ops.fused_bwd import fused_backward_rows_csr
    from dirt_tpu_torch.ops.packed_bwd import padded_prologue

    geo = torch.as_tensor(geo, dtype=torch.float32)
    att = torch.as_tensor(att, dtype=torch.float32)
    fid_p, bits, sval, pix_cf, grad_cf = padded_prologue(
        fid, zbuf, pixels, grad_pixels, tile_h, tile_w)
    rows = fused_backward_rows_csr(
        geo.contiguous(), entry_face, start_block, counts, fid_p, bits, sval,
        pix_cf, grad_cf, geo.shape[0], tile_h=tile_h, tile_w=tile_w,
        bbox=bbox, cull=cull,
    )
    d_geo, d_att = assemble_face_gradients(geo, att, rows, pixels.shape[-1])
    d_background = torch.where((fid >= 0)[..., None], 0.0, grad_pixels)
    return d_geo, d_att, d_background
