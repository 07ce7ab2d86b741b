"""Differentiable triangle setup: screen transform and plane coefficients.

Counterpart of ``dirt_tpu/ops/triangle_setup.py``; see its docstring for
the anchored plane form and why it keeps f32 precision at 1024^2. Setup
is plain differentiable PyTorch, so the raster op's backward only needs
gradients with respect to these coefficients.

Geometry layout of the ``geo`` array ([F, 24] f32):

    0, 1    ax, ay (vertex-0 screen position — the anchor)
    2:11    a_j, b_j, c0_j for oriented edges j = 0, 1, 2
            (edge j opposite vertex j; E_j >= 0 inside for valid faces)
    11:14   z plane (OpenGL rule: z_ndc linear in screen space)
    14:17   denominator plane (sum_k b_k / w_k)
    17:24   unused (padding)

Attribute numerators are packed [F, 3*C]: channel c holds (na, nb, nc0) at
3c:3c+3 with ``nc0 = attr_0c / w_0``.

Every expression keeps the JAX package's operation order, so the two agree
to the last bit wherever neither compiler fuses a multiply into an add.
"""

from __future__ import annotations

import torch

AREA_EPS = 1e-10
W_EPS = 1e-9

GEO_WIDTH = 24
# Field offsets within a geo row.
GEO_AX, GEO_AY = 0, 1
GEO_EDGE = 2          # 9 values: (a, b, c0) x 3 edges
GEO_Z = 11            # 3 values
GEO_DEN = 14          # 3 values
GEO_USED = 17         # columns 17:24 are padding; the kernels pack
                      # attribute planes right after column GEO_USED


def screen_from_clip(vertices_clip, height: int, width: int):
    """Clip space [..., 4] -> screen space (x_s, y_s, z_ndc, invw).

    ``x_s = (x_ndc + 1)/2 * W``; ``y_s = (1 - y_ndc)/2 * H`` (row 0 = top);
    pixel (i, j) center is (j + 0.5, i + 0.5). Vertices with w <= W_EPS get
    invw <= 0, which marks their faces invalid in ``setup_planes``.
    """
    v = torch.as_tensor(vertices_clip, dtype=torch.float32)
    w = v[..., 3]
    ok = torch.abs(w) > W_EPS
    safe_w = torch.where(ok, w, 1.0)
    invw = torch.where(ok, 1.0 / safe_w, 0.0)
    x_ndc = v[..., 0] * invw
    y_ndc = v[..., 1] * invw
    z_ndc = v[..., 2] * invw
    x_s = (x_ndc + 1.0) * 0.5 * width
    y_s = (1.0 - y_ndc) * 0.5 * height
    return torch.stack([x_s, y_s, z_ndc, invw], dim=-1)


def _corners(fv):
    """Per-corner [F] columns (xs, ys, zs, ws) of [F, 3, 4] screen verts."""
    cols = fv.reshape(fv.shape[0], 12).T                    # [12, F]
    xs = (cols[0], cols[4], cols[8])
    ys = (cols[1], cols[5], cols[9])
    zs = (cols[2], cols[6], cols[10])
    ws = (cols[3], cols[7], cols[11])
    return xs, ys, zs, ws


def _oriented_edges(xs, ys, ws):
    """(valid, orient, area2, a_e, b_e) shared by setup and the filter."""
    x0, x1, x2 = xs
    y0, y1, y2 = ys
    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    orient = torch.where(area2 >= 0.0, 1.0, -1.0)
    valid = (torch.abs(area2) > AREA_EPS) & (ws[0] > 0.0) & (ws[1] > 0.0) \
        & (ws[2] > 0.0)
    # Edge j from vertex (j+1)%3 to (j+2)%3 (opposite vertex j); invalid
    # faces get edges that exclude every pixel.
    a_e = [
        torch.where(valid, orient * (ys[(j + 1) % 3] - ys[(j + 2) % 3]), 0.0)
        for j in range(3)
    ]
    b_e = [
        torch.where(valid, orient * (xs[(j + 2) % 3] - xs[(j + 1) % 3]), 0.0)
        for j in range(3)
    ]
    return valid, orient, area2, a_e, b_e


def setup_planes(face_verts_screen, face_attrs):
    """Per-face anchored plane coefficients for the raster kernels.

    Args:
        face_verts_screen: [F, 3, 4] (x_s, y_s, z_ndc, invw).
        face_attrs: [F, 3, C].
    Returns:
        geo [F, 24] f32, att [F, 3*C] f32, valid [F] bool.
    Differentiable with respect to both array inputs (orientation and
    validity are piecewise constant, as in the reference's semantics).
    """
    fv = torch.as_tensor(face_verts_screen, dtype=torch.float32)
    fa = torch.as_tensor(face_attrs, dtype=torch.float32)
    num_faces = fv.shape[0]
    channels = fa.shape[-1]
    xs, ys, zs, ws = _corners(fv)
    valid, orient, area2, a_e, b_e = _oriented_edges(xs, ys, ws)
    zero = torch.zeros((num_faces,), dtype=torch.float32, device=fv.device)

    abs_area = orient * area2  # == |area2|, differentiable through area2
    # Edge values at the anchor (vertex 0): edge 0 evaluates to 2*|area|,
    # edges 1 and 2 pass through vertex 0 (exactly zero).
    c_e = [
        torch.where(valid, abs_area, -1.0),
        torch.where(valid, 0.0, -1.0),
        torch.where(valid, 0.0, -1.0),
    ]
    inv_area = torch.where(
        valid, 1.0 / torch.where(valid, abs_area, 1.0), 0.0
    )

    # Barycentric slope planes b_k = E_k / |area2|; affine combinations
    # give the z / denominator / numerator slopes. Anchor values come
    # directly from vertex 0 (exact), not from the combination.
    def combine_slopes(w3):
        wa = (w3[0] * a_e[0] + w3[1] * a_e[1] + w3[2] * a_e[2]) * inv_area
        wb = (w3[0] * b_e[0] + w3[1] * b_e[1] + w3[2] * b_e[2]) * inv_area
        return wa, wb

    za, zb = combine_slopes(zs)
    zc = torch.where(valid, zs[0], 0.0)
    da, db = combine_slopes(ws)
    dc = torch.where(valid, ws[0], 1.0)

    geo_cols = [
        torch.where(valid, xs[0], 0.0),       # GEO_AX
        torch.where(valid, ys[0], 0.0),       # GEO_AY
        a_e[0], b_e[0], c_e[0],               # edge 0
        a_e[1], b_e[1], c_e[1],               # edge 1
        a_e[2], b_e[2], c_e[2],               # edge 2
        za, zb, zc,                           # GEO_Z
        da, db, dc,                           # GEO_DEN
    ]
    geo = torch.stack(geo_cols + [zero] * (GEO_WIDTH - GEO_USED), dim=1)

    # Attribute planes: corner k of channel c sits at row k*C + c of the
    # transposed [3C, F] view.
    faT = fa.reshape(num_faces, 3 * channels).T             # [3C, F]
    att_cols = []
    for c in range(channels):
        wgt = [faT[k * channels + c] * ws[k] for k in range(3)]
        na = (wgt[0] * a_e[0] + wgt[1] * a_e[1] + wgt[2] * a_e[2]) \
            * inv_area
        nb = (wgt[0] * b_e[0] + wgt[1] * b_e[1] + wgt[2] * b_e[2]) \
            * inv_area
        nc = torch.where(valid, wgt[0], 0.0)
        att_cols += [na, nb, nc]
    att = torch.stack(att_cols, dim=1)                      # [F, 3C]
    return geo, att, valid


def edge_filter_cols(face_verts_screen):
    """(x0, y0, a0, b0, a1, b1, a2, b2, c0) [F] columns for binning.

    The same anchored edge planes :func:`setup_planes` packs into ``geo``,
    as plain columns for ``binning.bin_faces_packed``'s conservative
    triangle-vs-subtile overlap filter. c1 = c2 = 0 for valid faces, so
    only c0 is returned; invalid faces get all-exclude edges.
    """
    fv = torch.as_tensor(face_verts_screen, dtype=torch.float32)
    xs, ys, _, ws = _corners(fv)
    valid, orient, area2, a_e, b_e = _oriented_edges(xs, ys, ws)
    c0 = torch.where(valid, orient * area2, -1.0)
    return (xs[0], ys[0], a_e[0], b_e[0], a_e[1], b_e[1], a_e[2], b_e[2], c0)


def _to_i32(v):
    """f32 -> int32 saturating like XLA's convert (NaN -> 0).

    A bare ``.to(torch.int32)`` is undefined out of range (it gives
    INT_MIN on x86), which would cull a valid face whose vertex lies far
    off screen to the right or below.
    """
    v = torch.nan_to_num(v, nan=0.0)
    return torch.clamp(v, -2.0**31, 2147483520.0).to(torch.int32)


def face_bbox_cols(face_verts_screen, valid, height: int, width: int):
    """Conservative pixel-index bounding boxes for binning (non-diff).

    Returns FOUR separate [F] int32 tensors (xmin, xmax, ymin, ymax),
    inclusive pixel indices; empty boxes are encoded with max < min.
    Faces entirely outside z in [-1, 1] are also culled here.
    """
    fv = torch.as_tensor(face_verts_screen, dtype=torch.float32).detach()
    x, y, z = fv[..., 0], fv[..., 1], fv[..., 2]

    xmin = _to_i32(torch.floor(torch.amin(x, dim=1) - 0.5))
    xmax = _to_i32(torch.ceil(torch.amax(x, dim=1) - 0.5))
    ymin = _to_i32(torch.floor(torch.amin(y, dim=1) - 0.5))
    ymax = _to_i32(torch.ceil(torch.amax(y, dim=1) - 0.5))

    onscreen = (
        (xmax >= 0) & (xmin <= width - 1) & (ymax >= 0) & (ymin <= height - 1)
        & (torch.amin(z, dim=1) <= 1.0) & (torch.amax(z, dim=1) >= -1.0)
    )
    keep = valid & onscreen
    xmin = torch.where(keep, torch.clamp(xmin, 0, width - 1), 0)
    xmax = torch.where(keep, torch.clamp(xmax, 0, width - 1), -1)
    ymin = torch.where(keep, torch.clamp(ymin, 0, height - 1), 0)
    ymax = torch.where(keep, torch.clamp(ymax, 0, height - 1), -1)
    return xmin, xmax, ymin, ymax


def face_bboxes(face_verts_screen, valid, height: int, width: int):
    """[F, 4] stacked variant of :func:`face_bbox_cols` (tests/tooling)."""
    return torch.stack(
        face_bbox_cols(face_verts_screen, valid, height, width), dim=-1
    )
