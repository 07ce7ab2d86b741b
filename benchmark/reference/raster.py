"""The raster of the reference: DIRT's semantics, with no caps and no tiles.

* Screen space: ``x = (x_ndc + 1) / 2 * W``, ``y = (1 - y_ndc) / 2 * H``;
  pixel (i, j) has its centre at (j + 0.5, i + 0.5). A face's screen
  vertices are (x, y, z_ndc, 1 / w).
* Coverage: the centre lies in a face iff its three oriented edge
  functions are >= 0 (both windings render). A face whose doubled area is
  at most 1e-10 in absolute value, or with a vertex at 1 / w <= 0, never
  covers.
* Depth: z_ndc linear in screen space; a face wins a pixel iff -1 <= z <=
  1 and its z is the least, ties to the lowest face index. Background: id
  -1, depth +inf, the background's value.
* Attributes: perspective-correct, ``sum_k b_k a_k / w_k / sum_k b_k / w_k``
  with screen barycentrics ``b_k``.
* Gradients: the interior term is the exact gradient at fixed coverage
  (autograd of :func:`interpolate`). The silhouette term: for every pair
  of horizontally or vertically adjacent pixels with different ids, the
  front pixel (lesser depth; on a tie the right or lower one) must show a
  face; of that face's edges, the lowest-index one that is >= 0 at the
  front centre and < 0 at the back centre gets ``d(A, B, C) += S * (x*,
  y*, 1) / (|A| + |B|)``, where ``E = A x + B y + C`` is the edge,
  ``S = 0.5 * sum_c (g_front + g_back) (p_front - p_back)`` and (x*, y*)
  is where the edge crosses the segment between the centres, clamped to
  it; skipped where |A| + |B| or the slope along the pair is below 1e-12.
  Edges are evaluated anchored at a vertex (:func:`edges`).
  :func:`edge_surrogate` is a scalar whose gradient is that term.

Every function runs on the device and in the dtype of its inputs; faces
are rasterised face by face over their bounding boxes, in blocks of
(face, pixel) pairs, so that a million faces fit.
"""

from __future__ import annotations

import torch

from benchmark.reference.camera import mm

AREA_EPS = 1e-10
W_EPS = 1e-9
A_EPS = 1e-12
BLOCK_PAIRS = 1 << 23
# Edge j runs from vertex (j + 1) % 3 to (j + 2) % 3, opposite vertex j.
EDGE_FROM = (1, 2, 0)
EDGE_TO = (2, 0, 1)


def screen(vertices_clip, height: int, width: int):
    """[..., 4] clip space -> [..., 4] (x, y, z_ndc, 1 / w)."""
    w = vertices_clip[..., 3]
    ok = torch.abs(w) > W_EPS
    invw = torch.where(ok, 1.0 / torch.where(ok, w, torch.ones_like(w)),
                       torch.zeros_like(w))
    x = (vertices_clip[..., 0] * invw + 1.0) * 0.5 * width
    y = (1.0 - vertices_clip[..., 1] * invw) * 0.5 * height
    return torch.stack([x, y, vertices_clip[..., 2] * invw, invw], dim=-1)


def edges(fv):
    """(A, B) [F, 3], the edges' anchors (xa, ya) [F, 3], orientation [F]
    and doubled signed area [F] of screen faces [F, 3, 4]: ``E_j = A_j (x
    - xa_j) + B_j (y - ya_j)`` >= 0 inside. Each edge is anchored at the
    vertex it starts from, so that its value keeps float32's precision at
    1024^2 (``A x + B y + C`` would lose it in C)."""
    x, y = fv[..., 0], fv[..., 1]
    area2 = ((x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
             - (y[:, 1] - y[:, 0]) * (x[:, 2] - x[:, 0]))
    orient = torch.where(area2 >= 0.0, 1.0, -1.0).to(fv.dtype)
    xa, ya = x[:, EDGE_FROM], y[:, EDGE_FROM]
    xb, yb = x[:, EDGE_TO], y[:, EDGE_TO]
    o = orient[:, None]
    return o * (ya - yb), o * (xb - xa), xa, ya, orient, area2


def _pixel_range(lo, hi, size):
    """First and count of the pixel centres k + 0.5 in [lo, hi]."""
    lo = torch.nan_to_num(lo, nan=1e18).clamp(-1e9, 1e9)
    hi = torch.nan_to_num(hi, nan=-1e18).clamp(-1e9, 1e9)
    first = torch.ceil(lo - 0.5).clamp(min=0).long()
    last = torch.floor(hi - 0.5).clamp(max=size - 1).long()
    return first, (last - first + 1).clamp(min=0)


def rasterise(fv, height: int, width: int):
    """(fid [H, W] int64, zbuf [H, W]) of screen faces [F, 3, 4]."""
    fv = fv.detach()
    device, dtype = fv.device, fv.dtype
    a, b, xa, ya, _, area2 = edges(fv)
    valid = (torch.abs(area2) > AREA_EPS) & torch.all(fv[..., 3] > 0.0, 1)
    j0, nx = _pixel_range(fv[..., 0].min(1).values, fv[..., 0].max(1).values,
                          width)
    i0, ny = _pixel_range(fv[..., 1].min(1).values, fv[..., 1].max(1).values,
                          height)
    area = torch.where(valid, nx * ny, 0)
    live = torch.nonzero(area).flatten()
    counts = area[live]
    ends = torch.cumsum(counts, 0)
    zbuf = torch.full((height * width,), torch.inf, dtype=dtype,
                      device=device)
    fid = torch.full((height * width,), -1, dtype=torch.int64, device=device)
    start = 0
    while start < len(live):
        done = int(ends[start - 1]) if start else 0
        stop = max(int(torch.searchsorted(ends, done + BLOCK_PAIRS,
                                          right=True)), start + 1)
        faces = live[start:stop]
        n = counts[start:stop]
        f = torch.repeat_interleave(faces, n)
        offsets = torch.cumsum(n, 0) - n
        local = (torch.arange(int(n.sum()), device=device)
                 - torch.repeat_interleave(offsets, n))
        row = i0[f] + local // nx[f]
        col = j0[f] + local % nx[f]
        px = col.to(dtype) + 0.5
        py = row.to(dtype) + 0.5
        e = a[f] * (px[:, None] - xa[f]) + b[f] * (py[:, None] - ya[f])
        bary = e / torch.abs(area2[f])[:, None]
        z = torch.sum(bary * fv[f, :, 2], 1)
        ok = torch.all(e >= 0.0, 1) & (z >= -1.0) & (z <= 1.0)
        pix, z, f = (row * width + col)[ok], z[ok], f[ok]
        zmin = torch.full_like(zbuf, torch.inf).scatter_reduce(
            0, pix, z, "amin")
        win = z == zmin[pix]
        fmin = torch.full_like(fid, torch.iinfo(torch.int64).max)
        fmin = fmin.scatter_reduce(0, pix[win], f[win], "amin")
        better = (zmin < zbuf) | ((zmin == zbuf) & (fmin < fid))
        zbuf = torch.where(better, zmin, zbuf)
        fid = torch.where(better, fmin, fid)
        start = stop
    return fid.reshape(height, width), zbuf.reshape(height, width)


def interpolate(fv, fa, fid, background, prec: str):
    """[H, W, C] attributes at fixed coverage ``fid``, differentiable with
    respect to ``fv``, ``fa`` and ``background``; the perspective-correct
    sum is a matrix product (in TF32 under ``prec="tf32"``)."""
    height, width, channels = background.shape
    flat = fid.reshape(-1)
    pix = torch.nonzero(flat >= 0).flatten()
    f = flat[pix]
    v = fv[f]
    px = (pix % width).to(fv.dtype) + 0.5
    py = (pix // width).to(fv.dtype) + 0.5

    def edge(p, q, x, y):
        return (q[:, 0] - p[:, 0]) * (y - p[:, 1]) \
            - (q[:, 1] - p[:, 1]) * (x - p[:, 0])

    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    area2 = edge(v0, v1, v2[:, 0], v2[:, 1])
    bary = torch.stack([edge(v1, v2, px, py), edge(v2, v0, px, py),
                        edge(v0, v1, px, py)], 1) / area2[:, None]
    weights = bary * v[:, :, 3]
    color = mm(weights[:, None, :], fa[f], prec)[:, 0, :]
    color = color / torch.sum(weights, 1, keepdim=True)
    out = background.reshape(-1, channels)
    return out.index_put((pix,), color).reshape(height, width, channels)


def _pairs(fid, zbuf, axis: int):
    """(front, back) flat pixel indices of the adjacent pairs along
    ``axis`` whose ids differ and whose front pixel shows a face."""
    height, width = fid.shape
    idx = torch.arange(height * width, device=fid.device).reshape(
        height, width)
    if axis == 1:
        first, second = idx[:, :-1].reshape(-1), idx[:, 1:].reshape(-1)
    else:
        first, second = idx[:-1, :].reshape(-1), idx[1:, :].reshape(-1)
    flat_fid, flat_z = fid.reshape(-1), zbuf.reshape(-1)
    keep = flat_fid[first] != flat_fid[second]
    first, second = first[keep], second[keep]
    first_front = flat_z[first] < flat_z[second]
    front = torch.where(first_front, first, second)
    back = torch.where(first_front, second, first)
    shows = flat_fid[front] >= 0
    return front[shows], back[shows]


def edge_surrogate(fv, fid, zbuf, pixels, grad_pixels):
    """A scalar whose gradient with respect to the screen faces ``fv`` is
    the silhouette term of the module docstring; ``pixels`` and
    ``grad_pixels`` [H, W, C] are the raster's output and its upstream
    gradient (both taken as constants)."""
    height, width, channels = pixels.shape
    a, b, xa, ya, orient, _ = edges(fv.detach())
    flat_p = pixels.detach().reshape(-1, channels)
    flat_g = grad_pixels.detach().reshape(-1, channels)
    flat_fid = fid.reshape(-1)
    total = fv.sum() * 0.0
    for axis in (1, 0):
        front, back = _pairs(fid, zbuf, axis)
        f = flat_fid[front]
        s = 0.5 * torch.sum((flat_g[front] + flat_g[back])
                            * (flat_p[front] - flat_p[back]), 1)
        xf = (front % width).to(fv.dtype) + 0.5
        yf = (front // width).to(fv.dtype) + 0.5
        xb = (back % width).to(fv.dtype) + 0.5
        yb = (back // width).to(fv.dtype) + 0.5

        def value(x, y):
            return (a[f] * (x[:, None] - xa[f])
                    + b[f] * (y[:, None] - ya[f]))

        crossing = (value(xf, yf) >= 0.0) & (value(xb, yb) < 0.0)
        j = torch.argmax(crossing.to(torch.int8), 1)
        aj, bj = a[f, j], b[f, j]
        x0, y0 = xa[f, j], ya[f, j]
        denom = torch.abs(aj) + torch.abs(bj)
        slope = aj if axis == 1 else bj
        ok = crossing.any(1) & (denom >= A_EPS) & (torch.abs(slope) >= A_EPS)
        safe = torch.where(ok, slope, torch.ones_like(slope))
        # Where the edge crosses the segment between the centres, clamped.
        if axis == 1:
            xs = (x0 - bj * (yf - y0) / safe).clamp(torch.minimum(xf, xb),
                                                    torch.maximum(xf, xb))
            ys = yf
        else:
            ys = (y0 - aj * (xf - x0) / safe).clamp(torch.minimum(yf, yb),
                                                    torch.maximum(yf, yb))
            xs = xf
        scale = torch.where(ok, s / torch.where(ok, denom,
                                                torch.ones_like(denom)), 0.0)
        va = torch.as_tensor(EDGE_FROM, device=fv.device)[j]
        vb = torch.as_tensor(EDGE_TO, device=fv.device)[j]
        xa_, ya_ = fv[f, va, 0], fv[f, va, 1]
        xe, ye = fv[f, vb, 0], fv[f, vb, 1]
        plane = orient[f] * ((ya_ - ye) * (xs - xa_) + (xe - xa_) * (ys - ya_))
        total = total + torch.sum(scale * plane)
    return total
