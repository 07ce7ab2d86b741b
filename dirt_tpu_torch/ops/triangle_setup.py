"""Differentiable triangle setup: screen transform and plane coefficients.

Counterpart of ``dirt_tpu/ops/triangle_setup.py``; see its docstring for
the anchored plane form and why it keeps f32 precision at 1024^2. Setup
is plain differentiable PyTorch. The raster op's backward computes
gradients with respect to these coefficients and pulls them back to the
faces with :func:`setup_planes_vjp`, the setup's vector-Jacobian product,
where ``dirt_tpu`` calls ``jax.vjp`` of its ``setup_planes``:

* CUDA tensors launch the hand-written kernel ``csrc/setup_vjp.cu`` (one
  launch, a face a thread, no reduction across faces; see its note for
  the bound and the design).
* CPU tensors take :func:`setup_planes_vjp_plain`, the same arithmetic in
  the kernel's order.

The raster op's forward sets its faces up with :func:`setup_faces`: the
planes, the validity, the binning boxes and, for the packed engine, the
edge-filter columns, in one call. CUDA tensors launch
``csrc/setup_fwd.cu`` (one launch, a face a thread); CPU tensors take
:func:`setup_faces_plain`, which composes :func:`setup_planes`,
:func:`face_bbox_cols` / :func:`face_bboxes` and :func:`edge_filter_cols`.

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

import ctypes
import functools
from typing import NamedTuple

import torch

from dirt_tpu_torch.ops import _build
from dirt_tpu_torch.utils import trace

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


def setup_planes_vjp(face_verts, face_attrs, d_geo, d_att,
                     row_shift: float = 0.0, need_fv: bool = True,
                     need_fa: bool = True):
    """Pull the plane cotangents back through :func:`setup_planes`.

    Args:
        face_verts: [F, 3, 4] f32 screen-space faces, as the raster op
            saved them.
        face_attrs: [F, 3, C] f32.
        d_geo: [F, >= 17] f32 cotangent of ``geo`` (columns 17 on, the
            padding, are not read), any row stride.
        d_att: [F, 3C] f32 cotangent of ``att``, any row stride.
        row_shift: the planes were set up on the faces moved ``row_shift``
            rows down (``y + row_shift``, unit Jacobian).
        need_fv, need_fa: which cotangents to return.
    Returns:
        (d_face_verts [F, 3, 4] or None, d_face_attrs [F, 3, C] or None),
        what ``torch.autograd.grad`` through ``setup_planes`` gives, up to
        rounding.
    """
    num_faces, channels = _check_vjp_args(face_verts, face_attrs, d_geo,
                                          d_att)
    device = face_verts.device
    if device.type == "cpu":
        return setup_planes_vjp_plain(face_verts, face_attrs, d_geo, d_att,
                                      row_shift, need_fv, need_fa)
    if device.type != "cuda":
        raise ValueError(f"setup_planes_vjp: no kernel for device {device}")
    return _launch_vjp(face_verts.contiguous(), face_attrs.contiguous(),
                       _unit_columns(d_geo), _unit_columns(d_att),
                       num_faces, channels, row_shift, need_fv, need_fa)


def _check_vjp_args(face_verts, face_attrs, d_geo, d_att):
    """(F, C) of the VJP's inputs; raises on a dtype, shape or device the
    kernel does not take."""
    args = dict(face_verts=face_verts, face_attrs=face_attrs, d_geo=d_geo,
                d_att=d_att)
    for name, t in args.items():
        if t.dtype != torch.float32:
            raise ValueError(f"setup_planes_vjp: {name} must be float32, "
                             f"got {t.dtype}")
        if t.device != face_verts.device:
            raise ValueError(f"setup_planes_vjp: {name} is on {t.device}, "
                             f"face_verts on {face_verts.device}")
    num_faces = face_verts.shape[0]
    channels = face_attrs.shape[-1] if face_attrs.ndim == 3 else 0
    want = dict(face_verts=(num_faces, 3, 4),
                face_attrs=(num_faces, 3, channels),
                d_att=(num_faces, 3 * channels))
    for name, shape in want.items():
        if tuple(args[name].shape) != shape or channels < 1:
            raise ValueError(f"setup_planes_vjp: want {name} of shape "
                             f"{shape} (F, C >= 1), got "
                             f"{tuple(args[name].shape)}")
    if d_geo.ndim != 2 or d_geo.shape[0] != num_faces \
            or d_geo.shape[1] < GEO_USED:
        raise ValueError(f"setup_planes_vjp: want d_geo of shape "
                         f"({num_faces}, >= {GEO_USED}), got "
                         f"{tuple(d_geo.shape)}")
    return num_faces, channels


def _unit_columns(t):
    """``t`` [F, K] as it is when each row's K floats are adjacent and the
    rows apart (a view of wider rows, say), else a contiguous copy."""
    if t.stride(1) == 1 and t.stride(0) >= t.shape[1]:
        return t
    return t.contiguous()


def _row_stride(t):
    """``t``'s row stride as the kernel reads it (a single row's stride,
    which nothing reads, can be anything)."""
    return max(t.stride(0), t.shape[1])


def setup_planes_vjp_plain(face_verts, face_attrs, d_geo, d_att,
                           row_shift: float = 0.0, need_fv: bool = True,
                           need_fa: bool = True):
    """Plain PyTorch version of the setup VJP kernel (any device): the
    kernel's arithmetic on [F] columns, in its order."""
    num_faces = face_verts.shape[0]
    channels = face_attrs.shape[-1]
    xs, ys, zs, ws = _corners(face_verts)
    if row_shift:
        ys = tuple(y + row_shift for y in ys)
    x0, x1, x2 = xs
    y0, y1, y2 = ys
    ex1, ey2 = x1 - x0, y2 - y0
    ey1, ex2 = y1 - y0, x2 - x0
    area2 = ex1 * ey2 - ey1 * ex2
    valid = (torch.abs(area2) > AREA_EPS) & (ws[0] > 0.0) & (ws[1] > 0.0) \
        & (ws[2] > 0.0)
    o = torch.where(area2 >= 0.0, 1.0, -1.0)
    a = (o * (y1 - y2), o * (y2 - y0), o * (y0 - y1))
    b = (o * (x2 - x1), o * (x0 - x2), o * (x1 - x0))
    ia = torch.reciprocal(torch.where(valid, o * area2, 1.0))

    def dot(u, v):
        return (u[0] * v[0] + u[1] * v[1]) + u[2] * v[2]

    # The z and denominator planes.
    g = d_geo.T                                             # [>= 17, F]
    gza, gzb = g[11] * ia, g[12] * ia
    gwa, gwb = g[14] * ia, g[15] * ia
    dia = g[11] * dot(zs, a)
    dia = dia + g[12] * dot(zs, b)
    dia = dia + g[14] * dot(ws, a)
    dia = dia + g[15] * dot(ws, b)
    dz = [gza * a[k] + gzb * b[k] for k in range(3)]
    dw = [gwa * a[k] + gwb * b[k] for k in range(3)]
    da = [(g[2 + 3 * k] + gza * zs[k]) + gwa * ws[k] for k in range(3)]
    db = [(g[3 + 3 * k] + gzb * zs[k]) + gwb * ws[k] for k in range(3)]
    dz[0] = dz[0] + g[13]
    dw[0] = dw[0] + g[16]

    # The attribute planes, a channel at a time.
    faT = face_attrs.reshape(num_faces, 3 * channels).T     # [3C, F]
    t = d_att.T                                             # [3C, F]
    dfa = [None] * (3 * channels)
    for c in range(channels):
        attr = [faT[k * channels + c] for k in range(3)]
        q = [attr[k] * ws[k] for k in range(3)]
        gna, gnb = t[3 * c] * ia, t[3 * c + 1] * ia
        dia = dia + t[3 * c] * dot(q, a)
        dia = dia + t[3 * c + 1] * dot(q, b)
        dq = []
        for k in range(3):
            dq.append(gna * a[k] + gnb * b[k])
            da[k] = da[k] + gna * q[k]
            db[k] = db[k] + gnb * q[k]
        dq[0] = dq[0] + t[3 * c + 2]
        for k in range(3):
            dfa[k * channels + c] = dq[k] * ws[k]
            dw[k] = dw[k] + dq[k] * attr[k]

    # c0 of edge 0 is |area2|, and 1 / |area2| scales every slope.
    darea = o * (g[4] - dia * (ia * ia))
    pa = [o * d for d in da]
    pb = [o * d for d in db]
    dex1, dey2 = darea * ey2, darea * ex1
    dey1, dex2 = -(darea * ex2), -(darea * ey1)
    dx = (((g[0] + pb[1]) - pb[2]) - (dex1 + dex2),
          (pb[2] - pb[0]) + dex1, (pb[0] - pb[1]) + dex2)
    dy = (((g[1] + pa[2]) - pa[1]) - (dey1 + dey2),
          (pa[0] - pa[2]) + dey1, (pa[1] - pa[0]) + dey2)
    d_fv = d_fa = None
    if need_fv:
        cols = [d for k in range(3) for d in (dx[k], dy[k], dz[k], dw[k])]
        d_fv = torch.where(valid[:, None], torch.stack(cols, dim=1), 0.0)
        d_fv = d_fv.reshape(num_faces, 3, 4)
    if need_fa:
        d_fa = torch.where(valid[:, None], torch.stack(dfa, dim=1), 0.0)
        d_fa = d_fa.reshape(num_faces, 3, channels)
    return d_fv, d_fa


_KERNEL = "setup_vjp"


@functools.cache
def _kernel_fn():
    fn = _build.load(_KERNEL).dirt_setup_vjp
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    return fn


def _launch_vjp(face_verts, face_attrs, d_geo, d_att, num_faces: int,
                channels: int, row_shift: float, need_fv: bool,
                need_fa: bool):
    # raster_fwd imports this module.
    from dirt_tpu_torch.ops.raster_fwd import on_device

    d_fv = torch.empty_like(face_verts) if need_fv else None
    d_fa = torch.empty_like(face_attrs) if need_fa else None
    if num_faces == 0 or not (need_fv or need_fa):
        return d_fv, d_fa
    fn = _kernel_fn()
    with on_device(face_verts.device):
        stream = torch.cuda.current_stream(face_verts.device).cuda_stream
        err = fn(face_verts.data_ptr(), face_attrs.data_ptr(),
                 d_geo.data_ptr(), _row_stride(d_geo), d_att.data_ptr(),
                 _row_stride(d_att),
                 d_fv.data_ptr() if need_fv else None,
                 d_fa.data_ptr() if need_fa else None,
                 num_faces, channels, float(row_shift), stream)
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err}")
    trace.count(f"launch.{_KERNEL}")
    return d_fv, d_fa


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
    """[F, 4] stacked variant of :func:`face_bbox_cols` (the layout the
    dense and streaming binnings read)."""
    return torch.stack(
        face_bbox_cols(face_verts_screen, valid, height, width), dim=-1
    )


class FaceSetup(NamedTuple):
    """What :func:`setup_faces` hands the raster op's forward."""

    geo: torch.Tensor        # [F, 24] f32, as setup_planes'
    att: torch.Tensor        # [F, 3C] f32
    valid: torch.Tensor      # [F] bool
    # The binning boxes (xmin, xmax, ymin, ymax), inclusive pixel indices:
    # four [F] int32 columns for the packed engine, [F, 4] int32 rows for
    # the dense and streaming engines, None without an engine.
    bbox: tuple | torch.Tensor | None
    # The packed engine's edge-filter columns (edge_filter_cols'), else None.
    edges: tuple | None


# The engines whose binnings take the boxes: as columns with the edge
# filter (packed), as [F, 4] rows (dense, csr).
_ENGINES = ("packed", "dense", "csr")


def setup_faces(face_verts, face_attrs, height: int = 1, width: int = 1,
                engine: str | None = None) -> FaceSetup:
    """The forward's triangle setup of screen-space faces, in one call.

    Args:
        face_verts: [F, 3, 4] f32 (x_s, y_s, z_ndc, invw).
        face_attrs: [F, 3, C] f32, C >= 1.
        height, width: the image the boxes are culled and clipped to.
        engine: the resolved engine, which picks the boxes' layout (see
            :class:`FaceSetup`); None sets the planes up alone.
    Returns:
        :class:`FaceSetup`. Not differentiable: :func:`setup_planes` is the
        differentiable form, :func:`setup_planes_vjp` its pull-back.

    CUDA tensors launch the kernel ``csrc/setup_fwd.cu`` once; CPU tensors
    take :func:`setup_faces_plain`. Raises on a dtype, shape, device or
    engine the kernel does not take.
    """
    num_faces, channels = _check_setup_args(face_verts, face_attrs, height,
                                            width, engine)
    device = face_verts.device
    if device.type == "cpu":
        return setup_faces_plain(face_verts, face_attrs, height, width,
                                 engine)
    if device.type != "cuda":
        raise ValueError(f"setup_faces: no kernel for device {device}")
    return _launch_setup(face_verts.contiguous(), face_attrs.contiguous(),
                         num_faces, channels, height, width, engine)


def _check_setup_args(face_verts, face_attrs, height, width, engine):
    """(F, C) of the setup's inputs; raises on what the kernel does not
    take."""
    for name, t in (("face_verts", face_verts), ("face_attrs", face_attrs)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise ValueError(f"setup_faces: {name} must be a float32 tensor, "
                             f"got {getattr(t, 'dtype', type(t))}")
    if face_attrs.device != face_verts.device:
        raise ValueError(f"setup_faces: face_attrs is on {face_attrs.device}, "
                         f"face_verts on {face_verts.device}")
    num_faces = face_verts.shape[0]
    channels = face_attrs.shape[-1] if face_attrs.ndim == 3 else 0
    if (tuple(face_verts.shape) != (num_faces, 3, 4)
            or tuple(face_attrs.shape) != (num_faces, 3, channels)
            or channels < 1):
        raise ValueError(f"setup_faces: want face_verts [F, 3, 4] and "
                         f"face_attrs [F, 3, C >= 1], got "
                         f"{tuple(face_verts.shape)} and "
                         f"{tuple(face_attrs.shape)}")
    if engine not in (None, *_ENGINES):
        raise ValueError(f"setup_faces: unknown engine {engine!r}")
    if engine is not None and not (height >= 1 and width >= 1):
        raise ValueError(f"setup_faces: want an image of at least one "
                         f"pixel, got {height} x {width}")
    return num_faces, channels


def setup_faces_plain(face_verts, face_attrs, height: int = 1,
                      width: int = 1, engine: str | None = None) -> FaceSetup:
    """Plain PyTorch version of :func:`setup_faces` (any device):
    :func:`setup_planes`, then the boxes of :func:`face_bbox_cols` (packed)
    or :func:`face_bboxes` (dense, streaming) and, for the packed engine,
    :func:`edge_filter_cols`."""
    face_verts = face_verts.detach()
    geo, att, valid = setup_planes(face_verts, face_attrs.detach())
    bbox = edges = None
    if engine == "packed":
        bbox = face_bbox_cols(face_verts, valid, height, width)
        edges = edge_filter_cols(face_verts)
    elif engine is not None:
        bbox = face_bboxes(face_verts, valid, height, width).contiguous()
    return FaceSetup(geo, att, valid, bbox, edges)


_SETUP_KERNEL = "setup_fwd"


@functools.cache
def _setup_fn():
    fn = _build.load(_SETUP_KERNEL).dirt_setup_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def _launch_setup(face_verts, face_attrs, num_faces: int, channels: int,
                  height: int, width: int, engine):
    # raster_fwd imports this module.
    from dirt_tpu_torch.ops.raster_fwd import on_device

    device = face_verts.device
    geo = torch.empty((num_faces, GEO_WIDTH), dtype=torch.float32,
                      device=device)
    att = torch.empty((num_faces, 3 * channels), dtype=torch.float32,
                      device=device)
    valid = torch.empty((num_faces,), dtype=torch.bool, device=device)
    columns = engine == "packed"
    boxes = edges = None
    if engine is not None:
        boxes = torch.empty((4, num_faces) if columns else (num_faces, 4),
                            dtype=torch.int32, device=device)
    if columns:
        edges = torch.empty((9, num_faces), dtype=torch.float32,
                            device=device)
    if num_faces:
        fn = _setup_fn()
        with on_device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(face_verts.data_ptr(), face_attrs.data_ptr(),
                     geo.data_ptr(), att.data_ptr(), valid.data_ptr(),
                     None if boxes is None else boxes.data_ptr(),
                     0 if columns else 1,
                     None if edges is None else edges.data_ptr(),
                     num_faces, channels, max(int(height), 1),
                     max(int(width), 1), stream)
        if err != 0:
            raise RuntimeError(f"{_SETUP_KERNEL} launch failed: CUDA error "
                               f"{err}")
        trace.count(f"launch.{_SETUP_KERNEL}")
    bbox = tuple(boxes.unbind(0)) if columns else boxes
    return FaceSetup(geo, att, valid, bbox,
                     tuple(edges.unbind(0)) if columns else None)
