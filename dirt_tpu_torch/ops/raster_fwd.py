"""Raster forward, packed, dense and streaming engines: face tables, CUDA
kernel wrappers, plain versions.

Counterpart of ``dirt_tpu/ops/raster_fwd.py``. The dense whole-tile engine
and the streaming (CSR) engine are at the end of the module:
``pack_face_table``, ``raster_forward`` (kernel
``csrc/raster_fwd_dense.cu`` for CUDA tensors, replacing ``_fwd_kernel``)
and ``raster_forward_plain`` (CPU tensors); ``raster_forward_csr`` (kernel
``csrc/raster_fwd_csr.cu``, replacing ``_fwd_csr_kernel``) and
``raster_forward_csr_plain``.

``raster_forward_packed`` returns what the JAX function of that name
returns — pixels [C, Hp, Wp], fid [Hp, Wp] and zbuf [Hp, Wp] in image
layout — through one of two implementations of the same function:

* for CUDA tensors, the hand-written kernel
  ``dirt_tpu_torch/csrc/raster_fwd_packed.cu``, which replaces
  ``_fwd_packed_kernel`` and reads and writes image layout directly;
* for CPU tensors, :func:`raster_forward_packed_plain`, vectorised PyTorch
  with the kernel's arithmetic in the same order.

:func:`flat_subtile_swap` is the image <-> flat-subtile layout permutation
(kernel ``csrc/subtile_swap.cu``, replacing ``flat_subtile_swap_pallas``;
:func:`flat_subtile_swap_plain` for CPU tensors). The sharded halo backward
of the packed engine hands its per-pixel fields to the backward kernel in
that layout (``packed_bwd.prepare_backward_packed(nbrs=...)``).

There is no fallback: a tensor on any other device raises, and a kernel
that does not build or launch raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from dirt_tpu_torch.ops import _build
from dirt_tpu_torch.ops.binning import (
    CHUNK,
    GROUPS,
    PACK_ITERS,
    SUB_H,
    SUB_W,
    PackedBins,
)
from dirt_tpu_torch.ops.triangle_setup import GEO_USED
from dirt_tpu_torch.utils import trace

BIG_Z = 3.0e38  # z-buffer clear value (acts as +inf in f32 compares)

COL_ID = GEO_USED          # float face id (exact for F < 2^24)
COL_STRIP = GEO_USED + 1   # strip placeholder column
COL_ATT = GEO_USED + 2     # 3 columns per channel


_KERNEL = "raster_fwd_packed"
_SWAP = "subtile_swap"
_DENSE = "raster_fwd_dense"
_CSR = "raster_fwd_csr"


def packed_table_width(channels: int) -> int:
    width = COL_ATT + 3 * channels
    return -(-width // 8) * 8


def _fill_sentinel(sentinel):
    """The sentinel row's edge offsets -1 (no pixel passes) and its
    denominator offset 1, in place. Written with ``fill_``: a Python number
    assigned by indexing is copied from the host, which a CUDA-graph
    capture refuses."""
    for col in (4, 7, 10):
        sentinel[0, col].fill_(-1.0)
    sentinel[0, 16].fill_(1.0)


def pack_face_table_v2(geo, att):
    """[F + 1, W] face table for the packed kernel (sentinel row last).

    Layout per row: geo[0:17] | float(face id) | strip placeholder |
    attribute planes [3C] | zero pad to a multiple of 8 columns. The
    sentinel row's edges exclude every pixel.
    """
    num_faces = geo.shape[0]
    width = packed_table_width(att.shape[1] // 3)
    ids = torch.arange(num_faces, dtype=torch.float32, device=geo.device)
    zeros = torch.zeros((num_faces, 1), dtype=torch.float32,
                        device=geo.device)
    body = torch.cat([geo[:, :GEO_USED], ids[:, None], zeros, att], dim=1)
    body = F.pad(body, (0, width - body.shape[1]))
    sentinel = torch.zeros((1, width), dtype=torch.float32, device=geo.device)
    _fill_sentinel(sentinel)
    sentinel[0, COL_ID].fill_(float(num_faces))
    return torch.cat([body, sentinel], dim=0)


def raster_forward_packed(
    table2, bins: PackedBins, background_chw, *, tile_h: int, tile_w: int,
):
    """Forward pass over packed subtile bins (``bin_faces_packed``).

    Args:
        table2: [F + 1, W] from :func:`pack_face_table_v2`. Budget row r's
            job reads the table's row ``bins.entries[r] >> 3`` where it
            lies; nothing is gathered beforehand.
        bins: PackedBins.
        background_chw: [C, Hp, Wp] f32 padded to tile multiples.
    Returns:
        pixels [C, Hp, Wp] f32, fid [Hp, Wp] int32, zbuf [Hp, Wp] f32.
    """
    check_table_rows(table2, bins)
    device = background_chw.device
    if device.type == "cpu":
        return raster_forward_packed_plain(
            table2, bins, background_chw, tile_h=tile_h, tile_w=tile_w
        )
    if device.type != "cuda":
        raise ValueError(
            f"raster_forward_packed: no kernel for device {device}"
        )
    return _launch(table2, bins, background_chw, tile_h, tile_w)


def check_tensor(name, arr, dtype, shape, device):
    """Raise unless ``arr`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device`` (what a kernel's raw pointer needs)."""
    if (arr.device != device or arr.dtype != dtype
            or tuple(arr.shape) != tuple(shape) or not arr.is_contiguous()):
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {'' if arr.is_contiguous() else 'non-contiguous '}"
            f"{arr.dtype} {tuple(arr.shape)} on {arr.device}"
        )


def need_boxes(name, bbox, cull):
    """A kernel needs both kinds of boxes (``raster.DenseBins`` /
    ``StreamBins``' ``bbox`` and ``cull``)."""
    if bbox is None or cull is None:
        raise ValueError(f"{name}: the kernel needs the faces' bbox and "
                         "cull boxes")


def check_boxes(bbox, cull, num_faces, device):
    """``bbox`` [num_faces, 4] and ``cull`` [>= num_faces, 4] int32."""
    check_tensor("bbox", bbox, torch.int32, (num_faces, 4), device)
    if cull.ndim != 2 or cull.shape[0] < num_faces:
        raise ValueError(f"cull: want [>= {num_faces}, 4], got "
                         f"{tuple(cull.shape)}")
    check_tensor("cull", cull, torch.int32, (cull.shape[0], 4), device)


def on_device(device):
    """Context that makes ``device`` the current CUDA device for a launch;
    nothing to enter (the common case) when it already is."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _check_geometry(background_chw, tile_h: int, tile_w: int):
    channels, hp, wp = background_chw.shape
    if tile_w != GROUPS * SUB_W:
        raise ValueError(f"packed engine needs tile_w == 128, got {tile_w}")
    if tile_h % SUB_H or not 0 < tile_h // SUB_H <= 8:
        raise ValueError(f"packed engine needs tile_h in 8..64 by 8, "
                         f"got {tile_h}")
    if hp % tile_h or wp % tile_w:
        raise ValueError(f"image {hp}x{wp} is not padded to {tile_h}x"
                         f"{tile_w} tiles")
    return channels, hp, wp


def check_meta(bins: PackedBins, total: int, strips: int, device):
    """The per-tile and per-strip int32 fields a packed kernel reads."""
    for name, n in (("start_block", total), ("n_iters", total),
                    ("iter_off", total * strips),
                    ("strip_iters", total * strips)):
        check_tensor(name, getattr(bins, name), torch.int32, (n,), device)


def check_table_rows(table, bins: PackedBins, num_faces: int | None = None):
    """A packed face table holds F + 1 rows, the faces and the sentinel: F
    is ``num_faces`` where given, else ``bins.pool_offs``' length less one
    where the binning kept it (any device: the plain versions index the
    table by the entries' faces too)."""
    if num_faces is None and bins.pool_offs is not None:
        num_faces = bins.pool_offs.shape[0] - 1
    if table.ndim != 2 or (num_faces is not None
                           and table.shape[0] != num_faces + 1):
        want = "F + 1" if num_faces is None else num_faces + 1
        raise ValueError(f"table: want [{want}, W] (the faces and the "
                         f"sentinel), got {tuple(table.shape)}")


def check_table(table, bins: PackedBins, channels: int, device):
    """The face table a packed kernel reads through ``bins.entries``:
    contiguous float32 [F + 1, W], W >= COL_ATT + 3C and a multiple of 4,
    from a 16-byte aligned start (its rows are read as 16-byte vectors);
    the entries int32 [budget_rows], with budget rows that fit 32-bit
    indices. :func:`check_table_rows` checks F."""
    min_width = COL_ATT + 3 * channels
    if table.ndim != 2 or table.shape[1] < min_width or table.shape[1] % 4:
        raise ValueError(f"table: want [F + 1, W] with W >= {min_width} a "
                         f"multiple of 4, got {tuple(table.shape)}")
    check_tensor("table", table, torch.float32, tuple(table.shape), device)
    if table.data_ptr() % 16:
        raise ValueError(f"table: want a 16-byte aligned start, got a view "
                         f"at byte offset {table.data_ptr() % 16}")
    budget_rows = bins.entries.shape[0]
    check_tensor("entries", bins.entries, torch.int32, (budget_rows,),
                 device)
    if budget_rows >= 2**31:
        raise ValueError(f"{budget_rows} budget rows exceed 32-bit indices")


@functools.cache
def _kernel_fn():
    fn = _build.load(_KERNEL).dirt_raster_fwd_packed
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    return fn


def _launch(table2, bins, background_chw, tile_h, tile_w):
    channels, hp, wp = _check_geometry(background_chw, tile_h, tile_w)
    device = background_chw.device
    total = (hp // tile_h) * (wp // tile_w)
    strips = tile_h // SUB_H
    check_meta(bins, total, strips, device)
    check_table(table2, bins, channels, device)
    check_tensor("background", background_chw, torch.float32,
                 (channels, hp, wp), device)
    # The kernel's pixel offsets are 32-bit, and it reads the background as
    # 16-byte vectors.
    if channels * hp * wp >= 2**31:
        raise ValueError(f"a {channels}x{hp}x{wp} image exceeds 32-bit "
                         "indices")
    if background_chw.data_ptr() % 16:
        raise ValueError(f"background: want a 16-byte aligned start, got a "
                         f"view at byte offset "
                         f"{background_chw.data_ptr() % 16}")

    pix = torch.empty((channels, hp, wp), dtype=torch.float32, device=device)
    fid = torch.empty((hp, wp), dtype=torch.int32, device=device)
    zbuf = torch.empty((hp, wp), dtype=torch.float32, device=device)
    fn = _kernel_fn()
    with on_device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            table2.data_ptr(), table2.shape[1], bins.entries.data_ptr(),
            bins.start_block.data_ptr(), bins.n_iters.data_ptr(),
            bins.iter_off.data_ptr(), bins.strip_iters.data_ptr(),
            background_chw.data_ptr(), pix.data_ptr(), fid.data_ptr(),
            zbuf.data_ptr(), channels, hp, wp, tile_h, stream,
        )
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err}")
    trace.count(f"launch.{_KERNEL}")
    return pix, fid, zbuf


def _to_jobs(x, tiles_y, tiles_x, strips):
    """[..., Hp, Wp] image layout -> [..., T, S, G, 8, 16] job layout."""
    lead = x.shape[:-2]
    n = len(lead)
    x = x.reshape(*lead, tiles_y, strips, SUB_H, tiles_x, GROUPS, SUB_W)
    x = x.permute(*range(n), n, n + 3, n + 1, n + 4, n + 2, n + 5)
    return x.reshape(*lead, tiles_y * tiles_x, strips, GROUPS, SUB_H, SUB_W)


def _to_image(x, tiles_y, tiles_x, strips):
    """[..., T, S, G, 8, 16] job layout -> [..., Hp, Wp] image layout."""
    lead = x.shape[:-5]
    n = len(lead)
    x = x.reshape(*lead, tiles_y, tiles_x, strips, GROUPS, SUB_H, SUB_W)
    x = x.permute(*range(n), n, n + 2, n + 4, n + 1, n + 3, n + 5)
    return x.reshape(*lead, tiles_y * strips * SUB_H,
                     tiles_x * GROUPS * SUB_W)


# --- the layout swap ------------------------------------------------------

_SWAP_MAX_ARRAYS = 8   # arrays one launch of subtile_swap.cu takes


def flat_subtile_swap(arrays):
    """Image <-> flat-subtile layout, for a list of arrays of one image size.

    ``flat[8*S + k, 128*tx + 16*r + c] == image[8*S + r, 128*tx + 16*k + c]``
    (k = 16-column group, r = row within the 8-row strip, c = column within
    the group): the 128 pixels of each 8x16 subtile become one 128-element
    row. Swapping r and k is its own inverse, so the same call converts
    both ways.

    Args:
        arrays: list of [Hp, Wp] or [K, Hp, Wp] tensors, any mix of float32
            and int32, on one device; Hp % 8 == 0 and Wp % 128 == 0.
    Returns:
        list of new tensors of the same shapes and dtypes.
    """
    arrays = list(arrays)
    if not arrays:
        return []
    hp, wp = arrays[0].shape[-2:]
    device = arrays[0].device
    for i, a in enumerate(arrays):
        if (a.ndim not in (2, 3) or tuple(a.shape[-2:]) != (hp, wp)
                or a.dtype not in (torch.float32, torch.int32)
                or a.device != device):
            raise ValueError(
                f"flat_subtile_swap: array {i} is {a.dtype} "
                f"{tuple(a.shape)} on {a.device}; want float32 or int32 "
                f"[{hp}, {wp}] or [K, {hp}, {wp}] on {device}")
    if hp % SUB_H or wp % (GROUPS * SUB_W):
        raise ValueError(f"flat_subtile_swap: image {hp}x{wp} is not a "
                         f"multiple of {SUB_H}x{GROUPS * SUB_W}")
    if device.type == "cpu":
        return [flat_subtile_swap_plain(a) for a in arrays]
    if device.type != "cuda":
        raise ValueError(f"flat_subtile_swap: no kernel for device {device}")
    out = []
    for i in range(0, len(arrays), _SWAP_MAX_ARRAYS):
        out += _launch_swap(arrays[i:i + _SWAP_MAX_ARRAYS], hp, wp, device)
    return out


def flat_subtile_swap_plain(x):
    """Plain PyTorch version of the layout swap for one array (any
    device): the strip's row axis and its 16-column-group axis trade
    places."""
    *lead, hp, wp = x.shape
    y = x.reshape(*lead, hp // SUB_H, SUB_H, wp // (GROUPS * SUB_W), GROUPS,
                  SUB_W)
    return y.transpose(-4, -2).reshape(*lead, hp, wp)


@functools.cache
def _swap_fn():
    fn = _build.load(_SWAP).dirt_subtile_swap
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    return fn


def _launch_swap(arrays, hp, wp, device):
    n = len(arrays)
    # The kernel moves 16-byte vectors: a contiguous view at an odd offset
    # of its storage is copied to an allocation of its own.
    arrays = [a.contiguous() for a in arrays]
    arrays = [a.clone() if a.data_ptr() % 16 else a for a in arrays]
    outs = [torch.empty_like(a) for a in arrays]
    srcs = (ctypes.c_void_p * n)(*(a.data_ptr() for a in arrays))
    dsts = (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs))
    planes = (ctypes.c_int * n)(
        *(a.shape[0] if a.ndim == 3 else 1 for a in arrays))
    fn = _swap_fn()
    with on_device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(srcs, dsts, planes, n, hp, wp, stream)
    if err != 0:
        raise RuntimeError(f"{_SWAP} launch failed: CUDA error {err}")
    trace.count(f"launch.{_SWAP}")
    return outs


def raster_forward_packed_plain(
    table2, bins: PackedBins, background_chw, *, tile_h: int, tile_w: int,
):
    """Plain PyTorch version of the packed kernel (any device).

    Step k evaluates, for every (tile, strip, group) job at once, the
    strip's k-th iteration over the job's 8x16 pixels; a step past the
    strip's run (or past the tile's ``n_iters``) is masked. Like the
    kernel, each job reads its face's table row through its entry
    (``table2[entries >> 3]``), the loop keeps the depth and the winning
    face per pixel, and the reciprocal and attribute planes are evaluated
    once, from the winner's table row, afterwards — the same expressions
    in the same order.
    """
    channels, hp, wp = _check_geometry(background_chw, tile_h, tile_w)
    device = background_chw.device
    tiles_y, tiles_x = hp // tile_h, wp // tile_w
    strips = tile_h // SUB_H
    total = tiles_y * tiles_x

    def arange(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    t = arange(total)[:, None, None]                     # [T, 1, 1]
    s = arange(strips)[None, :, None]                    # [1, S, 1]
    g = arange(GROUPS)[None, None, :]                    # [1, 1, G]
    lo = bins.iter_off.long().reshape(total, strips)[:, :, None]
    hi = torch.minimum(
        lo + bins.strip_iters.long().reshape(total, strips)[:, :, None],
        bins.n_iters.long()[:, None, None],
    )                                                    # [T, S, 1]
    row0 = bins.start_block.long()[:, None, None] * PACK_ITERS
    y = ((t // tiles_x) * tile_h + s * SUB_H)[..., None, None] \
        + arange(SUB_H)[:, None]                         # [T, S, 1, 8, 1]
    x = ((t % tiles_x) * tile_w + g * SUB_W)[..., None, None] \
        + arange(SUB_W)                                  # [T, 1, G, 1, 16]
    xf = x.to(torch.float32) + 0.5
    yf = y.to(torch.float32) + 0.5

    shape = (total, strips, GROUPS, SUB_H, SUB_W)
    zb = torch.full(shape, BIG_Z, dtype=torch.float32, device=device)
    best = torch.full(shape, -1, dtype=torch.int64, device=device)
    n_steps = int(torch.clamp(hi - lo, min=0).max()) if total else 0
    face_of = bins.entries.long() >> 3                   # [budget_rows]
    coef = table2[:, :GEO_USED]
    for k in range(n_steps):
        it = lo + k
        live = it < hi                                   # [T, S, 1]
        row = torch.where(live, (row0 + it) * GROUPS + g, 0)  # [T, S, G]
        face = face_of[row]                              # [T, S, G]
        m = coef[face][..., None, None]                  # [T, S, G, 17, 1, 1]

        def cf(q):
            return m[:, :, :, q]

        dx = xf - cf(0)
        dy = yf - cf(1)
        e0 = cf(2) * dx + cf(3) * dy + cf(4)
        e1 = cf(5) * dx + cf(6) * dy + cf(7)
        e2 = cf(8) * dx + cf(9) * dy + cf(10)
        inside = torch.minimum(torch.minimum(e0, e1), e2) >= 0.0
        zv = cf(11) * dx + cf(12) * dy + cf(13)
        mask = (inside & (zv < zb) & (zv >= -1.0) & (zv <= 1.0)
                & live[..., None, None])
        zb = torch.where(mask, zv, zb)
        best = torch.where(mask, face[..., None, None], best)

    hit = best >= 0
    cols = torch.tensor(
        [0, 1, 14, 15, 16, COL_ID]
        + [COL_ATT + q for q in range(3 * channels)], device=device,
    )
    w = table2.index_select(1, cols)[torch.clamp(best, min=0)]  # [.., 6+3C]
    dx = xf - w[..., 0]
    dy = yf - w[..., 1]
    den = w[..., 2] * dx + w[..., 3] * dy + w[..., 4]
    recip = 1.0 / den
    fid = torch.where(hit, w[..., 5].to(torch.int32), -1)
    bg = _to_jobs(background_chw, tiles_y, tiles_x, strips)
    pix = torch.stack([
        torch.where(
            hit,
            (w[..., 6 + 3 * ch] * dx + w[..., 7 + 3 * ch] * dy
             + w[..., 8 + 3 * ch]) * recip,
            bg[ch],
        )
        for ch in range(channels)
    ])
    return (
        _to_image(pix, tiles_y, tiles_x, strips),
        _to_image(fid, tiles_y, tiles_x, strips),
        _to_image(zb, tiles_y, tiles_x, strips),
    )


# --- dense whole-tile engine -------------------------------------------------


def pack_face_table(geo, att):
    """[Fp, GEO_USED + 3C] face table of the dense engine.

    ``table[:F, :17]`` is geo's used columns and ``table[:F, 17:]`` is att.
    One sentinel row follows (index F, the bin fill value: its edges exclude
    every pixel and its denominator is 1), repeated so the row count is a
    multiple of 8, as in ``dirt_tpu``.
    """
    num_faces = geo.shape[0]
    table = torch.cat([geo[:, :GEO_USED], att], dim=1)
    sentinel = torch.zeros((1, table.shape[1]), dtype=torch.float32,
                           device=geo.device)
    _fill_sentinel(sentinel)
    rows_padded = -(-(num_faces + 1) // 8) * 8
    return torch.cat(
        [table, sentinel.expand(rows_padded - num_faces, -1)], dim=0
    )


def _check_dense(table, bins, counts, background_chw, tile_h, tile_w):
    channels, hp, wp = background_chw.shape
    if hp % tile_h or wp % tile_w:
        raise ValueError(f"image {hp}x{wp} is not padded to {tile_h}x"
                         f"{tile_w} tiles")
    total = (hp // tile_h) * (wp // tile_w)
    if bins.ndim != 2 or bins.shape[0] != total or counts.shape != (total,):
        raise ValueError(f"bins {tuple(bins.shape)} / counts "
                         f"{tuple(counts.shape)} do not match {total} tiles")
    if table.ndim != 2 or table.shape[1] != GEO_USED + 3 * channels:
        raise ValueError(f"table: want [Fp, {GEO_USED + 3 * channels}], got "
                         f"{tuple(table.shape)}")
    return channels, hp, wp, total


def _check_dense_tile(kernel, tile_h, tile_w):
    """The tile shapes the whole-tile kernels' strip walk takes."""
    if tile_h % 8 or (tile_w > 128 and tile_w % 128) or tile_w < 1:
        raise ValueError(
            f"{kernel} kernel needs tile_h a multiple of 8 and "
            f"tile_w <= 128 or a multiple of 128, got {tile_h}x{tile_w}")


def raster_forward(table, bins, counts, background_chw, *, tile_h: int,
                   tile_w: int):
    """Dense forward: every tile scan-converts its binned faces.

    Args:
        table: [Fp, GEO_USED + 3C] f32 from :func:`pack_face_table`.
        bins: [T, cap] int32 face ids per tile, ascending, sentinel F in
            empty slots (``binning.bin_faces``).
        counts: [T] int32 (<= cap); slots past a tile's count are not read.
        background_chw: [C, Hp, Wp] f32 padded to tile multiples.
    Returns:
        pixels [C, Hp, Wp] f32, fid [Hp, Wp] int32 (-1 background), zbuf
        [Hp, Wp] f32 (BIG_Z background), and the [Fp, 4] int32
        :func:`csr_cull_boxes` of the table's rows over the padded image,
        which the kernel works out and culls by (the plain version computes
        them with :func:`csr_cull_boxes_plain`): the backward kernels scan
        them. A depth tie goes to the lower face id.

    The kernel tests a listed face only at pixels that its box meets, where
    alone it can pass the edge tests; the plain version tests it at every
    pixel of the tile. The result is the same.
    """
    device = background_chw.device
    if device.type == "cpu":
        _, hp, wp = background_chw.shape
        return (*raster_forward_plain(table, bins, counts, background_chw,
                                      tile_h=tile_h, tile_w=tile_w),
                csr_cull_boxes_plain(table, hp, wp))
    if device.type != "cuda":
        raise ValueError(f"raster_forward: no kernel for device {device}")
    return _launch_dense(table, bins, counts, background_chw, tile_h, tile_w)


@functools.cache
def _dense_fn():
    fn = _build.load(_DENSE).dirt_raster_fwd_dense
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 5
        + [ctypes.c_void_p]
    )
    return fn


def _launch_dense(table, bins, counts, background_chw, tile_h, tile_w):
    channels, hp, wp, total = _check_dense(table, bins, counts,
                                           background_chw, tile_h, tile_w)
    _check_dense_tile(_DENSE, tile_h, tile_w)
    device = background_chw.device
    cap = bins.shape[1]
    check_tensor("table", table, torch.float32, table.shape, device)
    check_tensor("bins", bins, torch.int32, (total, cap), device)
    check_tensor("counts", counts, torch.int32, (total,), device)
    check_tensor("background", background_chw, torch.float32,
                 (channels, hp, wp), device)

    pix = torch.empty((channels, hp, wp), dtype=torch.float32, device=device)
    fid = torch.empty((hp, wp), dtype=torch.int32, device=device)
    zbuf = torch.empty((hp, wp), dtype=torch.float32, device=device)
    boxes = torch.empty((table.shape[0], 4), dtype=torch.int32,
                        device=device)
    fn = _dense_fn()
    with on_device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            table.data_ptr(), table.shape[1], table.shape[0],
            bins.data_ptr(), counts.data_ptr(), cap, boxes.data_ptr(),
            background_chw.data_ptr(), pix.data_ptr(), fid.data_ptr(),
            zbuf.data_ptr(), channels, hp, wp, tile_h, tile_w, stream,
        )
    if err != 0:
        raise RuntimeError(f"{_DENSE} launch failed: CUDA error {err}")
    trace.count(f"launch.{_DENSE}")
    return pix, fid, zbuf, boxes


def _to_tiles(x, tiles_y, tiles_x, tile_h, tile_w):
    """[..., Hp, Wp] image layout -> [..., T, tile_h, tile_w]."""
    lead = x.shape[:-2]
    n = len(lead)
    x = x.reshape(*lead, tiles_y, tile_h, tiles_x, tile_w)
    x = x.permute(*range(n), n, n + 2, n + 1, n + 3)
    return x.reshape(*lead, tiles_y * tiles_x, tile_h, tile_w)


def _from_tiles(x, tiles_y, tiles_x, tile_h, tile_w):
    """[..., T, tile_h, tile_w] -> [..., Hp, Wp] image layout."""
    lead = x.shape[:-3]
    n = len(lead)
    x = x.reshape(*lead, tiles_y, tiles_x, tile_h, tile_w)
    x = x.permute(*range(n), n, n + 2, n + 1, n + 3)
    return x.reshape(*lead, tiles_y * tile_h, tiles_x * tile_w)


def raster_forward_plain(table, bins, counts, background_chw, *,
                         tile_h: int, tile_w: int):
    """Plain PyTorch version of the dense kernel (any device).

    Step k evaluates slot k of every tile's list over the tile's pixels; a
    step at or past the tile's count is masked. Like the kernel, the loop
    keeps the depth and the winning face per pixel, and the reciprocal and
    attribute planes are evaluated once, from the winner's row, afterwards:
    the same expressions in the same order.
    """
    _check_dense(table, bins, counts, background_chw, tile_h, tile_w)
    ids = bins.long()
    return _scan_lists_plain(table, lambda k: ids[:, k], counts,
                             background_chw, tile_h, tile_w)


def _scan_lists_plain(table, face_at, counts, background_chw, tile_h, tile_w):
    """The z-buffered scan of per-tile face lists, vectorised over tiles.

    ``face_at(k)`` is the [T] int64 face id at slot k of every tile's list
    (any valid table row where ``k >= counts[t]``: those steps are masked).
    """
    channels, hp, wp = background_chw.shape
    device = background_chw.device
    tiles_y, tiles_x = hp // tile_h, wp // tile_w
    total = tiles_y * tiles_x

    def arange(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    t = arange(total)[:, None, None]
    xf = ((t % tiles_x) * tile_w + arange(tile_w)).to(torch.float32) + 0.5
    yf = ((t // tiles_x) * tile_h
          + arange(tile_h)[:, None]).to(torch.float32) + 0.5

    shape = (total, tile_h, tile_w)
    zb = torch.full(shape, BIG_Z, dtype=torch.float32, device=device)
    best = torch.full(shape, -1, dtype=torch.int64, device=device)
    n_steps = int(counts.max()) if total else 0
    for k in range(n_steps):
        live = (k < counts)[:, None, None]                   # [T, 1, 1]
        face = face_at(k)                                    # [T]
        m = table[face][:, :GEO_USED, None, None]            # [T, 17, 1, 1]

        def cf(q):
            return m[:, q]

        dx = xf - cf(0)
        dy = yf - cf(1)
        e0 = cf(2) * dx + cf(3) * dy + cf(4)
        e1 = cf(5) * dx + cf(6) * dy + cf(7)
        e2 = cf(8) * dx + cf(9) * dy + cf(10)
        inside = torch.minimum(torch.minimum(e0, e1), e2) >= 0.0
        zv = cf(11) * dx + cf(12) * dy + cf(13)
        mask = inside & (zv < zb) & (zv >= -1.0) & (zv <= 1.0) & live
        zb = torch.where(mask, zv, zb)
        best = torch.where(mask, face[:, None, None], best)

    hit = best >= 0
    w = table[torch.clamp(best, min=0)]                      # [T, h, w, 17+3C]
    dx = xf - w[..., 0]
    dy = yf - w[..., 1]
    den = w[..., 14] * dx + w[..., 15] * dy + w[..., 16]
    recip = 1.0 / den
    fid = torch.where(hit, best, -1).to(torch.int32)
    bg = _to_tiles(background_chw, tiles_y, tiles_x, tile_h, tile_w)
    pix = torch.stack([
        torch.where(
            hit,
            (w[..., GEO_USED + 3 * ch] * dx + w[..., GEO_USED + 3 * ch + 1] * dy
             + w[..., GEO_USED + 3 * ch + 2]) * recip,
            bg[ch],
        )
        for ch in range(channels)
    ])
    return (
        _from_tiles(pix, tiles_y, tiles_x, tile_h, tile_w),
        _from_tiles(fid, tiles_y, tiles_x, tile_h, tile_w),
        _from_tiles(zb, tiles_y, tiles_x, tile_h, tile_w),
    )


# --- streaming (CSR) engine --------------------------------------------------


def _check_csr(table, entry_face, start_block, counts, background_chw,
               tile_h, tile_w):
    channels, hp, wp = background_chw.shape
    if hp % tile_h or wp % tile_w:
        raise ValueError(f"image {hp}x{wp} is not padded to {tile_h}x"
                         f"{tile_w} tiles")
    total = (hp // tile_h) * (wp // tile_w)
    if (entry_face.ndim != 1 or entry_face.shape[0] % CHUNK
            or start_block.shape != (total,) or counts.shape != (total,)):
        raise ValueError(
            f"entry_face {tuple(entry_face.shape)} / start_block "
            f"{tuple(start_block.shape)} / counts {tuple(counts.shape)} are "
            f"not CSR bins of {total} tiles")
    if table.ndim != 2 or table.shape[1] != GEO_USED + 3 * channels:
        raise ValueError(f"table: want [Fp, {GEO_USED + 3 * channels}], got "
                         f"{tuple(table.shape)}")
    return channels, hp, wp, total


def raster_forward_csr(table, entry_face, start_block, counts,
                       background_chw, *, tile_h: int, tile_w: int):
    """Streaming forward: every tile scan-converts its CSR run.

    Where ``dirt_tpu``'s function takes the pre-gathered rows
    ``table[entry_face]`` and a static chunk bound, this one takes the face
    table itself: the kernel gathers the rows it stages and loops to
    ``counts[t]``.

    Args:
        table: [Fp, GEO_USED + 3C] f32 from :func:`pack_face_table`.
        entry_face: [n_pad] int32 (``binning.bin_faces_csr``): tile t's faces
            are ``entry_face[start_block[t] * CHUNK + i]``, ``i < counts[t]``,
            ascending; slots past a run's count are not read.
        start_block, counts: [T] int32.
        background_chw: [C, Hp, Wp] f32 padded to tile multiples.
    Returns:
        pixels [C, Hp, Wp] f32, fid [Hp, Wp] int32 (-1 background), zbuf
        [Hp, Wp] f32 (BIG_Z background) and the [Fp, 4] int32 cull boxes,
        as :func:`raster_forward`. A depth tie goes to the lower face id.

    The kernel tests a listed face only at pixels that its
    :func:`csr_cull_boxes` box meets, where alone it can pass the edge
    tests; the plain version tests it at every pixel of the tile. The
    result is the same.
    """
    device = background_chw.device
    if device.type == "cpu":
        _, hp, wp = background_chw.shape
        return (*raster_forward_csr_plain(
            table, entry_face, start_block, counts, background_chw,
            tile_h=tile_h, tile_w=tile_w), csr_cull_boxes_plain(table, hp, wp))
    if device.type != "cuda":
        raise ValueError(f"raster_forward_csr: no kernel for device {device}")
    return _launch_csr(table, entry_face, start_block, counts,
                       background_chw, tile_h, tile_w)


def raster_forward_csr_plain(table, entry_face, start_block, counts,
                             background_chw, *, tile_h: int, tile_w: int):
    """Plain PyTorch version of the streaming kernel (any device): the
    dense plain version's step loop over each tile's CSR run, every listed
    face tested at every pixel of its tile. It takes ``counts.max()``
    Python steps."""
    _check_csr(table, entry_face, start_block, counts, background_chw,
               tile_h, tile_w)
    ids = entry_face.long()
    base = start_block.long() * CHUNK
    last = ids.shape[0] - 1
    return _scan_lists_plain(
        table, lambda k: ids[torch.clamp(base + k, max=last)], counts,
        background_chw, tile_h, tile_w)


@functools.cache
def _csr_fn():
    fn = _build.load(_CSR).dirt_raster_fwd_csr
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 5
        + [ctypes.c_void_p]
    )
    return fn


@functools.cache
def _boxes_fn():
    fn = _build.load(_CSR).dirt_csr_cull_boxes
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])
    return fn


def _launch_csr(table, entry_face, start_block, counts, background_chw,
                tile_h, tile_w):
    channels, hp, wp, total = _check_csr(
        table, entry_face, start_block, counts, background_chw, tile_h,
        tile_w)
    _check_dense_tile(_CSR, tile_h, tile_w)
    device = background_chw.device
    check_tensor("table", table, torch.float32, table.shape, device)
    check_tensor("entry_face", entry_face, torch.int32, entry_face.shape,
                 device)
    check_tensor("start_block", start_block, torch.int32, (total,), device)
    check_tensor("counts", counts, torch.int32, (total,), device)
    check_tensor("background", background_chw, torch.float32,
                 (channels, hp, wp), device)

    pix = torch.empty((channels, hp, wp), dtype=torch.float32, device=device)
    fid = torch.empty((hp, wp), dtype=torch.int32, device=device)
    zbuf = torch.empty((hp, wp), dtype=torch.float32, device=device)
    boxes = torch.empty((table.shape[0], 4), dtype=torch.int32,
                        device=device)
    fn = _csr_fn()
    with on_device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            table.data_ptr(), table.shape[1], table.shape[0],
            entry_face.data_ptr(), start_block.data_ptr(), counts.data_ptr(),
            boxes.data_ptr(), background_chw.data_ptr(), pix.data_ptr(),
            fid.data_ptr(), zbuf.data_ptr(), channels, hp, wp, tile_h,
            tile_w, stream,
        )
    if err != 0:
        raise RuntimeError(f"{_CSR} launch failed: CUDA error {err}")
    trace.count(f"launch.{_CSR}")
    return pix, fid, zbuf, boxes


# csrc/raster_tile.cuh's CULL_ROUNDING: 4u, u = 2^-24.
CULL_ROUNDING = 4.0 / 16777216.0


def csr_cull_boxes(table, hp: int, wp: int):
    """The pixels of an ``hp`` x ``wp`` array at which each face of
    ``table`` can pass the forward kernels' edge tests, float32 rounding
    included: [rows, 4] int32 (xmin, xmax, ymin, ymax), inclusive and
    clamped to the array, (0, -1, 0, -1) for none. The dense and the
    streaming kernel work these out themselves
    (``csrc/raster_tile.cuh::cull_box``), cull each tile's list by them and
    hand them back; the backward kernels scan them. A CUDA
    table runs that code alone (no launch of a kernel is counted); a CPU
    table takes :func:`csr_cull_boxes_plain`."""
    device = table.device
    if device.type == "cpu":
        return csr_cull_boxes_plain(table, hp, wp)
    if device.type != "cuda":
        raise ValueError(f"csr_cull_boxes: no kernel for device {device}")
    if table.ndim != 2 or table.shape[1] < GEO_USED:
        raise ValueError(f"csr_cull_boxes: table {tuple(table.shape)} has "
                         f"fewer than {GEO_USED} columns")
    check_tensor("table", table, torch.float32, table.shape, device)
    boxes = torch.empty((table.shape[0], 4), dtype=torch.int32,
                        device=device)
    fn = _boxes_fn()
    with on_device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(table.data_ptr(), table.shape[1], table.shape[0],
                 boxes.data_ptr(), hp, wp, stream)
    if err != 0:
        raise RuntimeError(f"{_CSR} box launch failed: CUDA error {err}")
    return boxes


def csr_cull_boxes_plain(table, hp: int, wp: int):
    """Plain PyTorch version of ``cull_box`` (any device): the same float64
    operations in the same order, so the same boxes bit for bit.

    Edge k of a row (``a, b, c`` at columns 2 + 3k.., anchored at columns
    0, 1) passes at a pixel centre only where ``a X + b Y + c >=
    -CULL_ROUNDING (|a| MX + |b| MY)``: (X, Y) is the centre less the
    anchor, MX and MY bounds of their magnitudes over the pixels that can
    pass. The box is that of the pixel centres inside the triangle the
    three edges so moved out enclose, in two rounds: MX, MY over the whole
    array, then over the first round's box, which holds every pixel that
    passes (a sliver's corners move by the allowance over the edges'
    angle). A row with a non-finite coefficient, or whose edges do not
    close a triangle, gets the whole array; a row with an edge that
    excludes every pixel, or whose box holds no pixel centre, gets none."""
    m = table[:, :11].double()
    ax, ay = m[:, 0], m[:, 1]
    a, b, c = m[:, 2:11:3], m[:, 3:11:3], m[:, 4:11:3]          # [rows, 3]
    finite = torch.isfinite(m).all(1)
    never = ((a == 0.0) & (b == 0.0) & (c < 0.0)).any(1)
    nxt = [1, 2, 0]
    aj, bj = a[:, nxt], b[:, nxt]
    det = a * bj - aj * b
    closed = (det > 0.0).all(1) | (det < 0.0).all(1)
    mx = torch.maximum((0.5 - ax).abs(), ((wp - 0.5) - ax).abs())
    my = torch.maximum((0.5 - ay).abs(), ((hp - 0.5) - ay).abs())
    meets = torch.ones_like(finite)
    for _ in range(2):
        r = -(c + CULL_ROUNDING * (a.abs() * mx[:, None]
                                   + b.abs() * my[:, None]))
        rj = r[:, nxt]
        x = (r * bj - rj * b) / det
        y = (a * rj - aj * r) / det
        x0 = torch.ceil(ax + x.amin(1) - 0.5)
        x1 = torch.floor(ax + x.amax(1) - 0.5)
        y0 = torch.ceil(ay + y.amin(1) - 0.5)
        y1 = torch.floor(ay + y.amax(1) - 0.5)
        meets &= ((x0 <= x1) & (y0 <= y1) & (x1 >= 0.0) & (x0 <= wp - 1.0)
                  & (y1 >= 0.0) & (y0 <= hp - 1.0))
        x0, x1 = x0.clamp(min=0.0), x1.clamp(max=wp - 1.0)
        y0, y1 = y0.clamp(min=0.0), y1.clamp(max=hp - 1.0)
        mx = torch.maximum(((x0 + 0.5) - ax).abs(), ((x1 + 0.5) - ax).abs())
        my = torch.maximum(((y0 + 0.5) - ay).abs(), ((y1 + 0.5) - ay).abs())
    box = torch.nan_to_num(torch.stack([x0, x1, y0, y1], 1)).to(torch.int32)
    none = torch.tensor([0, -1, 0, -1], dtype=torch.int32,
                        device=table.device)
    whole = torch.tensor([0, wp - 1, 0, hp - 1], dtype=torch.int32,
                         device=table.device)
    box = torch.where(meets[:, None], box, none)
    box = torch.where(closed[:, None], box, whole)
    box = torch.where(never[:, None], none, box)
    return torch.where(finite[:, None], box, whole)
