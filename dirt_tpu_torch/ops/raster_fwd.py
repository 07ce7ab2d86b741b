"""Raster forward, packed and dense engines: face tables, CUDA kernel
wrappers, plain versions.

Counterpart of ``dirt_tpu/ops/raster_fwd.py`` (the CSR kernel comes with
its engine). The dense whole-tile engine is at the end of the module:
``pack_face_table``, ``raster_forward`` (kernel
``csrc/raster_fwd_dense.cu`` for CUDA tensors, replacing ``_fwd_kernel``)
and ``raster_forward_plain`` (CPU tensors).

``raster_forward_packed`` returns what the JAX function of that name
returns — pixels [C, Hp, Wp], fid [Hp, Wp] and zbuf [Hp, Wp] in image
layout — through one of two implementations of the same function:

* for CUDA tensors, the hand-written kernel
  ``dirt_tpu_torch/csrc/raster_fwd_packed.cu``, which replaces
  ``_fwd_packed_kernel`` and, on this path, both ``flat_subtile_swap_pallas``
  passes (it reads and writes image layout directly);
* for CPU tensors, :func:`raster_forward_packed_plain`, vectorised PyTorch
  with the kernel's arithmetic in the same order.

There is no fallback: a tensor on any other device raises, and a kernel
that does not build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dirt_tpu_torch.ops import _build
from dirt_tpu_torch.ops.binning import (
    GROUPS,
    PACK_ITERS,
    SUB_H,
    SUB_W,
    PackedBins,
)
from dirt_tpu_torch.ops.triangle_setup import GEO_USED

BIG_Z = 3.0e38  # z-buffer clear value (acts as +inf in f32 compares)

COL_ID = GEO_USED          # float face id (exact for F < 2^24)
COL_STRIP = GEO_USED + 1   # strip placeholder column
COL_ATT = GEO_USED + 2     # 3 columns per channel

# Launches of the CUDA kernel in this process: the wrapper adds one where
# it launches, and nowhere else (the smoke script reads it to prove that
# the main path went through the kernel).
LAUNCHES = 0
LAUNCHES_DENSE = 0

_KERNEL = "raster_fwd_packed"
_DENSE = "raster_fwd_dense"


def packed_table_width(channels: int) -> int:
    width = COL_ATT + 3 * channels
    return -(-width // 8) * 8


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
    sentinel[0, 4] = -1.0
    sentinel[0, 7] = -1.0
    sentinel[0, 10] = -1.0
    sentinel[0, 16] = 1.0
    sentinel[0, COL_ID] = float(num_faces)
    return torch.cat([body, sentinel], dim=0)


def raster_forward_packed(
    table2, bins: PackedBins, background_chw, *, tile_h: int, tile_w: int,
    rows=None,
):
    """Forward pass over packed subtile bins (``bin_faces_packed``).

    Args:
        table2: [F + 1, W] from :func:`pack_face_table_v2`.
        bins: PackedBins.
        background_chw: [C, Hp, Wp] f32 padded to tile multiples.
        rows: optional precomputed ``table2[bins.entries // 8]``.
    Returns:
        pixels [C, Hp, Wp] f32, fid [Hp, Wp] int32, zbuf [Hp, Wp] f32.
    """
    if rows is None:
        rows = table2[bins.entries.long() // 8]
    device = background_chw.device
    if device.type == "cpu":
        return raster_forward_packed_plain(
            rows, bins, background_chw, tile_h=tile_h, tile_w=tile_w
        )
    if device.type != "cuda":
        raise ValueError(
            f"raster_forward_packed: no kernel for device {device}"
        )
    return _launch(rows, bins, background_chw, tile_h, tile_w)


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


def check_rows(rows, bins: PackedBins, channels: int, device):
    """The gathered entry rows: [budget_rows, >= COL_ATT + 3C] float32."""
    min_width = COL_ATT + 3 * channels
    if rows.ndim != 2 or rows.shape[1] < min_width:
        raise ValueError(f"rows: want [budget_rows, >= {min_width}], got "
                         f"{tuple(rows.shape)}")
    check_tensor("rows", rows, torch.float32,
                 (bins.entries.shape[0], rows.shape[1]), device)


@functools.cache
def _kernel_fn():
    fn = _build.load(_KERNEL).dirt_raster_fwd_packed
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    return fn


def _launch(rows, bins, background_chw, tile_h, tile_w):
    global LAUNCHES
    channels, hp, wp = _check_geometry(background_chw, tile_h, tile_w)
    device = background_chw.device
    total = (hp // tile_h) * (wp // tile_w)
    strips = tile_h // SUB_H
    check_meta(bins, total, strips, device)
    check_rows(rows, bins, channels, device)
    check_tensor("background", background_chw, torch.float32,
                 (channels, hp, wp), device)

    pix = torch.empty((channels, hp, wp), dtype=torch.float32, device=device)
    fid = torch.empty((hp, wp), dtype=torch.int32, device=device)
    zbuf = torch.empty((hp, wp), dtype=torch.float32, device=device)
    fn = _kernel_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            rows.data_ptr(), rows.shape[1],
            bins.start_block.data_ptr(), bins.n_iters.data_ptr(),
            bins.iter_off.data_ptr(), bins.strip_iters.data_ptr(),
            background_chw.data_ptr(), pix.data_ptr(), fid.data_ptr(),
            zbuf.data_ptr(), channels, hp, wp, tile_h, stream,
        )
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err}")
    LAUNCHES += 1
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


def raster_forward_packed_plain(
    rows, bins: PackedBins, background_chw, *, tile_h: int, tile_w: int,
):
    """Plain PyTorch version of the packed kernel (any device).

    Step k evaluates, for every (tile, strip, group) job at once, the
    strip's k-th iteration over the job's 8x16 pixels; a step past the
    strip's run (or past the tile's ``n_iters``) is masked. Like the
    kernel, the loop keeps the depth and the winning budget row per pixel,
    and the reciprocal and attribute planes are evaluated once, from the
    winning row, afterwards — the same expressions in the same order.
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
    coef = rows[:, :GEO_USED]
    for k in range(n_steps):
        it = lo + k
        live = it < hi                                   # [T, S, 1]
        row = torch.where(live, (row0 + it) * GROUPS + g, 0)  # [T, S, G]
        m = coef[row][..., None, None]                   # [T, S, G, 17, 1, 1]

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
        best = torch.where(mask, row[..., None, None], best)

    hit = best >= 0
    cols = torch.tensor(
        [0, 1, 14, 15, 16, COL_ID]
        + [COL_ATT + q for q in range(3 * channels)], device=device,
    )
    w = rows.index_select(1, cols)[torch.clamp(best, min=0)]  # [..., 6+3C]
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
    sentinel[0, 4] = -1.0
    sentinel[0, 7] = -1.0
    sentinel[0, 10] = -1.0
    sentinel[0, 16] = 1.0
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
        [Hp, Wp] f32 (BIG_Z background). A depth tie goes to the lower
        face id.
    """
    device = background_chw.device
    if device.type == "cpu":
        return raster_forward_plain(table, bins, counts, background_chw,
                                    tile_h=tile_h, tile_w=tile_w)
    if device.type != "cuda":
        raise ValueError(f"raster_forward: no kernel for device {device}")
    return _launch_dense(table, bins, counts, background_chw, tile_h, tile_w)


@functools.cache
def _dense_fn():
    fn = _build.load(_DENSE).dirt_raster_fwd_dense
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int]
        + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 5
        + [ctypes.c_void_p]
    )
    return fn


def _launch_dense(table, bins, counts, background_chw, tile_h, tile_w):
    global LAUNCHES_DENSE
    channels, hp, wp, total = _check_dense(table, bins, counts,
                                           background_chw, tile_h, tile_w)
    if tile_h % 8 or (tile_w > 128 and tile_w % 128) or tile_w < 1:
        raise ValueError(
            f"raster_fwd_dense kernel needs tile_h a multiple of 8 and "
            f"tile_w <= 128 or a multiple of 128, got {tile_h}x{tile_w}")
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
    fn = _dense_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            table.data_ptr(), table.shape[1], bins.data_ptr(),
            counts.data_ptr(), cap, background_chw.data_ptr(),
            pix.data_ptr(), fid.data_ptr(), zbuf.data_ptr(),
            channels, hp, wp, tile_h, tile_w, stream,
        )
    if err != 0:
        raise RuntimeError(f"{_DENSE} launch failed: CUDA error {err}")
    LAUNCHES_DENSE += 1
    return pix, fid, zbuf


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
    channels, hp, wp, total = _check_dense(table, bins, counts,
                                           background_chw, tile_h, tile_w)
    device = background_chw.device
    tiles_y, tiles_x = hp // tile_h, wp // tile_w

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
    ids = bins.long()
    for k in range(n_steps):
        live = (k < counts)[:, None, None]                   # [T, 1, 1]
        face = ids[:, k]                                     # [T]
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
