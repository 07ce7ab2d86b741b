"""Per-face gradient scatter: pixel cotangent rows -> face rows.

Counterpart of ``dirt_tpu/ops/scatter.py``: ``_scatter_kernel`` /
``scatter_to_faces`` over the dense engine's bins and
``_scatter_csr_kernel`` / ``scatter_to_faces_csr`` over the streaming
engine's CSR runs. Both sum each covered pixel's cotangent row ``cot[:, y,
x]`` (``K = 12 + 3C`` columns: 9 edge, 3 denominator, 3C attribute) onto
the row of the face that owns the pixel. The row-sharded renderer's
backward (``parallel.sharding``) is their caller, through
``raster.make_scatter_fn``: the per-pixel cotangents there are made on
arrays extended by the neighbour slabs' halo rows, so the reduction onto
faces is a step of its own.

* CUDA tensors launch the hand-written kernels ``csrc/scatter_faces.cu``
  and ``csrc/scatter_faces_csr.cu``, which are ``csrc/scatter_rows.cuh``'s
  two passes. Pass 1: one block per 128 slots of one tile's list, none for a
  chunk or CSR block that holds no live entry; a warp sums the pixels its
  face owns inside its cull box and the tile with a batch of columns in
  registers and all of a pixel's plane loads in flight at once. Pass 2: a
  block per 32 faces sums each face's partial rows in tile order and writes
  every row of the output, zeros included, so the wrappers allocate it with
  ``torch.empty`` and clear nothing. No atomics, so two runs give equal bits. The TPU
  kernels' one-hot matrix products and resident face table have no
  counterpart. Like the TPU kernels, they drop a pixel whose owner its
  tile's list lacks; the forward lists every owner.
* CPU tensors take :func:`scatter_to_faces_plain` /
  :func:`scatter_to_faces_csr_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dirt_tpu_torch.ops import _build
from dirt_tpu_torch.ops.binning import CHUNK
from dirt_tpu_torch.ops.raster_fwd import (
    check_boxes,
    check_tensor,
    need_boxes,
    on_device,
)
from dirt_tpu_torch.utils import trace


_KERNEL = "scatter_faces"
_CSR = "scatter_faces_csr"


def scatter_to_faces(cot_cf, fid, bins, counts, num_rows: int, *,
                     tile_h: int, tile_w: int, bbox=None, cull=None):
    """Sum per-pixel cotangent rows onto their owning face's row.

    Args:
        cot_cf: [K, Hp, Wp] f32 per-pixel cotangents, channels-first,
            padded to whole tiles; pixels that own no face must be zero.
        fid: [Hp, Wp] int32 owning face per pixel (negative = none; padding
            too).
        bins: [T, cap] int32 ascending face ids per tile; counts: [T]
            int32. The forward's bins: every fid >= 0 of a tile is in that
            tile's list.
        num_rows: rows of the output, F + 1 (the sentinel row included).
        bbox: [F, 4] int32 (xmin, xmax, ymin, ymax), the boxes the bins
            were made from (``raster.DenseBins.bbox``): the kernel sums a
            face's rows over the tiles of its box.
        cull: [>= F, 4] int32, boxes that hold every pixel each face owns:
            the forward's cull boxes (``raster.DenseBins.cull``). The kernel
            scans a face's cull box, not its whole tiles. CUDA tensors need
            both; the plain version reads neither.
    Returns:
        [num_rows rounded up to 8, K] f32; callers slice [:num_faces].
    """
    device = fid.device
    if device.type == "cpu":
        return scatter_to_faces_plain(cot_cf, fid, num_rows)
    if device.type != "cuda":
        raise ValueError(f"scatter_to_faces: no kernel for device {device}")
    need_boxes("scatter_to_faces", bbox, cull)
    return _launch(cot_cf, fid, bins, counts, num_rows, tile_h, tile_w, bbox,
                   cull)


def scatter_to_faces_plain(cot_cf, fid, num_rows: int):
    """Plain PyTorch version of the scatter kernel (any device).

    One ``index_add_`` of the ``[Hp * Wp, K]`` pixel rows by ``fid``,
    accumulated in float64 and rounded once (the kernel sums float32 in its
    own fixed order, so the two agree to rounding); pixels with ``fid < 0``
    are dropped.
    """
    k_cols = cot_cf.shape[0]
    owner = fid.reshape(-1).long()
    keep = owner >= 0
    rows = cot_cf.reshape(k_cols, -1).T[keep].to(torch.float64)
    rows_padded = -(-num_rows // 8) * 8
    out = torch.zeros((rows_padded, k_cols), dtype=torch.float64,
                      device=fid.device)
    out.index_add_(0, owner[keep], rows)
    return out.to(torch.float32)


def _check_image(cot_cf, fid, bbox, cull, num_faces, tile_h, tile_w):
    """The image-space tensors and boxes both scatter kernels read; returns
    (K, Hp, Wp, tiles)."""
    device = fid.device
    if cot_cf.ndim != 3:
        raise ValueError(f"cot_cf: want [K, Hp, Wp], got "
                         f"{tuple(cot_cf.shape)}")
    k_cols, hp, wp = cot_cf.shape
    if hp % tile_h or wp % tile_w:
        raise ValueError(f"image {hp}x{wp} is not padded to {tile_h}x"
                         f"{tile_w} tiles")
    check_tensor("cot_cf", cot_cf, torch.float32, (k_cols, hp, wp), device)
    check_tensor("fid", fid, torch.int32, (hp, wp), device)
    check_boxes(bbox, cull, num_faces, device)
    return k_cols, hp, wp, (hp // tile_h) * (wp // tile_w)


@functools.cache
def _kernel_fn():
    fn = _build.load(_KERNEL).dirt_scatter_faces
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    return fn


def _launch(cot_cf, fid, bins, counts, num_rows, tile_h, tile_w, bbox, cull):
    device = fid.device
    num_faces = num_rows - 1
    k_cols, hp, wp, total = _check_image(cot_cf, fid, bbox, cull, num_faces,
                                         tile_h, tile_w)
    if bins.ndim != 2 or bins.shape[0] != total:
        raise ValueError(f"bins {tuple(bins.shape)} do not match {total} "
                         f"tiles")
    cap = bins.shape[1]
    check_tensor("bins", bins, torch.int32, (total, cap), device)
    check_tensor("counts", counts, torch.int32, (total,), device)

    rows_padded = -(-num_rows // 8) * 8
    # Pass 2 writes every row of ``out`` (the sentinel and padding rows with
    # zeros), and reads only the rows of ``partial`` that pass 1 wrote: no
    # clearing of either.
    out = torch.empty((rows_padded, k_cols), dtype=torch.float32,
                      device=device)
    partial = torch.empty((total * cap, k_cols), dtype=torch.float32,
                          device=device)
    fn = _kernel_fn()
    with on_device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            bins.data_ptr(), counts.data_ptr(), bbox.data_ptr(),
            cull.data_ptr(), fid.data_ptr(), cot_cf.data_ptr(),
            partial.data_ptr(),
            out.data_ptr(), k_cols, hp, wp, tile_h, tile_w, cap, num_faces,
            rows_padded, stream,
        )
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err}")
    trace.count(f"launch.{_KERNEL}")
    return out


# --- streaming (CSR) engine --------------------------------------------------


def scatter_to_faces_csr(cot_cf, fid, entry_face, start_block, counts,
                         num_faces: int, *, tile_h: int, tile_w: int,
                         bbox=None, cull=None):
    """:func:`scatter_to_faces` over the streaming forward's CSR runs.

    ``entry_face`` [n_pad] int32, ``start_block`` and ``counts`` [T] int32
    are ``binning.bin_faces_csr``'s; ``dirt_tpu``'s function also takes a
    static chunk bound, which the kernel here does not need. Returns
    [num_faces, K] f32.
    """
    device = fid.device
    if device.type == "cpu":
        return scatter_to_faces_csr_plain(cot_cf, fid, num_faces)
    if device.type != "cuda":
        raise ValueError(
            f"scatter_to_faces_csr: no kernel for device {device}")
    need_boxes("scatter_to_faces_csr", bbox, cull)
    return _launch_csr(cot_cf, fid, entry_face, start_block, counts,
                       num_faces, tile_h, tile_w, bbox, cull)


def scatter_to_faces_csr_plain(cot_cf, fid, num_faces: int):
    """Plain PyTorch version of the streaming scatter kernel (any device).

    A face's row sums the pixels it owns whichever lists name it, so this
    is :func:`scatter_to_faces_plain` cut to the faces' rows.
    """
    return scatter_to_faces_plain(cot_cf, fid, num_faces + 1)[:num_faces]


@functools.cache
def _csr_fn():
    fn = _build.load(_CSR).dirt_scatter_faces_csr
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    return fn


def _launch_csr(cot_cf, fid, entry_face, start_block, counts, num_faces,
                tile_h, tile_w, bbox, cull):
    device = fid.device
    k_cols, hp, wp, total = _check_image(cot_cf, fid, bbox, cull, num_faces,
                                         tile_h, tile_w)
    if entry_face.ndim != 1 or entry_face.shape[0] % CHUNK:
        raise ValueError(f"entry_face {tuple(entry_face.shape)} is not a "
                         f"CHUNK-padded CSR array")
    n_pad = entry_face.shape[0]
    check_tensor("entry_face", entry_face, torch.int32, (n_pad,), device)
    check_tensor("start_block", start_block, torch.int32, (total,), device)
    check_tensor("counts", counts, torch.int32, (total,), device)

    # Pass 2 writes every row of ``out``; ``partial`` holds one row per CSR
    # slot, of which pass 2 reads only the live entries', which pass 1 wrote.
    out = torch.empty((num_faces, k_cols), dtype=torch.float32,
                      device=device)
    partial = torch.empty((n_pad, k_cols), dtype=torch.float32,
                          device=device)
    fn = _csr_fn()
    with on_device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            entry_face.data_ptr(), start_block.data_ptr(),
            counts.data_ptr(), bbox.data_ptr(), cull.data_ptr(),
            fid.data_ptr(), cot_cf.data_ptr(), partial.data_ptr(),
            out.data_ptr(), k_cols,
            hp, wp, tile_h, tile_w, n_pad, num_faces, num_faces, stream,
        )
    if err != 0:
        raise RuntimeError(f"{_CSR} launch failed: CUDA error {err}")
    trace.count(f"launch.{_CSR}")
    return out
