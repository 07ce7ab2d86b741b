"""Fused backward: per-pixel cotangents summed onto the owning faces.

Counterpart of ``dirt_tpu/ops/fused_bwd.py``: ``_fused_kernel`` /
``fused_backward_rows`` over the dense engine's bins and
``_fused_csr_kernel`` / ``fused_backward_rows_csr`` over the streaming
engine's CSR runs. One call turns the forward's outputs and the upstream
gradient into per-face cotangent rows ``[12 + 3C]`` (9 edge, 3 denominator,
3C attribute columns): ``raster_bwd.pixel_cotangents_core`` on every covered
pixel, summed over the pixels each face owns.

* CUDA tensors launch the hand-written kernels ``csrc/fused_bwd.cu`` (a
  warp per live slot of a tile's list) and ``csrc/fused_bwd_csr.cu`` (a
  block per 64 CSR rows whose warps take the live ones); both sum in
  registers (``csrc/fused_rows.cuh``), then reduce onto faces with
  ``csrc/scatter_rows.cuh``'s second pass: they
  read each owner's geometry row directly (the TPU kernels' ``binned17``
  pre-gather and one-hot matrix products have no counterpart) and reduce
  without atomics, in a fixed order, through per-list-entry partial rows,
  so two runs give equal bits. A list entry's row sums the pixels of the
  face's cull box (the forward's, ``raster.DenseBins.cull``) inside the
  tile; the tiles of a face's binning box (``bbox``) are the ones whose
  lists name it.
* CPU tensors take :func:`fused_backward_rows_plain` /
  :func:`fused_backward_rows_csr_plain`.

The boundary-pair inputs are the packed backward's bit plane and ``sval``
planes (``packed_bwd.padded_prologue``), not the ``nfid4`` /
``nz4`` / ``sval4`` maps of the JAX function: the cotangent core takes
either form and the bits are what the prologue kernel makes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dirt_tpu_torch.ops import _build
from dirt_tpu_torch.ops.binning import CHUNK
from dirt_tpu_torch.ops.raster_bwd import (
    GEO_DEN,
    GEO_EDGE,
    pixel_cotangents_core,
    pixel_grid,
)
from dirt_tpu_torch.ops.raster_fwd import check_boxes, check_tensor, need_boxes
from dirt_tpu_torch.ops.triangle_setup import GEO_USED

# Launches of the CUDA kernel in this process: the wrapper adds one where it
# launches, and nowhere else.
LAUNCHES = 0
LAUNCHES_CSR = 0

_KERNEL = "fused_bwd"
_CSR = "fused_bwd_csr"


def fused_backward_rows(geo, bins, counts, fid, bits, sval, pix_cf, grad_cf,
                        num_rows: int, *, tile_h: int, tile_w: int,
                        bbox=None, cull=None):
    """Per-face cotangent rows [12 + 3C columns] for the dense path.

    Args:
        geo: [F, >= 17] f32 anchored plane data (``setup_planes``).
        bins: [T, cap] int32 ascending face ids per tile (sentinel F);
            counts: [T] int32. The forward's bins: every covered pixel's
            fid is in its tile's list.
        fid: [Hp, Wp] int32, padded to whole tiles with -2 (padding neither
            owns cotangents nor forms boundary pairs).
        bits: [Hp, Wp] int32 and sval: [4, Hp, Wp] f32 from
            ``packed_bwd.padded_prologue``, which pads the fields too.
        pix_cf, grad_cf: [C, Hp, Wp] f32.
        num_rows: F + 1 (sentinel row included).
        bbox: [F, 4] int32 (xmin, xmax, ymin, ymax), the boxes the bins
            were made from (``raster.DenseBins.bbox``): the kernel sums a
            face's rows over the tiles of its box.
        cull: [>= F, 4] int32, the forward's cull boxes of the faces
            (``raster.DenseBins.cull``): the kernel scans a face's cull
            box, not its whole tiles; every pixel the face can own lies
            inside it. CUDA tensors need both; the plain version reads
            neither.
    Returns:
        [num_rows padded to 8, 12 + 3C] f32; callers slice [:num_faces].
    """
    device = fid.device
    if device.type == "cpu":
        return fused_backward_rows_plain(geo, fid, bits, sval, pix_cf,
                                         grad_cf, num_rows)
    if device.type != "cuda":
        raise ValueError(f"fused_backward_rows: no kernel for device {device}")
    need_boxes("fused_backward_rows", bbox, cull)
    return _launch(geo, bins, counts, fid, bits, sval, pix_cf, grad_cf,
                   num_rows, tile_h, tile_w, bbox, cull)


def fused_backward_rows_plain(geo, fid, bits, sval, pix_cf, grad_cf,
                              num_rows: int):
    """Plain PyTorch version of the fused kernel (any device).

    The owner's geometry row per pixel by direct indexing, the cotangent
    core over the whole image (:func:`pixel_rows_plain`), and one
    ``index_add_`` onto the owning faces, accumulated in float64 and rounded
    once (the kernel sums float32 in its own fixed order, so the two agree
    to rounding).
    """
    cot = pixel_rows_plain(geo, fid, bits, sval, pix_cf, grad_cf)
    rows_padded = -(-num_rows // 8) * 8
    out = torch.zeros((rows_padded, cot.shape[1]), dtype=torch.float64,
                      device=fid.device)
    out.index_add_(0, torch.clamp(fid, min=0).long().reshape(-1),
                   cot.to(torch.float64))
    return out.to(torch.float32)


def pixel_rows_plain(geo, fid, bits, sval, pix_cf, grad_cf):
    """The per-pixel cotangent rows the fused kernels sum onto faces: [Hp *
    Wp, 12 + 3C] f32, zero where no face owns the pixel."""
    channels, hp, wp = pix_cf.shape
    covered = fid >= 0
    owner = torch.clamp(fid, min=0).long()
    g = geo[:, :GEO_USED][owner]                             # [Hp, Wp, 17]
    xg, yg = pixel_grid(hp, wp, fid.device)
    nbrs = [(((bits >> n) & 1) > 0, sval[n]) for n in range(4)]
    d_geo, d_att = pixel_cotangents_core(
        [g[..., q] for q in range(GEO_USED)], covered, None, None,
        pix_cf, grad_cf, nbrs, xg, yg,
    )
    cot = torch.stack(
        [d_geo[GEO_EDGE + q] for q in range(9)]
        + [d_geo[GEO_DEN + q] for q in range(3)] + d_att, dim=-1
    )                                                        # [Hp, Wp, K]
    cot = torch.where(covered[..., None], cot, 0.0)
    return cot.reshape(-1, 12 + 3 * channels)


def _check_fields(geo, bbox, cull, fid, bits, sval, pix_cf, grad_cf,
                  num_faces):
    """The per-face and image-space tensors both fused kernels read."""
    device = fid.device
    channels, hp, wp = pix_cf.shape
    if geo.ndim != 2 or geo.shape[0] < num_faces or geo.shape[1] < GEO_USED:
        raise ValueError(f"geo: want [>= {num_faces}, >= {GEO_USED}], got "
                         f"{tuple(geo.shape)}")
    check_tensor("geo", geo, torch.float32, geo.shape, device)
    check_boxes(bbox, cull, num_faces, device)
    for name, arr, dtype, lead in (
        ("fid", fid, torch.int32, ()),
        ("bits", bits, torch.int32, ()),
        ("sval", sval, torch.float32, (4,)),
        ("pix_cf", pix_cf, torch.float32, (channels,)),
        ("grad_cf", grad_cf, torch.float32, (channels,)),
    ):
        check_tensor(name, arr, dtype, (*lead, hp, wp), device)


@functools.cache
def _kernel_fn():
    fn = _build.load(_KERNEL).dirt_fused_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 11
        + [ctypes.c_int] * 8
        + [ctypes.c_void_p]
    )
    return fn


def _launch(geo, bins, counts, fid, bits, sval, pix_cf, grad_cf, num_rows,
            tile_h, tile_w, bbox, cull):
    global LAUNCHES
    device = fid.device
    channels, hp, wp = pix_cf.shape
    if hp % tile_h or wp % tile_w:
        raise ValueError(f"image {hp}x{wp} is not padded to {tile_h}x"
                         f"{tile_w} tiles")
    total = (hp // tile_h) * (wp // tile_w)
    num_faces = num_rows - 1
    k_cols = 12 + 3 * channels
    if bins.ndim != 2 or bins.shape[0] != total:
        raise ValueError(f"bins {tuple(bins.shape)} do not match {total} "
                         f"tiles")
    cap = bins.shape[1]
    check_tensor("bins", bins, torch.int32, (total, cap), device)
    check_tensor("counts", counts, torch.int32, (total,), device)
    _check_fields(geo, bbox, cull, fid, bits, sval, pix_cf, grad_cf,
                  num_faces)

    rows_padded = -(-num_rows // 8) * 8
    # The kernel writes every row of ``out``: the first num_faces rows, then
    # zeros for the sentinel and padding rows. ``partial`` needs no clearing:
    # pass 2 reads only the (tile, slot) rows pass 1 wrote.
    out = torch.empty((rows_padded, k_cols), dtype=torch.float32,
                      device=device)
    partial = torch.empty((total * cap, k_cols), dtype=torch.float32,
                          device=device)
    fn = _kernel_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            geo.data_ptr(), geo.shape[1], bins.data_ptr(), counts.data_ptr(),
            bbox.data_ptr(), cull.data_ptr(), fid.data_ptr(), bits.data_ptr(),
            sval.data_ptr(), pix_cf.data_ptr(), grad_cf.data_ptr(),
            partial.data_ptr(), out.data_ptr(),
            channels, hp, wp, tile_h, tile_w, cap, num_faces, rows_padded,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


# --- streaming (CSR) engine --------------------------------------------------


def fused_backward_rows_csr(geo, entry_face, start_block, counts, fid, bits,
                            sval, pix_cf, grad_cf, num_faces: int, *,
                            tile_h: int, tile_w: int, bbox=None, cull=None):
    """Per-face cotangent rows [12 + 3C columns] for the streaming path.

    Where ``dirt_tpu``'s function takes the pre-gathered ``binned17`` rows,
    the ``nfid4`` / ``nz4`` / ``sval4`` maps and a static chunk bound, this
    one takes the geometry table itself and the prologue's bits and
    ``sval``.

    Args:
        geo: [F, >= 17] f32 anchored plane data (``setup_planes``).
        entry_face: [n_pad] int32, start_block, counts: [T] int32, the
            forward's CSR bins (``binning.bin_faces_csr``): every covered
            pixel's fid is in its tile's run.
        fid: [Hp, Wp] int32, padded to whole tiles with -2.
        bits: [Hp, Wp] int32 and sval: [4, Hp, Wp] f32 from
            ``packed_bwd.padded_prologue``, which pads the fields too.
        pix_cf, grad_cf: [C, Hp, Wp] f32.
        bbox: [F, 4] int32 (xmin, xmax, ymin, ymax), the boxes the bins
            were made from, and cull: [>= F, 4] int32, the forward's cull
            boxes (``raster.StreamBins``), as :func:`fused_backward_rows`.
            CUDA tensors need both; the plain version reads neither.
    Returns:
        [num_faces, 12 + 3C] f32.
    """
    device = fid.device
    if device.type == "cpu":
        return fused_backward_rows_csr_plain(geo, fid, bits, sval, pix_cf,
                                             grad_cf, num_faces)
    if device.type != "cuda":
        raise ValueError(
            f"fused_backward_rows_csr: no kernel for device {device}")
    need_boxes("fused_backward_rows_csr", bbox, cull)
    return _launch_csr(geo, entry_face, start_block, counts, fid, bits, sval,
                       pix_cf, grad_cf, num_faces, tile_h, tile_w, bbox, cull)


def fused_backward_rows_csr_plain(geo, fid, bits, sval, pix_cf, grad_cf,
                                  num_faces: int):
    """Plain PyTorch version of the streaming fused kernel (any device).

    A face's row sums the pixels it owns whichever lists name it, so this
    is :func:`fused_backward_rows_plain` cut to the faces' rows.
    """
    return fused_backward_rows_plain(geo, fid, bits, sval, pix_cf, grad_cf,
                                     num_faces + 1)[:num_faces]


@functools.cache
def _csr_fn():
    fn = _build.load(_CSR).dirt_fused_bwd_csr
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 12
        + [ctypes.c_int] * 7
        + [ctypes.c_void_p]
    )
    return fn


def _launch_csr(geo, entry_face, start_block, counts, fid, bits, sval,
                pix_cf, grad_cf, num_faces, tile_h, tile_w, bbox, cull):
    global LAUNCHES_CSR
    device = fid.device
    channels, hp, wp = pix_cf.shape
    if hp % tile_h or wp % tile_w:
        raise ValueError(f"image {hp}x{wp} is not padded to {tile_h}x"
                         f"{tile_w} tiles")
    total = (hp // tile_h) * (wp // tile_w)
    k_cols = 12 + 3 * channels
    if entry_face.ndim != 1 or entry_face.shape[0] % CHUNK:
        raise ValueError(f"entry_face {tuple(entry_face.shape)} is not a "
                         f"CHUNK-padded CSR array")
    n_pad = entry_face.shape[0]
    check_tensor("entry_face", entry_face, torch.int32, (n_pad,), device)
    check_tensor("start_block", start_block, torch.int32, (total,), device)
    check_tensor("counts", counts, torch.int32, (total,), device)
    _check_fields(geo, bbox, cull, fid, bits, sval, pix_cf, grad_cf,
                  num_faces)

    # The kernel writes every row of ``out``. ``partial`` holds one row per
    # CSR slot and needs no clearing: pass 2 reads only the rows of live
    # entries, which pass 1 wrote.
    out = torch.empty((num_faces, k_cols), dtype=torch.float32,
                      device=device)
    partial = torch.empty((n_pad, k_cols), dtype=torch.float32,
                          device=device)
    fn = _csr_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            geo.data_ptr(), geo.shape[1], entry_face.data_ptr(),
            start_block.data_ptr(), counts.data_ptr(), bbox.data_ptr(),
            cull.data_ptr(), fid.data_ptr(), bits.data_ptr(), sval.data_ptr(),
            pix_cf.data_ptr(), grad_cf.data_ptr(), partial.data_ptr(),
            out.data_ptr(), channels, hp, wp, tile_h, tile_w, n_pad,
            num_faces, stream,
        )
    if err != 0:
        raise RuntimeError(f"{_CSR} launch failed: CUDA error {err}")
    LAUNCHES_CSR += 1
    return out
