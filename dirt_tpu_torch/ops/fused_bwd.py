"""Fused dense backward: per-pixel cotangents summed onto the owning faces.

Counterpart of the dense half of ``dirt_tpu/ops/fused_bwd.py``
(``_fused_kernel`` / ``fused_backward_rows``). One call turns the forward's
outputs and the upstream gradient into per-face cotangent rows
``[12 + 3C]`` (9 edge, 3 denominator, 3C attribute columns):
``raster_bwd.pixel_cotangents_core`` on every covered pixel, summed over
the pixels each face owns.

* CUDA tensors launch the hand-written kernel ``csrc/fused_bwd.cu``: it
  reads each owner's geometry row directly (the TPU kernel's ``binned17``
  pre-gather and one-hot matrix products have no counterpart) and reduces
  without atomics, in a fixed order, through per-(tile, slot) partial rows,
  so two runs give equal bits.
* CPU tensors take :func:`fused_backward_rows_plain`.

The boundary-pair inputs are the packed backward's bit plane and ``sval``
planes (``packed_bwd.fused_neighbor_prologue``), not the ``nfid4`` /
``nz4`` / ``sval4`` maps of the JAX function: the cotangent core takes
either form and the bits are what the prologue kernel makes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dirt_tpu_torch.ops import _build
from dirt_tpu_torch.ops.raster_bwd import (
    GEO_DEN,
    GEO_EDGE,
    pixel_cotangents_core,
    pixel_grid,
)
from dirt_tpu_torch.ops.raster_fwd import check_tensor
from dirt_tpu_torch.ops.triangle_setup import GEO_USED

# Launches of the CUDA kernel in this process: the wrapper adds one where it
# launches, and nowhere else.
LAUNCHES = 0

_KERNEL = "fused_bwd"


def fused_backward_rows(geo, bins, counts, fid, bits, sval, pix_cf, grad_cf,
                        num_rows: int, *, tile_h: int, tile_w: int,
                        bbox=None):
    """Per-face cotangent rows [12 + 3C columns] for the dense path.

    Args:
        geo: [F, >= 17] f32 anchored plane data (``setup_planes``).
        bins: [T, cap] int32 ascending face ids per tile (sentinel F);
            counts: [T] int32. The forward's bins: every covered pixel's
            fid is in its tile's list.
        fid: [Hp, Wp] int32, padded to whole tiles with -2 (padding neither
            owns cotangents nor forms boundary pairs).
        bits: [Hp, Wp] int32 and sval: [4, Hp, Wp] f32 from
            ``packed_bwd.fused_neighbor_prologue`` on the padded arrays.
        pix_cf, grad_cf: [C, Hp, Wp] f32.
        num_rows: F + 1 (sentinel row included).
        bbox: [F, 4] int32 (xmin, xmax, ymin, ymax), the boxes the bins
            were made from (``raster.DenseBins.bbox``): the kernel scans a
            face's box, not its whole tiles. CUDA tensors need it; the
            plain version does not read it.
    Returns:
        [num_rows padded to 8, 12 + 3C] f32; callers slice [:num_faces].
    """
    device = fid.device
    if device.type == "cpu":
        return fused_backward_rows_plain(geo, fid, bits, sval, pix_cf,
                                         grad_cf, num_rows)
    if device.type != "cuda":
        raise ValueError(f"fused_backward_rows: no kernel for device {device}")
    if bbox is None:
        raise ValueError("fused_backward_rows: the kernel needs the faces' "
                         "bbox")
    return _launch(geo, bins, counts, fid, bits, sval, pix_cf, grad_cf,
                   num_rows, tile_h, tile_w, bbox)


def fused_backward_rows_plain(geo, fid, bits, sval, pix_cf, grad_cf,
                              num_rows: int):
    """Plain PyTorch version of the fused kernel (any device).

    The owner's geometry row per pixel by direct indexing, the cotangent
    core over the whole image, and one ``index_add_`` onto the owning faces,
    accumulated in float64 and rounded once (the kernel sums float32 in its
    own fixed order, so the two agree to rounding).
    """
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
    k_cols = 12 + 3 * channels
    rows_padded = -(-num_rows // 8) * 8
    out = torch.zeros((rows_padded, k_cols), dtype=torch.float64,
                      device=fid.device)
    out.index_add_(0, owner.reshape(-1),
                   cot.reshape(-1, k_cols).to(torch.float64))
    return out.to(torch.float32)


@functools.cache
def _kernel_fn():
    fn = _build.load(_KERNEL).dirt_fused_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 10
        + [ctypes.c_int] * 7
        + [ctypes.c_void_p]
    )
    return fn


def _launch(geo, bins, counts, fid, bits, sval, pix_cf, grad_cf, num_rows,
            tile_h, tile_w, bbox):
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
    if geo.ndim != 2 or geo.shape[0] < num_faces or geo.shape[1] < GEO_USED:
        raise ValueError(f"geo: want [>= {num_faces}, >= {GEO_USED}], got "
                         f"{tuple(geo.shape)}")
    check_tensor("geo", geo, torch.float32, geo.shape, device)
    check_tensor("bins", bins, torch.int32, (total, cap), device)
    check_tensor("counts", counts, torch.int32, (total,), device)
    check_tensor("bbox", bbox, torch.int32, (num_faces, 4), device)
    for name, arr, dtype, lead in (
        ("fid", fid, torch.int32, ()),
        ("bits", bits, torch.int32, ()),
        ("sval", sval, torch.float32, (4,)),
        ("pix_cf", pix_cf, torch.float32, (channels,)),
        ("grad_cf", grad_cf, torch.float32, (channels,)),
    ):
        check_tensor(name, arr, dtype, (*lead, hp, wp), device)

    rows_padded = -(-num_rows // 8) * 8
    # The kernel writes the first num_faces rows; the sentinel and padding
    # rows stay zero. ``partial`` needs no clearing: pass 2 reads only the
    # (tile, slot) rows pass 1 wrote.
    out = torch.zeros((rows_padded, k_cols), dtype=torch.float32,
                      device=device)
    partial = torch.empty((total * cap, k_cols), dtype=torch.float32,
                          device=device)
    fn = _kernel_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            geo.data_ptr(), geo.shape[1], bins.data_ptr(), counts.data_ptr(),
            bbox.data_ptr(), fid.data_ptr(), bits.data_ptr(),
            sval.data_ptr(), pix_cf.data_ptr(), grad_cf.data_ptr(),
            partial.data_ptr(), out.data_ptr(),
            channels, hp, wp, tile_h, tile_w, cap, num_faces, stream,
        )
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
