"""Backward of the packed-subtile engine: prologue, entry rows, reduce.

Counterpart of ``dirt_tpu/ops/packed_bwd.py``. The backward runs over the
same packed bins the forward used (``binning.bin_faces_packed``) and the
forward's face table (``bins.table``), which it reads through the bins'
entries as the forward kernel does:

1. :func:`prepare_backward_packed` runs the neighbor prologue
   (:func:`padded_prologue`, kernel K3) over the unpadded image-space
   fields: in one pass it pads them to whole tiles and computes the four
   boundary pair & front tests as one int32 bit plane and the four
   per-direction ``sval`` planes (the dense and the streaming backwards
   call it too);
2. :func:`packed_entry_rows` (kernel K2) sums, for every budget row (one
   face on one 8x16 subtile), ``pixel_cotangents_core`` over the subtile
   pixels that row owns, into per-entry rows ``[budget_rows, 12 + 3C]``
   (9 edge, 3 denominator, 3C attribute columns);
3. :func:`backward_packed` reduces the entry rows onto faces
   (:func:`pool_reduce_rows` through the binning's pool backpointers, or
   an ``index_add_`` over ``entries // 8``) and adds the anchor terms.

Both kernels are hand-written CUDA (``csrc/packed_prologue.cu``,
``csrc/packed_bwd.cu``). The prologue writes image layout and the backward
kernel reads it; on the halo path (``nbrs`` given) the fields are padded
by :func:`pad_fields`, and the five per-pixel fields go through the layout
swap (``raster_fwd.flat_subtile_swap``, kernel
``csrc/subtile_swap.cu``) and the backward kernel reads flat-subtile
layout, as the reference's halo path does. The 3-pass bf16 one-hot matmuls
that moved values through the TPU's matrix unit become direct reads of the
owning row. Each kernel has a plain
PyTorch version in this module with the same operations in the same
order; a CPU tensor takes it, a CUDA tensor launches the kernel or
raises, any other device raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dirt_tpu_torch.ops import _build, raster_fwd
from dirt_tpu_torch.ops.binning import (
    GROUPS,
    PACK_CHUNK,
    PACK_ITERS,
    POOL_ALIGN,
    SUB_H,
    SUB_W,
)
from dirt_tpu_torch.ops.raster_bwd import (
    GEO_DEN,
    GEO_EDGE,
    _shift,
    assemble_face_gradients,
    boundary_cases,
    pixel_cotangents_core,
)
from dirt_tpu_torch.ops.raster_fwd import (
    BIG_Z,
    COL_ATT,
    _check_geometry,
    _to_jobs,
    check_meta,
    check_table,
    check_tensor,
    pack_face_table_v2,
)
from dirt_tpu_torch.ops.triangle_setup import GEO_USED
from dirt_tpu_torch.utils import trace


# The most cotangent columns one launch of packed_bwd stages: 12 + 3C up to
# C = 14 in one launch, more in further launches over the same owners (the
# first version of the kernel, a block of 1,024 threads, held no more in an
# H100's shared memory; no path of the repository runs more channels, and
# the split keeps the column groups in use at C = 16).
_BWD_COLUMNS = 54
# A block of packed_bwd: its threads, and its static shared memory (ids and
# masks) in bytes.
_BWD_THREADS = SUB_H * SUB_W
_BWD_STATIC_SMEM = 128 * 20

_PROLOGUE = "packed_prologue"
_BWD = "packed_bwd"


def columns_per_pass(device=None) -> int:
    """Cotangent columns one launch of the backward kernel stages on
    ``device`` (default: the current CUDA device): 54 (14 channels), or
    fewer where the card's opt-in shared memory per block holds fewer. More
    columns run as further launches over the same owners, one per group of
    this many columns."""
    smem = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    return min(_BWD_COLUMNS, (smem - _BWD_STATIC_SMEM) // (4 * _BWD_THREADS))


# --- K3: the neighbor prologue ------------------------------------------


def combine_bits(fid_p, zbuf_p, nfid4, nz4):
    """[Hp, Wp] int32: bit n = boundary_cases()[n]'s pair & front test."""
    bits = torch.zeros(fid_p.shape, dtype=torch.int32, device=fid_p.device)
    for n, (_, _, _, strict) in enumerate(boundary_cases()):
        pair = (fid_p != nfid4[n]) & (nfid4[n] != -2)
        front = (zbuf_p < nz4[n]) if strict else (zbuf_p <= nz4[n])
        bits = bits | ((pair & front).to(torch.int32) << n)
    return bits


def pad_fields(fid, zbuf, pixels, grad_pixels, tile_h: int, tile_w: int):
    """The image-space fields padded to whole tiles: (fid_p [Hp, Wp] int32,
    zbuf_p [Hp, Wp] f32, pix_cf [C, Hp, Wp] f32, grad_cf [C, Hp, Wp] f32),
    padded with -2, BIG_Z, 0 and 0 (padding pixels own nothing and pair
    with nothing)."""
    height, width = fid.shape
    hp = -(-height // tile_h) * tile_h
    wp = -(-width // tile_w) * tile_w
    pad2 = (0, wp - width, 0, hp - height)
    pad = torch.nn.functional.pad
    fid_p = pad(fid.to(torch.int32), pad2, value=-2).contiguous()
    zbuf_p = pad(zbuf, pad2, value=BIG_Z).contiguous()
    pix_cf = pad(pixels.permute(2, 0, 1), pad2).contiguous()
    grad_cf = pad(grad_pixels.to(torch.float32).permute(2, 0, 1),
                  pad2).contiguous()
    return fid_p, zbuf_p, pix_cf, grad_cf


def padded_prologue(fid, zbuf, pixels, grad_pixels, tile_h: int,
                    tile_w: int):
    """The backward's padded fields and the boundary-pair inputs, in one
    pass over the unpadded image.

    Args:
        fid: [H, W] int32 face ids (-1 background).
        zbuf: [H, W] f32 depths.
        pixels, grad_pixels: [H, W, C] f32 (any other dtype of the gradient
            is converted first).
    Any strides: the kernel reads the four fields through them (the
    forward's pixels are a permuted, cropped view of its [C, Hp, Wp]
    output), so nothing is padded or copied before it.
    Returns:
        (fid_p [Hp, Wp] int32 padded with -2, bits [Hp, Wp] int32, sval
        [4, Hp, Wp] f32, pix_cf and grad_cf [C, Hp, Wp] f32 padded with 0):
        :func:`pad_fields` followed by :func:`fused_neighbor_prologue_plain`
        on its output (its padded depth is read, never built).
    """
    device = fid.device
    if device.type == "cpu":
        return padded_prologue_plain(fid, zbuf, pixels, grad_pixels, tile_h,
                                     tile_w)
    if device.type != "cuda":
        raise ValueError(f"padded_prologue: no kernel for device {device}")
    height, width = fid.shape
    return _launch_prologue(fid, zbuf, pixels, grad_pixels,
                            -(-height // tile_h) * tile_h,
                            -(-width // tile_w) * tile_w)


def padded_prologue_plain(fid, zbuf, pixels, grad_pixels, tile_h: int,
                          tile_w: int):
    """Plain PyTorch version of :func:`padded_prologue` (any device)."""
    fid_p, zbuf_p, pix_cf, grad_cf = pad_fields(fid, zbuf, pixels,
                                                grad_pixels, tile_h, tile_w)
    bits, sval = fused_neighbor_prologue_plain(fid_p, zbuf_p, pix_cf,
                                               grad_cf)
    return fid_p, bits, sval, pix_cf, grad_cf


def fused_neighbor_prologue_plain(fid_p, zbuf_p, pix_cf, grad_cf):
    """Boundary-pair bit plane and per-direction sval of padded fields, in
    image layout: the prologue kernel's arithmetic in plain PyTorch (any
    device).

    Args:
        fid_p: [Hp, Wp] int32 (padding = -2).
        zbuf_p: [Hp, Wp] f32 (padding = BIG_Z).
        pix_cf, grad_cf: [C, Hp, Wp] f32 (padding = 0).
    Returns:
        (bits [Hp, Wp] int32 — bit n is ``boundary_cases()[n]``'s
        ``pair & front`` with pair = (fid != nfid) & (nfid != -2);
        sval [4, Hp, Wp] f32 — ``0.5 * sum_c (g + g_n)(p - p_n)``).
        Out-of-image neighbors get fid -2, z BIG_Z and pix/grad 0.
    The shifts of ``raster_bwd.neighbor_maps``, with sval summed over
    channels one at a time in channel order, as the kernel does.
    """
    nfid4, nz4, svals = [], [], []
    for axis, offset, _, _ in boundary_cases():
        nfid4.append(_shift(fid_p, axis, offset, -2))
        nz4.append(_shift(zbuf_p, axis, offset, BIG_Z))
        npix = _shift(pix_cf, axis + 1, offset, 0.0)
        ngrad = _shift(grad_cf, axis + 1, offset, 0.0)
        sval = torch.zeros_like(zbuf_p)
        for c in range(pix_cf.shape[0]):
            sval = sval + (grad_cf[c] + ngrad[c]) * (pix_cf[c] - npix[c])
        svals.append(0.5 * sval)
    return combine_bits(fid_p, zbuf_p, nfid4, nz4), torch.stack(svals)


@functools.cache
def _prologue_fn():
    fn = _build.load(_PROLOGUE).dirt_packed_prologue
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
                   + [ctypes.c_void_p] * 6)
    return fn


def _launch_prologue(fid, zbuf, pixels, grad, hp: int, wp: int):
    """(fid_p, bits, sval, pix_cf, grad_cf) from one launch over the
    [H, W] fields (``pixels`` and ``grad`` [H, W, C]) at any strides."""
    device = fid.device
    height, width = fid.shape
    channels = pixels.shape[-1]
    # As pad_fields converts them; a no-op (no copy) on the forward's fid
    # and a float32 gradient.
    fid = fid.to(torch.int32)
    grad = grad.to(torch.float32)
    for name, arr, dtype, shape in (
            ("fid", fid, torch.int32, (height, width)),
            ("zbuf", zbuf, torch.float32, (height, width)),
            ("pixels", pixels, torch.float32, (height, width, channels)),
            ("grad_pixels", grad, torch.float32, (height, width, channels))):
        if (arr.device != device or arr.dtype != dtype
                or tuple(arr.shape) != shape):
            raise ValueError(f"{name}: want {dtype} {shape} on {device}, "
                             f"got {arr.dtype} {tuple(arr.shape)} on "
                             f"{arr.device}")
    if height > hp or width > wp:
        raise ValueError(f"padded image {hp}x{wp} does not hold "
                         f"{height}x{width}")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    fid_p = empty(hp, wp, dtype=torch.int32)
    bits = empty(hp, wp, dtype=torch.int32)
    sval = empty(4, hp, wp)
    pix_cf = empty(channels, hp, wp)
    grad_cf = empty(channels, hp, wp)
    fn = _prologue_fn()
    with raster_fwd.on_device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in (fid, zbuf, pixels, grad)),
                 *fid.stride(), *zbuf.stride(), *pixels.stride(),
                 *grad.stride(), height, width, channels, hp, wp,
                 *(t.data_ptr() for t in (fid_p, bits, sval, pix_cf, grad_cf)),
                 stream)
    if err == -1:
        raise ValueError(f"{_PROLOGUE}: an offset of the {height}x{width} "
                         f"fields or of the padded {hp}x{wp} planes does "
                         "not fit in 32 bits")
    if err != 0:
        raise RuntimeError(f"{_PROLOGUE} launch failed: CUDA error {err}")
    trace.count(f"launch.{_PROLOGUE}")
    return fid_p, bits, sval, pix_cf, grad_cf


# --- preparation ----------------------------------------------------------


class _PackedBwdPrep:
    """Prepared inputs for :func:`packed_entry_rows` (plain container).

    Image-space fields are tile-padded: ``fid_p`` [Hp, Wp] int32, ``bits``
    [Hp, Wp] int32, ``sval`` [4, Hp, Wp], ``pix_cf`` / ``grad_cf``
    [C, Hp, Wp]; all five in image layout, or with ``flat`` all five in
    flat-subtile layout (``raster_fwd.flat_subtile_swap``).
    """

    def __init__(self, fid_p, bits, sval, pix_cf, grad_cf, bins, geo, att,
                 channels, k_cols, tile_h, tile_w, flat=False):
        self.fid_p, self.bits, self.sval = fid_p, bits, sval
        self.pix_cf, self.grad_cf = pix_cf, grad_cf
        self.flat = flat
        self.bins = bins
        self.geo, self.att = geo, att
        self.channels, self.k_cols = channels, k_cols
        self.tile_h, self.tile_w = tile_h, tile_w

    @property
    def budget_chunks(self) -> int:
        return self.bins.entries.shape[0] // PACK_CHUNK


def prepare_backward_packed(geo, att, fid, zbuf, pixels, grad_pixels, bins,
                            tile_h: int, tile_w: int, nbrs=None):
    """Pad the image-space fields and build the boundary-pair inputs.

    fid pads with -2, zbuf with BIG_Z, pixels and grad with 0 (padding
    pixels own nothing and pair with nothing). With ``nbrs`` None one
    launch of the prologue kernel (:func:`padded_prologue`) writes the
    padded fields, the bit plane and sval; otherwise ``nbrs`` is a
    precomputed ``(nfid4, nz4, sval4)`` of shape [4, Hp, Wp] each (in
    ``boundary_cases`` order, at the padded shape; the sharded halo path
    splices neighbor rows into it), the fields are padded by
    :func:`pad_fields` and the maps combined into bits here; the five
    fields then go to flat-subtile layout in one pass of the swap kernel
    (``prep.flat``), as in the reference's halo path.
    """
    geo = torch.as_tensor(geo, dtype=torch.float32)
    att = torch.as_tensor(att, dtype=torch.float32)
    channels = pixels.shape[-1]
    if nbrs is None:
        fid_p, bits, sval, pix_cf, grad_cf = padded_prologue(
            fid, zbuf, pixels, grad_pixels, tile_h, tile_w)
    else:
        fid_p, zbuf_p, pix_cf, grad_cf = pad_fields(
            fid, zbuf, pixels, grad_pixels, tile_h, tile_w)
        nfid4, nz4, sval4 = nbrs
        bits = combine_bits(fid_p, zbuf_p, nfid4.to(torch.int32), nz4)
        sval = torch.as_tensor(sval4, dtype=torch.float32)
        fid_p, bits, pix_cf, grad_cf, sval = raster_fwd.flat_subtile_swap(
            [fid_p, bits, pix_cf, grad_cf, sval])
    return _PackedBwdPrep(
        fid_p, bits, sval, pix_cf, grad_cf, bins, geo, att,
        channels, 12 + 3 * channels, tile_h, tile_w, flat=nbrs is not None,
    )


def _entry_table(prep):
    """The face table the entries index: ``bins.table`` (the forward's),
    or the same table built anew from the planes."""
    if prep.bins.table is not None:
        return prep.bins.table
    table2 = pack_face_table_v2(prep.geo, prep.att)
    col_one = COL_ATT + 3 * prep.channels
    if col_one < table2.shape[1]:
        table2[:, col_one].fill_(1.0)
    return table2


# --- K2: per-entry cotangent rows -------------------------------------------


def packed_entry_rows(prep: _PackedBwdPrep, c_lo: int = 0,
                      c_hi: int | None = None):
    """Per-entry cotangent rows for the budget chunks [c_lo, c_hi).

    Returns ``[(c_hi - c_lo) * PACK_CHUNK, 12 + 3C]`` f32: row r holds the
    sum of the cotangents of the pixels budget row ``c_lo * PACK_CHUNK + r``
    owns, and zero where it owns none (padding, rows past a tile's
    ``n_iters``, empty chunks). A pixel is owned by the one row of its own
    (strip, lane group) run whose face is the pixel's fid. Chunks carry no
    state across each other, so slices compose exactly (the gradient
    overlap path runs one slice per band).
    """
    budget_chunks = prep.budget_chunks
    if c_hi is None:
        c_hi = budget_chunks
    if not 0 <= c_lo <= c_hi <= budget_chunks:
        raise ValueError(f"chunk slice [{c_lo}, {c_hi}) outside "
                         f"[0, {budget_chunks}]")
    table = _entry_table(prep)
    raster_fwd.check_table_rows(
        table, prep.bins, None if prep.geo is None else prep.geo.shape[0])
    device = prep.fid_p.device
    if device.type == "cpu":
        return packed_entry_rows_plain(prep, table, c_lo, c_hi)
    if device.type != "cuda":
        raise ValueError(f"packed_entry_rows: no kernel for device {device}")
    return _launch_bwd(prep, table, c_lo, c_hi)


def packed_entry_rows_plain(prep: _PackedBwdPrep, table, c_lo: int,
                            c_hi: int):
    """Plain PyTorch version of the backward kernel (any device).

    Like the kernel: (1) every pixel finds its owning row by walking its
    (strip, group) run in ascending order and taking the first row whose
    face (``entries >> 3``) is its fid; (2) the owner's geometry columns,
    read from ``table`` at the owner's face, give the pixel's cotangents
    through ``pixel_cotangents_core``; (3) each row sums its pixels in the
    subtile's pixel order (row-major over 8 x 16), one pixel position per
    ``index_add_`` step, so every sum is accumulated in the kernel's order.
    Fields in flat-subtile layout are first brought back to image layout
    (the swap is its own inverse).
    """
    face_of = prep.bins.entries.long() >> 3
    owner = _owners_plain(prep, face_of, c_lo, c_hi)
    geo = table[:, :GEO_USED][face_of[torch.clamp(owner, min=0)]]
    return _owned_sums_plain(prep, owner, geo, c_lo, c_hi)


def _job_fields(prep):
    """The five per-pixel fields in image layout, then in job layout
    [.., T, S, G, 8, 16]."""
    tiles_y = prep.pix_cf.shape[1] // prep.tile_h
    tiles_x = prep.pix_cf.shape[2] // prep.tile_w
    fields = (prep.fid_p, prep.bits, prep.sval, prep.pix_cf, prep.grad_cf)
    if prep.flat:
        fields = [raster_fwd.flat_subtile_swap_plain(x) for x in fields]
    return [_to_jobs(x, tiles_y, tiles_x, prep.tile_h // SUB_H)
            for x in fields]


def _owners_plain(prep, ids, c_lo: int, c_hi: int):
    """[T, S, G, 8, 16] int64: each pixel's owning budget row, the first of
    its (strip, group) run, clamped to the tile's ``n_iters`` and to the
    chunk slice, whose ``ids`` entry equals the pixel's fid (compared in
    ``ids``' dtype); -1 where none does."""
    tile_h, tile_w = prep.tile_h, prep.tile_w
    _, hp, wp = _check_geometry(prep.pix_cf, tile_h, tile_w)
    device = prep.fid_p.device
    strips = tile_h // SUB_H
    total = (hp // tile_h) * (wp // tile_w)
    # Per (tile, strip): the live iterations [lo, hi), clamped to the
    # tile's n_iters and to the chunk slice, as [T, S, 1].
    bins = prep.bins
    sb = bins.start_block.long()[:, None, None]
    lo = bins.iter_off.long().reshape(total, strips, 1)
    hi = torch.minimum(
        lo + bins.strip_iters.long().reshape(total, strips, 1),
        bins.n_iters.long()[:, None, None],
    )
    lo = torch.maximum(lo, (c_lo - sb) * PACK_ITERS)
    hi = torch.minimum(hi, (c_hi - sb) * PACK_ITERS)
    row0 = sb * PACK_ITERS
    g = torch.arange(GROUPS, dtype=torch.int64, device=device)
    fid = _job_fields(prep)[0].to(ids.dtype)             # [T, S, G, 8, 16]
    owner = torch.full(fid.shape, -1, dtype=torch.int64, device=device)
    n_steps = int(torch.clamp(hi - lo, min=0).max()) if total else 0
    for k in range(n_steps):
        it = lo + k
        live = it < hi                                   # [T, S, 1]
        row = torch.where(live, (row0 + it) * GROUPS + g, 0)  # [T, S, G]
        hit = ((ids[row][..., None, None] == fid) & live[..., None, None]
               & (owner < 0))
        owner = torch.where(hit, row[..., None, None], owner)
    return owner


def _owned_sums_plain(prep, owner, geo, c_lo: int, c_hi: int):
    """The rows of the chunk slice [c_lo, c_hi): each pixel with an owner
    (``owner`` >= 0) adds the cotangents of ``geo`` (its owner's 17
    geometry columns, [T, S, G, 8, 16, 17]) to its owner's row, one pixel
    position of the subtile's row-major order at a time."""
    tile_h, tile_w = prep.tile_h, prep.tile_w
    _, hp, wp = prep.pix_cf.shape
    device = owner.device
    tiles_x = wp // tile_w
    strips = tile_h // SUB_H
    total = (hp // tile_h) * tiles_x

    def arange(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    fid, bits, sval, pix, grad = _job_fields(prep)
    covered = owner >= 0
    t = arange(total)[:, None, None, None, None]
    s = arange(strips)[None, :, None, None, None]
    g = arange(GROUPS)[None, None, :, None, None]
    xg = ((t % tiles_x) * tile_w + g * SUB_W
          + arange(SUB_W)).to(torch.float32) + 0.5
    yg = ((t // tiles_x) * tile_h + s * SUB_H
          + arange(SUB_H)[:, None]).to(torch.float32) + 0.5
    xg, yg = torch.broadcast_tensors(xg, yg, fid)[:2]
    nbrs = [(((bits >> n) & 1) > 0, sval[n]) for n in range(4)]
    d_geo, d_att = pixel_cotangents_core(
        [geo[..., q] for q in range(GEO_USED)], covered, None, None,
        pix, grad, nbrs, xg, yg,
    )
    cot = torch.stack(
        [d_geo[GEO_EDGE + q] for q in range(9)]
        + [d_geo[GEO_DEN + q] for q in range(3)] + d_att, dim=-1
    )                                                    # [..., 8, 16, K]

    n_out = (c_hi - c_lo) * PACK_CHUNK
    dest = torch.where(covered, owner - c_lo * PACK_CHUNK, n_out)
    dest = dest.reshape(-1, SUB_H * SUB_W)
    cot = cot.reshape(-1, SUB_H * SUB_W, prep.k_cols)
    out = torch.zeros((n_out + 1, prep.k_cols), dtype=torch.float32,
                      device=device)
    for p in range(SUB_H * SUB_W):
        out.index_add_(0, dest[:, p], cot[:, p])
    return out[:n_out]


@functools.cache
def _bwd_fn():
    fn = _build.load(_BWD).dirt_packed_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 11
        + [ctypes.c_int] * 8
        + [ctypes.c_void_p]
    )
    return fn


def _launch_bwd(prep, table, c_lo, c_hi):
    channels, tile_h = prep.channels, prep.tile_h
    _, hp, wp = _check_geometry(prep.pix_cf, tile_h, prep.tile_w)
    device = prep.fid_p.device
    if channels < 1:
        raise ValueError(f"packed_bwd kernel needs at least one channel, "
                         f"got {channels}")
    bins = prep.bins
    check_meta(bins, (hp // tile_h) * (wp // prep.tile_w), tile_h // SUB_H,
               device)
    check_table(table, bins, channels, device)
    for name, arr, dtype, lead in (
        ("fid_p", prep.fid_p, torch.int32, ()),
        ("bits", prep.bits, torch.int32, ()),
        ("sval", prep.sval, torch.float32, (4,)),
        ("pix_cf", prep.pix_cf, torch.float32, (channels,)),
        ("grad_cf", prep.grad_cf, torch.float32, (channels,)),
    ):
        check_tensor(name, arr, dtype, (*lead, hp, wp), device)

    # Rows no (tile, strip) run reaches stay zero.
    out = torch.zeros(((c_hi - c_lo) * PACK_CHUNK, prep.k_cols),
                      dtype=torch.float32, device=device)
    fn = _bwd_fn()
    with raster_fwd.on_device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            table.data_ptr(), table.shape[1], bins.entries.data_ptr(),
            bins.start_block.data_ptr(), bins.n_iters.data_ptr(),
            bins.iter_off.data_ptr(), bins.strip_iters.data_ptr(),
            prep.fid_p.data_ptr(), prep.bits.data_ptr(),
            prep.sval.data_ptr(), prep.pix_cf.data_ptr(),
            prep.grad_cf.data_ptr(), out.data_ptr(),
            channels, hp, wp, tile_h, c_lo, c_hi, columns_per_pass(device),
            int(prep.flat), stream,
        )
    if err != 0:
        raise RuntimeError(f"{_BWD} launch failed: CUDA error {err}")
    trace.count(f"launch.{_BWD}")
    return out


# --- reduction to faces -------------------------------------------------------


def pool_reduce_rows(entry_rows, pair_rows, pool_offs, num_faces: int,
                     bmax: int, row_base: int = 0):
    """Reduce per-entry cotangent rows to faces via the pool backpointers.

    ``entry_rows`` may be a slice of the budget rows starting at global
    row ``row_base``; backpointers outside it, the sentinel
    (``budget_rows``) included, contribute zero through a clipped gather
    and a mask. Pool slots sum in POOL_ALIGN-slot blocks, and each face
    sums its <= ``bmax`` blocks.
    """
    k_cols = entry_rows.shape[1]
    nrows = entry_rows.shape[0]
    idx = pair_rows.long() - row_base
    valid = (idx >= 0) & (idx < nrows)
    pool_rows = entry_rows[torch.clamp(idx, 0, max(nrows - 1, 0))]
    # In place: a second pool-sized array would set the step's peak.
    pool_rows.masked_fill_(~valid[:, None], 0.0)
    nblk = pool_rows.shape[0] // POOL_ALIGN
    blk = pool_rows.reshape(nblk, POOL_ALIGN, k_cols).sum(dim=1)
    blk = torch.cat([blk, blk.new_zeros((1, k_cols))])
    offs = pool_offs.long()
    bidx = offs[:num_faces, None] + torch.arange(
        bmax, dtype=torch.int64, device=offs.device
    )[None, :]
    mask = (bidx < offs[1:num_faces + 1, None]) & (bidx < nblk)
    take = torch.where(mask, bidx, nblk)
    return blk[take.reshape(-1)].reshape(num_faces, bmax, k_cols).sum(dim=1)


def backward_packed(geo, att, fid, zbuf, pixels, grad_pixels, bins,
                    num_faces: int, tile_h: int, tile_w: int, nbrs=None,
                    bmax: int | None = None):
    """Gradients w.r.t. plane coefficients over packed bins.

    Same semantics as ``raster_bwd.backward_torch`` (exact interior +
    occlusion-aware boundary); returns (d_geo [F, 24], d_att [F, 3C],
    d_background [H, W, C]). ``nbrs`` optionally overrides the boundary
    neighbor maps (see :func:`prepare_backward_packed`). The reduce goes
    through the pool backpointers when the binning kept them
    (``bins.pair_rows``) and ``bmax`` (the forward's
    ``ceil(expand_cap / POOL_ALIGN)``) is given, else through an
    ``index_add_`` over the entries' faces.
    """
    prep = prepare_backward_packed(
        geo, att, fid, zbuf, pixels, grad_pixels, bins, tile_h, tile_w,
        nbrs=nbrs,
    )
    entry_rows = packed_entry_rows(prep)
    if bins.pair_rows is not None and bmax is not None:
        face_rows = pool_reduce_rows(
            entry_rows, bins.pair_rows, bins.pool_offs, num_faces, bmax
        )
    else:
        face_rows = torch.zeros((num_faces + 1, prep.k_cols),
                                dtype=torch.float32, device=entry_rows.device)
        face_rows.index_add_(0, bins.entries.long() // 8, entry_rows)
        face_rows = face_rows[:num_faces]
    d_geo, d_att = assemble_face_gradients(
        prep.geo, prep.att, face_rows, prep.channels
    )
    d_background = torch.where((fid >= 0)[..., None], 0.0, grad_pixels)
    return d_geo, d_att, d_background
