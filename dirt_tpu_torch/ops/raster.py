"""The rasterization op: forward pipeline, autograd Function, caps.

Counterpart of ``dirt_tpu/ops/raster.py``. The op takes *screen-space*
face vertex data ``[F, 3, 4]`` (x_s, y_s, z_ndc, 1/w) and per-face vertex
attributes ``[F, 3, C]``; everything upstream (vertex gather, clipping,
clip -> screen transform, camera) is ordinary differentiable PyTorch.

Three engines: the packed engine (setup -> packed binning -> face table
-> ``raster_fwd.raster_forward_packed``; backward
``packed_bwd.backward_packed``), the dense whole-tile engine (setup ->
``binning.bin_faces`` -> ``raster_fwd.raster_forward``; backward
``raster_bwd.backward_fused``) and the streaming (CSR) engine (setup ->
``binning.bin_faces_csr`` -> ``raster_fwd.raster_forward_csr``; backward
``raster_bwd.backward_fused_csr``), all chained through ``setup_planes`` by
autograd; ``RasterConfig``, engine resolution, ``resolve_bin_cap`` and the
count-then-allocate helpers (``suggest_config``, ``count_bins_exact``,
``count_packed_exact``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dirt_tpu_torch import config as cfg
from dirt_tpu_torch.ops import (
    binning,
    packed_bwd,
    raster_bwd,
    raster_fwd,
    scatter,
)
from dirt_tpu_torch.ops.triangle_setup import (
    edge_filter_cols,
    face_bbox_cols,
    face_bboxes,
    setup_planes,
)
from dirt_tpu_torch.utils import trace

class RasterConfig(NamedTuple):
    """Static kernel configuration (same fields as ``dirt_tpu``'s).

    ``engine``: ``"packed"`` (8x16-subtile engine), ``"dense"`` (whole-tile
    engine, faces of any screen size), ``"csr"`` (the streaming engine:
    per-tile CSR runs, any face count) or ``"auto"`` (csr when
    ``streaming`` is True, else packed for >= PACKED_MIN_FACES faces, dense
    below). ``streaming`` True makes the dense engine stream too; None
    means "above STREAMING_FACES faces" (the clipping API pins it from the
    face count before the clip). ``bin_cap`` caps the faces per tile of the
    dense and streaming engines (None: a multiple of the mean density,
    ``resolve_bin_cap``); ``expand_cap`` caps the subtiles (packed) or
    tiles (streaming) one face may overlap; ``budget`` is the packed
    engine's iteration budget;
    ``clip_cap`` the near-plane clip's secondary slots; ``pool_cap`` the
    packed binning's candidate pool; ``work_cap`` its live-prefix cap.
    None means auto. Auto caps are overflow-flagged, never silent;
    ``suggest_config`` measures exact requirements.
    """

    tile_h: int | None = None
    tile_w: int = cfg.TILE_W
    bin_cap: int | None = None
    streaming: bool | None = None
    expand_cap: int | None = None
    engine: str = "auto"
    budget: int | None = None
    clip_cap: int | None = None
    pool_cap: int | None = None
    work_cap: int | None = None

    def concrete(self, height: int) -> "RasterConfig":
        """Resolve auto fields for a given image height (64-row tiles at
        >= 512 rows, ``cfg.TILE_H`` below)."""
        if self.tile_h is not None:
            return self
        return self._replace(tile_h=64 if height >= 512 else cfg.TILE_H)


# Above this face count the non-packed engines stream (CSR).
STREAMING_FACES = 16384

# Below this, ``engine="auto"`` picks the dense whole-tile engine, which
# handles faces of any screen size with no caps.
PACKED_MIN_FACES = 4096


def use_streaming(config: RasterConfig, num_faces: int) -> bool:
    if config.streaming is not None:
        return config.streaming
    return num_faces > STREAMING_FACES


def resolve_engine(config: RasterConfig, num_faces: int) -> str:
    """Which raster path runs for this (config, face count).

    ``streaming=True`` still forces the csr path; ``streaming=False`` only
    rules csr out.
    """
    if config.engine != "auto":
        return config.engine
    if config.streaming is True:
        return "csr"
    if num_faces >= PACKED_MIN_FACES:
        return "packed"
    return "dense"


def streams(config: RasterConfig, num_faces: int) -> bool:
    """Whether the streaming (CSR) engine runs for this (config, face
    count): ``engine="csr"``, or a non-packed engine that streams.

    The one decision forward and backward share: what the forward keeps
    for the backward is the CSR bins exactly when this is true.
    """
    engine = resolve_engine(config, num_faces)
    return engine == "csr" or (engine != "packed"
                               and use_streaming(config, num_faces))


def _pad_to(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


def resolve_bin_cap(config: RasterConfig, num_faces: int, num_tiles: int,
                    streaming: bool = False) -> int:
    """Per-tile face cap: explicit, or a multiple of the mean density.

    Mean binned faces per tile is about F * overlap / T; hot tiles (mesh
    silhouettes, dense regions) run several times the mean, so the dense
    engine's cap takes an 8x margin and the streaming engine's a 4x one
    over a floor of 2048 (as ``dirt_tpu``, whose streaming grids pay for
    every chunk of the cap). Overflow is reported, never silent. The cap
    never exceeds the face count.
    """
    if config.bin_cap is not None:
        cap = config.bin_cap
    else:
        mean = -(-2 * num_faces // max(num_tiles, 1))
        if streaming:
            cap = max(2048, 4 * mean)
        else:
            cap = max(cfg.DEFAULT_BIN_CAP, 8 * mean)
    return max(min(cap, max(num_faces, 1)), 1)


def _packed_caps(config: RasterConfig, num_faces: int, hp: int, wp: int):
    """(expand, budget) of the packed engine: explicit or auto."""
    tiles_y, tiles_x, strips, groups = binning.packed_grid(
        hp, wp, config.tile_h, config.tile_w
    )
    nsid = tiles_y * tiles_x * strips * groups
    expand = config.expand_cap or binning.auto_packed_expand(num_faces, nsid)
    budget = config.budget or binning.auto_packed_budget(
        num_faces, hp, wp, config.tile_h, config.tile_w, expand
    )
    return expand, budget


def _padded_background(background, tile_h: int, tile_w: int):
    """[H, W, C] -> contiguous [C, Hp, Wp] f32 padded to whole tiles."""
    height, width, _ = background.shape
    bg_chw = torch.as_tensor(background, dtype=torch.float32).permute(2, 0, 1)
    return torch.nn.functional.pad(
        bg_chw, (0, _pad_to(width, tile_w) - width,
                 0, _pad_to(height, tile_h) - height)
    ).contiguous()


class DenseLists(NamedTuple):
    """What :func:`prepare_dense` bins: ``binning.bin_faces``' result and
    the boxes it was made from."""

    bins: torch.Tensor      # [T, cap] int32 ascending ids, sentinel F
    counts: torch.Tensor    # [T] int32
    overflow: torch.Tensor  # [T] bool: the tile's list was cut at cap
    bbox: torch.Tensor      # [F, 4] int32 (xmin, xmax, ymin, ymax)


class DenseBins(NamedTuple):
    """What the dense forward leaves for its backward: its
    :class:`DenseLists` and the cull boxes the forward returned."""

    bins: torch.Tensor      # [T, cap] int32 ascending ids, sentinel F
    counts: torch.Tensor    # [T] int32
    overflow: torch.Tensor  # [T] bool: the tile's list was cut at cap
    bbox: torch.Tensor      # [F, 4] int32 (xmin, xmax, ymin, ymax)
    # [Fp, 4] int32 ``raster_fwd.csr_cull_boxes`` of the table rows over the
    # padded image: every pixel a face can own lies inside its box, which
    # ``bbox`` does not bound for a needle whose far corners lie far off the
    # image. The backward kernels scan these.
    cull: torch.Tensor


def prepare_dense(face_verts_screen, face_attrs, background, config):
    """The dense forward up to the raster kernel.

    Triangle setup, whole-tile binning and the face table. Returns (table
    [Fp, 17 + 3C], DenseLists, background [C, Hp, Wp] padded to whole tiles,
    the concrete config); the forward adds its cull boxes to make the
    DenseBins. A config that streams (more faces than
    ``STREAMING_FACES``, or ``streaming=True``) belongs to
    :func:`prepare_csr`, as in ``dirt_tpu``.
    """
    height, width, _ = background.shape
    config = config.concrete(height)
    tile_h, tile_w = config.tile_h, config.tile_w
    num_faces = face_verts_screen.shape[0]
    if (resolve_engine(config, num_faces) != "dense"
            or streams(config, num_faces)):
        raise ValueError(f"prepare_dense needs the dense engine, not "
                         f"streaming, got {config} for {num_faces} faces")

    geo, att, valid = setup_planes(face_verts_screen, face_attrs)
    bbox = face_bboxes(face_verts_screen, valid, height, width).contiguous()
    bg_chw = _padded_background(background, tile_h, tile_w)
    hp, wp = bg_chw.shape[1:]
    cap = resolve_bin_cap(config, num_faces,
                          (hp // tile_h) * (wp // tile_w))
    trace.switch("setup", "binning", bbox)
    bins = binning.bin_faces(bbox, height, width, tile_h, tile_w, cap)
    trace.switch("binning", "raster_fwd", bbox)
    table = raster_fwd.pack_face_table(geo, att)
    dense = DenseLists(bins.bins.contiguous(), bins.counts.contiguous(),
                       bins.overflow, bbox)
    return table, dense, bg_chw, config


class StreamLists(NamedTuple):
    """What :func:`prepare_csr` bins: ``binning.bin_faces_csr``' result and
    the boxes it was made from."""

    entry_face: torch.Tensor   # [n_pad] int32 CSR runs, sentinel F
    start_block: torch.Tensor  # [T] int32, in CHUNK-row blocks
    counts: torch.Tensor       # [T] int32
    overflow: torch.Tensor     # [] bool: a tile cut at cap or a face at
                               # expand_cap
    bbox: torch.Tensor         # [F, 4] int32 (xmin, xmax, ymin, ymax)


class StreamBins(NamedTuple):
    """What the streaming forward leaves for its backward: its
    :class:`StreamLists` and the cull boxes the forward returned."""

    entry_face: torch.Tensor   # [n_pad] int32 CSR runs, sentinel F
    start_block: torch.Tensor  # [T] int32, in CHUNK-row blocks
    counts: torch.Tensor       # [T] int32
    overflow: torch.Tensor     # [] bool: a tile cut at cap or a face at
                               # expand_cap
    bbox: torch.Tensor         # [F, 4] int32 (xmin, xmax, ymin, ymax)
    cull: torch.Tensor         # [Fp, 4] int32, as DenseBins.cull


def prepare_csr(face_verts_screen, face_attrs, background, config):
    """The streaming forward up to the raster kernel.

    Triangle setup, CSR binning and the face table. Returns (table
    [Fp, 17 + 3C], StreamLists, background [C, Hp, Wp] padded to whole
    tiles, the concrete config; the forward adds its cull boxes to make the
    StreamBins). The per-tile cap is
    ``resolve_bin_cap(streaming=True)`` rounded up to ``binning.CHUNK``;
    ``expand_cap`` None means ``binning.auto_expand_cap``.
    """
    height, width, _ = background.shape
    config = config.concrete(height)
    tile_h, tile_w = config.tile_h, config.tile_w
    num_faces = face_verts_screen.shape[0]
    if not streams(config, num_faces):
        raise ValueError(f"prepare_csr needs a streaming config, got "
                         f"{config} for {num_faces} faces")

    geo, att, valid = setup_planes(face_verts_screen, face_attrs)
    bbox = face_bboxes(face_verts_screen, valid, height, width).contiguous()
    bg_chw = _padded_background(background, tile_h, tile_w)
    hp, wp = bg_chw.shape[1:]
    total = (hp // tile_h) * (wp // tile_w)
    cap = _pad_to(resolve_bin_cap(config, num_faces, total, streaming=True),
                  binning.CHUNK)
    expand = config.expand_cap or binning.auto_expand_cap(num_faces, total)
    trace.switch("setup", "binning", bbox)
    bins = binning.bin_faces_csr(bbox, height, width, tile_h, tile_w, cap,
                                 expand)
    trace.switch("binning", "raster_fwd", bbox)
    table = raster_fwd.pack_face_table(geo, att)
    return table, StreamLists(*bins, bbox), bg_chw, config


def prepare_packed(face_verts_screen, face_attrs, background, config):
    """The packed forward up to the raster kernel.

    Triangle setup, packed binning and the face table, with the entry
    rows gathered once (they ride on ``bins.rows`` for the backward).
    Returns (table2 [F + 1, W], bins, background [C, Hp, Wp] padded to
    whole tiles, the concrete config).
    """
    height, width, channels = background.shape
    config = config.concrete(height)
    tile_h, tile_w = config.tile_h, config.tile_w
    num_faces = face_verts_screen.shape[0]
    if resolve_engine(config, num_faces) != "packed":
        raise ValueError(f"prepare_packed needs the packed engine, got "
                         f"{config} for {num_faces} faces")

    geo, att, valid = setup_planes(face_verts_screen, face_attrs)
    bbox = face_bbox_cols(face_verts_screen, valid, height, width)
    bg_chw = _padded_background(background, tile_h, tile_w)
    hp, wp = bg_chw.shape[1:]

    expand, budget = _packed_caps(config, num_faces, hp, wp)
    edges = edge_filter_cols(face_verts_screen)
    trace.switch("setup", "binning", bg_chw)
    bins = binning.bin_faces_packed(
        bbox, hp, wp, tile_h, tile_w, budget, expand,
        edges=edges, pool_cap=config.pool_cap, work_cap=config.work_cap,
    )
    # The binning's closing marker also takes its cap fills.
    trace.switch("binning", "raster_fwd", bg_chw)
    table2 = raster_fwd.pack_face_table_v2(geo, att)
    # Pre-set the backward's "ones" indicator column (ignored by the
    # forward kernel); fill_, not an assignment, which would copy the
    # number from the host.
    col_one = raster_fwd.COL_ATT + 3 * channels
    if col_one < table2.shape[1]:
        table2[:, col_one].fill_(1.0)
    rows = table2[bins.entries.long() // 8].contiguous()
    return table2, bins._replace(rows=rows), bg_chw, config


def _forward_impl(face_verts_screen, face_attrs, background, config):
    """(pixels, fid, zbuf, bins, concrete config) of the forward.

    ``bins`` is the engine's own record (PackedBins, DenseBins or
    StreamBins); all carry ``overflow`` flags (dense: per tile, the others
    0-dim); DenseBins and StreamBins also the forward's cull boxes
    (``cull``).
    """
    height, width, _ = background.shape
    num_faces = face_verts_screen.shape[0]
    engine = resolve_engine(config, num_faces)
    if engine not in ("packed", "dense", "csr"):
        raise ValueError(f"unknown engine {engine!r}")
    # Stages: setup, binning (prepare_* moves the span on), raster_fwd.
    with trace.span("setup", face_verts_screen):
        if engine == "packed":
            table2, bins, bg_chw, config = prepare_packed(
                face_verts_screen, face_attrs, background, config
            )
            pixels_chw, fid, zbuf = raster_fwd.raster_forward_packed(
                table2, bins, bg_chw, tile_h=config.tile_h,
                tile_w=config.tile_w, rows=bins.rows,
            )
        elif streams(config, num_faces):
            table, lists, bg_chw, config = prepare_csr(
                face_verts_screen, face_attrs, background, config
            )
            pixels_chw, fid, zbuf, cull = raster_fwd.raster_forward_csr(
                table, lists.entry_face, lists.start_block, lists.counts,
                bg_chw, tile_h=config.tile_h, tile_w=config.tile_w,
            )
            bins = StreamBins(*lists, cull)
        else:
            table, lists, bg_chw, config = prepare_dense(
                face_verts_screen, face_attrs, background, config
            )
            pixels_chw, fid, zbuf, cull = raster_fwd.raster_forward(
                table, lists.bins, lists.counts, bg_chw,
                tile_h=config.tile_h, tile_w=config.tile_w,
            )
            bins = DenseBins(*lists, cull)
    pixels = pixels_chw.permute(1, 2, 0)[:height, :width]
    return pixels, fid[:height, :width], zbuf[:height, :width], bins, config


def move_rows(face_verts, rows: float):
    """Screen-space faces [..., 4] moved ``rows`` rows down: ``y_s + rows``,
    with x, z and invw as they are. Column 1 alone, so no offset tensor is
    made from host data (a copy a CUDA-graph capture refuses)."""
    return torch.cat([face_verts[..., :1], face_verts[..., 1:2] + rows,
                      face_verts[..., 2:]], dim=-1)


def chain_through_setup(face_verts, face_attrs, need_fv: bool, need_fa: bool,
                        plane_cotangents, row_shift: float = 0.0):
    """Chain an engine's plane cotangents to the screen-space faces.

    Recomputes ``setup_planes`` under autograd (on the faces moved
    ``row_shift`` rows down, a translation with unit Jacobian),
    hands the detached planes to ``plane_cotangents(geo, att) -> (d_geo,
    d_att, d_background)`` and pulls ``d_geo`` / ``d_att`` back through the
    setup. Returns (d_face_verts or None, d_face_attrs or None,
    d_background).
    """
    with torch.enable_grad():
        fv = face_verts.detach().requires_grad_(need_fv)
        fa = face_attrs.detach().requires_grad_(need_fa)
        moved = move_rows(fv, row_shift) if row_shift else fv
        geo, att, _ = setup_planes(moved, fa)
    d_geo, d_att, d_bg = plane_cotangents(geo.detach(), att.detach())
    outs = [(o, d) for o, d in ((geo, d_geo), (att, d_att))
            if o.requires_grad]
    wanted = [x for x, need in ((fv, need_fv), (fa, need_fa)) if need]
    grads = iter(torch.autograd.grad(
        [o for o, _ in outs], wanted, [d for _, d in outs],
        allow_unused=True,
    ))
    d_fv = next(grads) if need_fv else None
    d_fa = next(grads) if need_fa else None
    return d_fv, d_fa, d_bg


def make_scatter_fn(config, bins, num_faces: int):
    """Bind the forward's bins to the matching per-face scatter kernel.

    ``bins`` is what ``_forward_impl`` returned, ``DenseBins`` or
    ``StreamBins``; its kind picks the kernel, as it picks the backward in
    ``_RasterizeScreen``. Returns a callable (cot [K, Hp, Wp], fid [Hp, Wp])
    -> [F, K] for ``raster_bwd.backward_scatter`` /
    ``backward_scatter_halo``. (``dirt_tpu``'s function also takes the image
    size, for the streaming kernel's static chunk bound, which has no
    counterpart here.)
    """
    if not isinstance(bins, (DenseBins, StreamBins)):
        raise TypeError(f"make_scatter_fn needs DenseBins or StreamBins, got "
                        f"{type(bins).__name__}")
    geom = dict(tile_h=config.tile_h, tile_w=config.tile_w, bbox=bins.bbox,
                cull=bins.cull)
    if isinstance(bins, StreamBins):
        def scatter_fn(cot_p, fid_p):
            return scatter.scatter_to_faces_csr(
                cot_p, fid_p, bins.entry_face, bins.start_block, bins.counts,
                num_faces, **geom)
    else:
        def scatter_fn(cot_p, fid_p):
            return scatter.scatter_to_faces(
                cot_p, fid_p, bins.bins, bins.counts, num_faces + 1,
                **geom)[:num_faces]
    return scatter_fn


class _RasterizeScreen(torch.autograd.Function):
    """The raster op: forward and backward of the resolved engine.

    Counterpart of ``dirt_tpu.ops.raster``'s custom VJP (``_fwd`` and
    ``_bwd``). The forward keeps the screen-space faces, the outputs and
    the engine's bins (packed: with the gathered entry rows and the pool
    backpointers; dense and streaming: the per-tile lists and the boxes)
    for the backward, which picks the engine by the kind of bins it finds,
    recomputes the plane coefficients under autograd and chains the
    engine's plane cotangents through them.
    """

    @staticmethod
    def forward(ctx, face_verts_screen, face_attrs, background, config):
        pixels, fid, zbuf, bins, config = _forward_impl(
            face_verts_screen, face_attrs, background, config
        )
        overflow = torch.any(bins.overflow)
        ctx.mark_non_differentiable(fid, zbuf, overflow)
        ctx.save_for_backward(face_verts_screen.detach(),
                              face_attrs.detach(), pixels, fid, zbuf)
        ctx.bins = bins
        ctx.config = config
        return pixels, fid, zbuf, overflow

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_pixels, *_):
        # The whole backward is the raster_bwd stage.
        with trace.span("raster_bwd", grad_pixels):
            fv, fa, pixels, fid, zbuf = ctx.saved_tensors
            need_fv, need_fa, need_bg, _ = ctx.needs_input_grad
            d_bg = (torch.where((fid >= 0)[..., None], 0.0, grad_pixels)
                    if need_bg else None)
            if not (need_fv or need_fa):
                return None, None, d_bg, None
            config = ctx.config
            height, width = fid.shape
            num_faces = fv.shape[0]
            bins = ctx.bins
            grad_pixels = grad_pixels.contiguous()

            def plane_cotangents(geo, att):
                if isinstance(bins, DenseBins):
                    return raster_bwd.backward_fused(
                        geo, att, fid, zbuf, pixels, grad_pixels, bins.bins,
                        bins.counts, config.tile_h, config.tile_w,
                        bbox=bins.bbox, cull=bins.cull,
                    )
                if isinstance(bins, StreamBins):
                    return raster_bwd.backward_fused_csr(
                        geo, att, fid, zbuf, pixels, grad_pixels,
                        bins.entry_face, bins.start_block, bins.counts,
                        config.tile_h, config.tile_w, bbox=bins.bbox,
                        cull=bins.cull,
                    )
                expand, _ = _packed_caps(config, num_faces,
                                         _pad_to(height, config.tile_h),
                                         _pad_to(width, config.tile_w))
                return packed_bwd.backward_packed(
                    geo, att, fid, zbuf, pixels, grad_pixels, bins, num_faces,
                    config.tile_h, config.tile_w,
                    bmax=-(-expand // binning.POOL_ALIGN),
                )

            d_fv, d_fa, _ = chain_through_setup(fv, fa, need_fv, need_fa,
                                                plane_cotangents)
            return d_fv, d_fa, d_bg, None


def rasterize_screen(face_verts_screen, face_attrs, background, config):
    """Rasterize screen-space faces over a background image.

    Args:
        face_verts_screen: [F, 3, 4] f32 (x_s, y_s, z_ndc, invw).
        face_attrs: [F, 3, C] f32.
        background: [H, W, C] f32.
        config: RasterConfig.
    Returns:
        (pixels [H, W, C] f32,
         fid [H, W] int32 — face id per pixel, -1 = background,
         zbuf [H, W] f32 — screen-space depth, BIG_Z at background,
         overflow [] bool tensor — True if any static cap truncated faces,
         i.e. the image may be missing coverage: redo with
         ``suggest_config``'s caps).
    """
    return _RasterizeScreen.apply(
        torch.as_tensor(face_verts_screen, dtype=torch.float32),
        torch.as_tensor(face_attrs, dtype=torch.float32),
        torch.as_tensor(background, dtype=torch.float32),
        config,
    )


def check_bin_overflow(face_verts_screen, face_attrs, background, config):
    """Overflow flags of a scene's binning (diagnostics). Dense engine: per
    tile, True where the tile's list was cut at ``bin_cap``; streaming
    engine: one flag, True if a tile's run was cut at ``bin_cap`` or a face
    at ``expand_cap``."""
    fv = torch.as_tensor(face_verts_screen, dtype=torch.float32).detach()
    fa = torch.as_tensor(face_attrs, dtype=torch.float32).detach()
    prepare = prepare_csr if streams(config, fv.shape[0]) else prepare_dense
    return prepare(fv, fa, background, config)[1].overflow


def count_bins_exact(bbox, height, width, tile_h, tile_w):
    """Exact per-tile face counts + max per-face tile span, O(F + T).

    2D interval stabbing by inclusion-exclusion: each face adds +1/-1 at
    the four corners of its tile range in a difference grid; a double
    prefix sum recovers the per-tile counts.
    """
    bbox = torch.as_tensor(bbox).to(torch.int64)
    tiles_y = -(-height // tile_h)
    tiles_x = -(-width // tile_w)

    def fdiv(a, b):
        return torch.div(a, b, rounding_mode="floor")

    txmin, txmax = fdiv(bbox[:, 0], tile_w), fdiv(bbox[:, 1], tile_w)
    tymin, tymax = fdiv(bbox[:, 2], tile_h), fdiv(bbox[:, 3], tile_h)
    valid = (bbox[:, 1] >= bbox[:, 0]) & (bbox[:, 3] >= bbox[:, 2])
    w = valid.to(torch.int64)
    # Boxes come clipped to the image (``face_bboxes``; an empty box is
    # (0, -1, 0, -1)), so every corner index lies in [0, tiles].
    nx = tiles_x + 1
    diff = torch.zeros(((tiles_y + 1) * nx,), dtype=torch.int64,
                       device=bbox.device)
    for ys, xs, sign in ((tymin, txmin, 1), (tymin, txmax + 1, -1),
                         (tymax + 1, txmin, -1), (tymax + 1, txmax + 1, 1)):
        diff.index_add_(0, ys * nx + xs, sign * w)
    diff = diff.reshape(tiles_y + 1, nx)
    counts = torch.cumsum(torch.cumsum(diff, dim=0), dim=1)
    counts = counts[:tiles_y, :tiles_x].reshape(-1)
    span = torch.where(valid, (txmax - txmin + 1) * (tymax - tymin + 1), 0)
    return counts, torch.max(span)


def _bbox_from_fv(fv, height, width):
    """[F, 4] bbox from screen verts (counting-stage helper)."""
    _, _, valid = setup_planes(
        fv, torch.zeros((fv.shape[0], 3, 1), dtype=torch.float32,
                        device=fv.device)
    )
    return face_bboxes(fv, valid, height, width)


def _subtile_spans(bbox, height, width, tile_h, tile_w):
    """(span_x, span_y, span, (gxmin, gymin)) at 8x16-subtile granularity."""
    bbox = bbox.to(torch.int64)
    hp = _pad_to(height, tile_h)
    wp = _pad_to(width, tile_w)
    tiles_y, tiles_x, strips, groups = binning.packed_grid(
        hp, wp, tile_h, tile_w
    )
    gy_n = tiles_y * strips
    gx_n = tiles_x * groups

    def cell(v, size, n):
        return torch.clamp(torch.div(v, size, rounding_mode="floor"), 0, n - 1)

    gxmin = cell(bbox[:, 0], binning.SUB_W, gx_n)
    gxmax = cell(bbox[:, 1], binning.SUB_W, gx_n)
    gymin = cell(bbox[:, 2], binning.SUB_H, gy_n)
    gymax = cell(bbox[:, 3], binning.SUB_H, gy_n)
    valid = (bbox[:, 1] >= bbox[:, 0]) & (bbox[:, 3] >= bbox[:, 2])
    span_x = torch.where(valid, gxmax - gxmin + 1, 0)
    span_y = torch.where(valid, gymax - gymin + 1, 0)
    return span_x, span_y, span_x * span_y, (gxmin, gymin)


def suggest_config(
    face_verts_screen, height: int, width: int,
    config: RasterConfig | None = None, margin: float = 1.25,
):
    """Concrete RasterConfig whose caps cannot overflow for this scene.

    The "allocate" half of count-then-allocate: measures the exact
    per-tile bin occupancy and per-face spans for the given geometry and
    returns ``config`` with its caps set just above the measured maxima
    (times ``margin``). Host-synchronizing: fetches a few scalars.
    """
    config = (config or RasterConfig()).concrete(height)
    fv = torch.as_tensor(face_verts_screen, dtype=torch.float32).detach()
    num_faces = fv.shape[0]
    streaming = use_streaming(config, num_faces)
    engine = resolve_engine(config, num_faces)

    bbox = _bbox_from_fv(fv, height, width)
    counts, max_span = count_bins_exact(
        bbox, height, width, config.tile_h, config.tile_w
    )
    _, _, sub_span, _ = _subtile_spans(
        bbox, height, width, config.tile_h, config.tile_w
    )
    max_count, max_span, max_sub = (
        int(v) for v in torch.stack(
            [torch.max(counts), max_span, torch.max(sub_span)]
        ).tolist()
    )
    cap = _pad_to(max(int(max_count * margin), 1), binning.CHUNK)
    kwargs = dict(bin_cap=cap)
    if streaming or config.streaming:
        kwargs["expand_cap"] = max(int(max_span * margin), 1)
    if engine == "packed":
        exp, bud, pool, work = count_packed_exact(
            bbox, height, width, config.tile_h, config.tile_w, margin,
            face_verts_screen=fv, max_subspan=max_sub,
        )
        kwargs.update(expand_cap=exp, budget=bud, pool_cap=pool,
                      work_cap=work)
    return config._replace(**kwargs)


def _count_packed_device(bbox, fv, height, width, tile_h, tile_w, e_max,
                         expand, margin):
    """Counting stage 2: candidate enumeration, scalars out.

    Returns (budget, pool_blocks_sum, jobs_sum) as 0-dim tensors. Mirrors
    the candidate layout and the edge filter of
    ``binning.bin_faces_packed`` so the budget counts the iterations the
    kernel actually executes.
    """
    hp = _pad_to(height, tile_h)
    wp = _pad_to(width, tile_w)
    tiles_y, tiles_x, strips, groups = binning.packed_grid(
        hp, wp, tile_h, tile_w
    )
    nsid = tiles_y * tiles_x * strips * groups
    span_x, span_y, span, (gxmin, gymin) = _subtile_spans(
        bbox, height, width, tile_h, tile_w
    )
    al = binning.POOL_ALIGN
    blocks = -torch.div(-torch.clamp(span, max=expand), al,
                        rounding_mode="floor")
    blocks_sum = torch.sum(blocks)

    # Candidate enumeration [F, e_max].
    e = torch.arange(e_max, dtype=torch.int64, device=bbox.device)[None, :]
    sx = torch.clamp(span_x, min=1)[:, None]
    ey = torch.div(e, sx, rounding_mode="floor")
    ex = e - ey * sx
    gy = gymin[:, None] + ey
    gx = gxmin[:, None] + ex
    ok = e < torch.clamp(span, max=expand)[:, None]
    if fv is not None:
        x0, y0, a0, b0, a1, b1, a2, b2, c0 = edge_filter_cols(fv)
        rx0 = gx.to(torch.float32) * binning.SUB_W + 0.5 - x0[:, None]
        ry0 = gy.to(torch.float32) * binning.SUB_H + 0.5 - y0[:, None]
        zero = torch.zeros_like(c0)
        for a, b, c in ((a0, b0, c0), (a1, b1, zero), (a2, b2, zero)):
            av, bv, cv = a[:, None], b[:, None], c[:, None]
            emax = (av * rx0 + bv * ry0 + cv
                    + torch.clamp(av, min=0.0) * (binning.SUB_W - 1)
                    + torch.clamp(bv, min=0.0) * (binning.SUB_H - 1))
            slack = 0.5 * torch.sqrt(av * av + bv * bv)
            ok = ok & (emax >= -slack)
    t_id = torch.div(gy, strips, rounding_mode="floor") * tiles_x \
        + torch.div(gx, groups, rounding_mode="floor")
    sid = (t_id * strips + torch.remainder(gy, strips)) * groups \
        + torch.remainder(gx, groups)
    sid = torch.where(ok, sid, nsid)
    counts = torch.bincount(sid.reshape(-1), minlength=nsid + 1)[:nsid]
    # As in dirt_tpu: sids run (tile, strip, group), so with several tile
    # columns this grouping mixes tiles and the budget can come out short
    # (flagged, never silent). Kept for cap parity; see ROADMAP Queue 3.
    counts = counts.reshape(tiles_y, strips, tiles_x, groups)
    n_iter = torch.amax(counts, dim=3)                # [ty, strips, tx]
    tile_iters = torch.sum(n_iter, dim=1)             # [ty, tx]
    ti_m = (tile_iters.to(torch.float32) * margin).to(torch.int64)
    chunks = torch.clamp(
        -torch.div(-ti_m, binning.PACK_ITERS, rounding_mode="floor"), min=1
    )
    budget = torch.sum(chunks) * binning.PACK_ITERS
    # Surviving (post-filter) jobs: the live-prefix work_cap is nsid
    # headers + this many real pairs.
    jobs_sum = torch.sum(counts)
    return budget, blocks_sum, jobs_sum


def count_packed_exact(bbox, height: int, width: int, tile_h: int,
                       tile_w: int, margin: float = 1.25,
                       face_verts_screen=None,
                       max_subspan: int | None = None):
    """Exact (expand_cap, budget, pool_cap, work_cap) for the packed engine.

    Counting half of count-then-allocate at subtile granularity. With
    ``face_verts_screen`` given, candidates go through the same edge
    filter the binning applies, so the budget reflects the iterations the
    kernel executes. ``bbox`` may be None when ``face_verts_screen`` is
    given. Host-synchronizing: fetches scalars.
    """
    fv = face_verts_screen
    if fv is not None:
        fv = torch.as_tensor(fv, dtype=torch.float32).detach()
    if bbox is None:
        bbox = _bbox_from_fv(fv, height, width)
    bbox = torch.as_tensor(bbox).to(torch.int64)
    if max_subspan is None:
        _, _, span, _ = _subtile_spans(bbox, height, width, tile_h, tile_w)
        max_subspan = int(torch.max(span))
    e_max = max(int(max_subspan), 1)
    expand = max(int(max_subspan * margin), 1)
    budget, blocks_sum, jobs_sum = (
        int(v) for v in torch.stack(_count_packed_device(
            bbox, fv, height, width, tile_h, tile_w, e_max, expand,
            float(margin),
        )).tolist()
    )
    al = binning.POOL_ALIGN
    pool = int(blocks_sum * margin + 1) * al
    hp = _pad_to(height, tile_h)
    wp = _pad_to(width, tile_w)
    tiles_y, tiles_x, strips, groups = binning.packed_grid(
        hp, wp, tile_h, tile_w
    )
    nsid = tiles_y * tiles_x * strips * groups
    work = nsid + int(jobs_sum * margin) + 8
    return expand, budget, pool, work
