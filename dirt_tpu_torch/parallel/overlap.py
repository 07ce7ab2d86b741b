"""Row-sharded rendering whose backward sums parameter gradients per chunk.

Counterpart of ``dirt_tpu/parallel/overlap.py``. The row-sharded backward
of ``parallel.sharding`` sums the gradients of vertices and colors over the
group once, after the whole backward. Here the backward runs in chunks, and
each chunk's gradients go to the group's sum as soon as they exist
(``group.all_reduce_async_``, waited on at the end), so on a group of
several ranks the all-reduce of chunk k can travel while chunk k + 1
computes. The sum of the chunks' sums is the one-shot gradient up to the
order of float32 additions.

* :func:`rasterise_overlapped` (``rasterise_sharded(overlap_chunks=N)``):
  the forward is the slab op's (``sharding._slab_forwards``); the backward
  runs the packed engine's per-entry kernel (``packed_bwd.packed_entry_rows``)
  over ``n_chunks`` slices of each slab's budget chunks, then the pool
  reduce, the anchors and the pull-back through the setup's VJP
  (``triangle_setup.setup_planes_vjp``) once per chunk, on the forward's
  planes of each slab (``bins.geo``, ``bins.att``). The packed engine must
  be the resolved one. ``dirt_tpu`` re-derives the forward's bins in its
  backward (``_rebin``), because its custom VJP does not carry them; the
  autograd Function here keeps them in ``ctx``, so nothing is re-derived.
  The op takes the clip-space vertices and colors themselves and sums their
  gradients over the group itself: they do not pass through
  ``group.replicated``, which would sum them a second time.
* :func:`overlapped_loss_and_grads`: the L2 loss against a target and its
  gradients, with the per-pixel cotangents of each slab evaluated per row
  band (``raster_bwd.pixel_cotangents_core`` on the band's rows, with the
  slab's halo-extended neighbour stacks sliced alongside, so a boundary
  pair across bands or slabs is still counted once) and summed onto faces
  with a float32 ``index_add_``; any engine renders the forward.
"""

from __future__ import annotations

import torch

from dirt_tpu_torch.ops import packed_bwd, raster, raster_bwd, triangle_setup
from dirt_tpu_torch.ops.binning import PACK_CHUNK, POOL_ALIGN
from dirt_tpu_torch.ops.raster import RasterConfig
from dirt_tpu_torch.ops.triangle_setup import screen_from_clip
from dirt_tpu_torch.parallel.sharding import (
    _exchange_halo_rows,
    _exchange_halos,
    _halo_neighbor_stacks,
    _held_rows,
    _shift_rows,
    _slab_forwards,
    _split_rows,
)
from dirt_tpu_torch.rasterise_ops import _as_inputs


def _to_leaves(face_verts, face_attrs, rows: int, d_geo, d_att, wanted):
    """Gradients of ``wanted`` from the cotangents of the planes of the
    faces moved ``rows`` rows up (a slab's): the setup's VJP, then autograd
    through the graph that made ``face_verts`` / ``face_attrs`` from the
    leaves, which stays for the next chunk."""
    d_fv, d_fa = triangle_setup.setup_planes_vjp(
        face_verts.detach(), face_attrs.detach(), d_geo, d_att, -float(rows),
        face_verts.requires_grad, face_attrs.requires_grad)
    outs = [(o, d) for o, d in ((face_verts, d_fv), (face_attrs, d_fa))
            if o.requires_grad]
    return torch.autograd.grad([o for o, _ in outs], wanted,
                               [d for _, d in outs], retain_graph=True)


class _ChunkSums:
    """The per-chunk group sums of the parameter gradients: :meth:`add`
    starts one chunk's sums, :meth:`wait` waits for all and adds them up."""

    def __init__(self, group, count: int):
        self.group = group
        self.pending = [[] for _ in range(count)]

    def add(self, per_member):
        """``per_member``: one tuple of gradients per held member."""
        for k, pending in enumerate(self.pending):
            parts = [grads[k] for grads in per_member]
            pending.append((parts[0], self.group.all_reduce_async_(parts)))

    def wait(self):
        totals = []
        for pending in self.pending:
            total = None
            for tensor, handle in pending:
                handle.wait()
                total = tensor if total is None else total + tensor
            totals.append(total)
        return totals


def _setup_grads(vertices, vertex_colors, faces, height, width, need_v,
                 need_c):
    """Leaves for the parameters' gradients and their faces under autograd:
    (wanted leaves, face_verts [F, 3, 4] screen space, face_attrs)."""
    with torch.enable_grad():
        verts = vertices.detach().requires_grad_(need_v)
        colors = vertex_colors.detach().requires_grad_(need_c)
        face_verts = screen_from_clip(verts, height, width)[faces]
        face_attrs = colors[faces]
    wanted = [x for x, need in ((verts, need_v), (colors, need_c)) if need]
    return wanted, face_verts, face_attrs


class _OverlapOp(torch.autograd.Function):
    """The slab forward, and a packed backward in chunks whose parameter
    gradients are summed over the group chunk by chunk."""

    @staticmethod
    def forward(ctx, bg_rows, vertices, vertex_colors, faces, config, group,
                n_chunks):
        slabs = list(group.local)
        slab_h, width = bg_rows.shape[0] // len(slabs), bg_rows.shape[1]
        face_verts = screen_from_clip(vertices, group.size * slab_h,
                                      width)[faces]
        pixels, fid, zbuf, overflow, ctx.bins = _slab_forwards(
            face_verts, vertex_colors[faces], bg_rows, config, slabs)
        ctx.mark_non_differentiable(fid, zbuf, overflow)
        ctx.save_for_backward(vertices.detach(), vertex_colors.detach(),
                              faces, pixels, fid, zbuf)
        ctx.static = (config, group, n_chunks)
        return pixels, fid, zbuf, overflow

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_pixels, *_):
        vertices, vertex_colors, faces, pixels, fid, zbuf = ctx.saved_tensors
        config, group, n_chunks = ctx.static
        need_bg, need_v, need_c = ctx.needs_input_grad[:3]
        grad_pixels = grad_pixels.to(torch.float32)
        d_bg = (torch.where((fid >= 0)[..., None], 0.0, grad_pixels)
                if need_bg else None)
        if not (need_v or need_c):
            return d_bg, None, None, None, None, None, None

        slabs = list(group.local)
        slab_h, width = fid.shape[0] // len(slabs), fid.shape[1]
        channels, num_faces = pixels.shape[-1], faces.shape[0]
        tile_h, tile_w = config.tile_h, config.tile_w
        wp = -(-width // tile_w) * tile_w
        wanted, face_verts, face_attrs = _setup_grads(
            vertices, vertex_colors, faces, group.size * slab_h, width,
            need_v, need_c)
        fields = _split_rows((fid, zbuf, pixels, grad_pixels), len(slabs))
        tops, bottoms = _exchange_halos(group, fields)
        preps = []
        for i, bins in enumerate(ctx.bins):
            nbrs = _halo_neighbor_stacks(
                *_exchange_halo_rows(*fields[i], tops[i], bottoms[i]),
                slab_h, wp)
            preps.append(packed_bwd.prepare_backward_packed(
                bins.geo, bins.att, *fields[i], bins, tile_h, tile_w,
                nbrs=nbrs))

        budget_chunks = preps[0].budget_chunks
        n_chunks = max(1, min(n_chunks, budget_chunks))
        bounds = [round(k * budget_chunks / n_chunks)
                  for k in range(n_chunks + 1)]
        expand, _ = raster._packed_caps(config, num_faces, slab_h, wp)
        bmax = -(-expand // POOL_ALIGN)
        sums = _ChunkSums(group, len(wanted))
        for c0, c1 in zip(bounds[:-1], bounds[1:]):
            per_slab = []
            for slab, prep, bins in zip(slabs, preps, ctx.bins):
                face_rows = packed_bwd.pool_reduce_rows(
                    packed_bwd.packed_entry_rows(prep, c0, c1),
                    bins.pair_rows, bins.pool_offs, num_faces, bmax,
                    row_base=c0 * PACK_CHUNK)
                d_geo, d_att = raster_bwd.assemble_face_gradients(
                    prep.geo, prep.att, face_rows, channels)
                per_slab.append(_to_leaves(face_verts, face_attrs,
                                           slab * slab_h, d_geo, d_att,
                                           wanted))
            sums.add(per_slab)
        totals = iter(sums.wait())
        d_v = next(totals) if need_v else None
        d_c = next(totals) if need_c else None
        return d_bg, d_v, d_c, None, None, None, None


def rasterise_overlapped(background, vertices, vertex_colors, faces, group,
                         config: RasterConfig | None = None,
                         n_chunks: int = 2, with_aux: bool = False):
    """Row-sharded render whose backward sums gradients chunk by chunk.

    Functionally ``parallel.sharding.rasterise_sharded`` (same arguments,
    forward, returns and gradient semantics under any downstream loss),
    with the backward's packed kernel run as ``n_chunks`` slices of its
    budget chunks (at most one per chunk), each slice's vertex and color
    gradients summed over ``group`` as soon as they are pulled back. The
    config must resolve to the packed engine.
    """
    vertices, vertex_colors, faces = _as_inputs(vertices, vertex_colors,
                                                faces)
    background = torch.as_tensor(background, dtype=torch.float32,
                                 device=vertices.device)
    height, width, _ = background.shape
    n = group.size
    config = (config or RasterConfig()).concrete(height // n)
    if height % (n * config.tile_h) != 0:
        raise ValueError(f"height {height} must divide devices*tile_h "
                         f"({n}*{config.tile_h})")
    if raster.resolve_engine(config, faces.shape[0]) != "packed":
        raise ValueError("rasterise_overlapped requires the packed engine "
                         "(pass engine='packed' or a production-size face "
                         "count)")
    held = list(group.local)
    bg_rows = background if len(held) == n else _held_rows(
        background, held, height // n)
    out = _OverlapOp.apply(bg_rows, vertices, vertex_colors, faces, config,
                           group, n_chunks)
    return out if with_aux else out[0]


def overlapped_loss_and_grads(background, vertices, vertex_colors, faces,
                              target, group,
                              config: RasterConfig | None = None,
                              n_chunks: int = 2):
    """L2 render loss and its gradients, the backward in row bands.

    Args:
        background, target: [H, W, C], the full image's (equal on every
            process).
        vertices: [V, 4] clip space; vertex_colors: [V, C]; faces: [F, 3].
        group: the row group (``parallel.group``).
        n_chunks: row bands per slab; the slab height must divide by it.
    Returns:
        (loss [], d_vertices [V, 4], d_colors [V, C], d_background of the
        rows this process holds), plain tensors: the loss and the parameter
        gradients summed over the group, equal to the gradients of
        ``sum((rasterise(..., clip=False) - target) ** 2)``.
    """
    vertices, vertex_colors, faces = _as_inputs(vertices, vertex_colors,
                                                faces)
    device = vertices.device
    background = torch.as_tensor(background, dtype=torch.float32,
                                 device=device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    height, width, _ = background.shape
    n = group.size
    config = (config or RasterConfig()).concrete(height // n)
    if height % (n * config.tile_h) != 0:
        raise ValueError("height must divide devices * tile_h")
    slab_h = height // n
    if slab_h % n_chunks != 0:
        raise ValueError("slab height must divide n_chunks")
    band_h = slab_h // n_chunks
    num_faces = faces.shape[0]
    slabs = list(group.local)
    wp = -(-width // config.tile_w) * config.tile_w

    wanted, face_verts, face_attrs = _setup_grads(
        vertices, vertex_colors, faces, height, width, True, True)
    planes, fields, loss = [], [], 0.0
    for slab in slabs:
        rows = slice(slab * slab_h, (slab + 1) * slab_h)
        pixels, fid, zbuf, bins, _ = raster._forward_impl(
            _shift_rows(face_verts.detach(), slab * slab_h),
            face_attrs.detach(), background[rows], config)
        planes.append((bins.geo, bins.att))
        diff = pixels - target[rows]
        loss = loss + torch.sum(diff * diff)
        fields.append((fid, zbuf, pixels, 2.0 * diff))
    loss = group.all_reduce_sum(loss)
    tops, bottoms = _exchange_halos(group, fields)
    nbrs = []
    for i in range(len(slabs)):
        stacks = _halo_neighbor_stacks(
            *_exchange_halo_rows(*fields[i], tops[i], bottoms[i]), slab_h, wp)
        nbrs.append([s[:, :, :width] for s in stacks])

    xg = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    sums = _ChunkSums(group, 2)
    for k in range(n_chunks):
        rows = slice(k * band_h, (k + 1) * band_h)
        yg = k * band_h + torch.arange(band_h, dtype=torch.float32,
                                       device=device) + 0.5
        per_slab = []
        for slab, (geo, att), (fid, zbuf, pixels, grad), stacks in zip(
                slabs, planes, fields, nbrs):
            fid_b = fid[rows]
            covered = fid_b >= 0
            cols_geo, cols_att = raster_bwd.pixel_cotangents_core(
                geo[torch.clamp(fid_b, min=0).long()].permute(2, 0, 1),
                covered, fid_b, zbuf[rows], pixels[rows].permute(2, 0, 1),
                grad[rows].permute(2, 0, 1),
                [tuple(s[d, rows] for s in stacks) for d in range(4)],
                *torch.broadcast_tensors(xg[None, :], yg[:, None]))
            d_geo, d_att = raster_bwd.sum_onto_faces(
                cols_geo, cols_att, fid_b, covered, num_faces)
            d_geo = raster_bwd.anchor_cotangents(geo, att, d_geo, d_att)
            per_slab.append(_to_leaves(face_verts, face_attrs, slab * slab_h,
                                       d_geo, d_att, wanted))
        sums.add(per_slab)
    d_v, d_c = sums.wait()
    d_bg = torch.cat([torch.where((f[0] >= 0)[..., None], 0.0, f[3])
                      for f in fields])
    return loss, d_v, d_c, d_bg
