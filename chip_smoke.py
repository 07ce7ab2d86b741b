#!/usr/bin/env python3
"""Smoke run of dirt_tpu_torch on one CUDA card (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's main path at full size, the way a user calls it: the
10,224-face bench sphere (``mesh.uv_sphere(72, 72)``, the camera of
``bench.py``) rendered at 1024x1024 with 3 channels through
``suggest_raster_config`` + ``rasterise_with_aux``, forward and backward,
with ``clip=False`` and ``clip=True``. Phases, one line each (any failure
raises and exits non-zero; nothing is caught):

1. torch / CUDA versions and the card's name and power limit;
2. build of every CUDA kernel of the path from ``dirt_tpu_torch/csrc``
   (one nvcc each, in parallel), with ptxas registers and spills;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (the bench scene's real bins, rows and outputs, and the
   bench's upstream gradient ``RandomState(1).rand(1024, 1024, 3)``):
   raster_fwd_packed fid and zbuf equal, pixels allclose(rtol=1e-6,
   atol=1e-6); packed_prologue bits equal, sval allclose(rtol=1e-6,
   atol=1e-6); packed_bwd entry rows allclose(rtol=1e-5, atol=1e-6);
4. the main path: forward checks (overflow flag clear, equal nonzero
   covered pixels with and without clipping), then ``loss = sum(pixels *
   w)`` and ``loss.backward()`` to vertices, colors and background:
   finite, nonzero vertex and color gradients, d_background equal to w
   on background and 0 on covered pixels, launch counts > 0 for all three
   kernels, the kernel path's gradients against the same path with every
   kernel replaced by its plain version (max |diff| <= 1e-5 max |grad|),
   and the times (median of 20,
   CUDA events) of the forward, the fwd+bwd step, the backward alone and
   fwd+bwd Mpix/s;
5. a few training steps: Adam on the L2 loss to a target render, from a
   perturbed pose and perturbed colors; the loss must fall;
6. the three packed kernels against their plain versions at 9 channels
   (the deferred G-buffer's count) on the bench sphere;
7. the dense engine's kernels, raster_fwd_dense and fused_bwd, against
   their plain versions at three shapes: config 4 of ``bench_configs.py``
   (2,208-face sphere, 512x512, 3 channels), the bench sphere at 1024x1024
   with ``engine="dense"``, and the flagship step's G-buffer (2,208 faces,
   256x256, 9 channels); config 4's and the flagship's faces are the ones
   the path's own render hands the raster op (after the near-plane clip),
   captured from one run of it: fid and zbuf equal, pixels allclose(rtol=1e-6,
   atol=1e-6); cotangent rows within 1e-5 of the column's largest
   magnitude + 1e-6 (the kernel sums float32 in a fixed order, the plain
   version float64), and equal on a second run;
8. the deferred pipeline at full width, forward and ``loss.backward()`` to
   vertices and pose: config 5 of ``bench_configs.py`` (10,224 faces,
   1024x1024, 9-channel G-buffer, packed engine, texture + Phong) and the
   flagship step ``dirt_tpu_torch.entry.entry()`` (2,208 faces, 256x256,
   dense engine); overflow clear, gradients finite and within 1e-4 of max
   |gradient| of the same path with every kernel replaced by its plain
   version, launch counts > 0; then 10 Adam steps on the flagship loss
   over (vertices, pose), which must fall;
9. configs 1-4 of ``bench_configs.py`` on the port, once each: forward and
   a gradient step on the auto (dense) engine, overflow clear, times.

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

SIZE = 1024
CHANNELS = 3
RUNS = 20
TOL = dict(rtol=1e-6, atol=1e-6)
# packed_bwd against its plain version: the same expressions, and every
# row summed over its pixels in the same order, both built to round each
# step (-fmad=false, IEEE division); the margin allows for a CUDA
# elementwise kernel of torch rounding one step otherwise.
TOL_BWD = dict(rtol=1e-5, atol=1e-6)
# Gradients of the kernel path against the plain path, as max |diff| over
# max |gradient|: the same entry rows (up to TOL_BWD), then identical
# torch ops whose scatter-adds (autograd's index backward) may sum in
# another order.
TOL_GRAD = 1e-5
# fused_bwd against its plain version, per column: |diff| <= TOL_ROWS *
# max |column| + 1e-6. The kernel sums float32 in its own fixed order; the
# plain version sums float64 and rounds once.
TOL_ROWS = 1e-5
# The deferred pipeline's gradients, kernel path against plain path, as max
# |diff| over max |gradient|: besides the kernels' rows, torch's own
# scatter-adds (vertex normals, texture and vertex gathers) sum with atomics.
TOL_DEFERRED = 1e-4
KERNELS = ("raster_fwd_packed", "packed_prologue", "packed_bwd",
           "raster_fwd_dense", "fused_bwd")
REPLACES = {
    "raster_fwd_packed": "dirt_tpu/ops/raster_fwd.py:413",
    "packed_prologue": "dirt_tpu/ops/packed_bwd.py:293",
    "packed_bwd": "dirt_tpu/ops/packed_bwd.py:96",
    "raster_fwd_dense": "dirt_tpu/ops/raster_fwd.py:38",
    "fused_bwd": "dirt_tpu/ops/fused_bwd.py:44",
}
TRAIN_STEPS = 10
# Published peaks of one H100 SXM: HBM bytes/s and float32 FLOP/s outside
# the tensor cores (the kernels use no tensor core).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12
# Arithmetic of one (pixel, face) coverage and depth test, of one pixel's
# attribute evaluation, and of cotangent_core.cuh for one covered pixel.
TEST_FLOPS = 22


def _attr_flops(channels):
    return 6 + 5 * channels


def _core_flops(channels):
    return 330 + 6 * channels + (12 + 3 * channels)


def _bound(nbytes, flops):
    """bound_ms and bound_by: the larger of bytes over the memory rate and
    operations over the float32 peak."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _sync():
    torch.cuda.synchronize()


def _median_ms(fn, runs=RUNS, warmup=2):
    """Median of ``runs`` single-call times (CUDA events), in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _clip_verts(verts_obj, rot, device):
    from dirt_tpu_torch.core import matrices

    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    mv = matrices.compose(
        matrices.rodrigues(rot),
        matrices.translation(t([0.0, 0.0, -3.0])),
    )
    proj = matrices.perspective_projection(t(0.1), t(20.0), t(0.045), t(1.0))
    return matrices.transform_homogeneous(verts_obj,
                                          matrices.compose(mv, proj))


def _world(verts_obj, device, pose=(0.4, 0.3, 0.0)):
    """World-space vertices [V, 3]: Rodrigues ``pose``, 3 units down -z."""
    from dirt_tpu_torch.core import matrices

    model = matrices.compose(
        matrices.rodrigues(torch.as_tensor(pose, dtype=torch.float32,
                                           device=device)),
        matrices.translation(torch.tensor([0.0, 0.0, -3.0], device=device)),
    )
    return matrices.transform_homogeneous(verts_obj, model)[..., :3]


def _bench_scene(device):
    from dirt_tpu_torch.core import mesh

    verts_obj, faces, _ = mesh.uv_sphere(n_lat=72, n_lon=72)
    verts_obj = torch.as_tensor(verts_obj, device=device)
    rot = torch.tensor([0.4, 0.3, 0.0], device=device)
    clip = _clip_verts(verts_obj, rot, device)
    colors = torch.as_tensor(
        np.random.RandomState(0).rand(len(verts_obj), 3).astype(np.float32),
        device=device,
    )
    faces = torch.as_tensor(faces.astype(np.int64), device=device)
    background = torch.zeros((SIZE, SIZE, CHANNELS), device=device)
    weights = torch.as_tensor(
        np.random.RandomState(1).rand(SIZE, SIZE, CHANNELS)
        .astype(np.float32), device=device,
    )
    return verts_obj, clip, colors, faces, background, weights


def _rel_err(got, want):
    """max |got - want| / max |want| (0 when both are 0)."""
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    return diff / scale if scale else diff


def _grads(rasterise, background, clip, colors, faces, weights, config, c):
    """loss.backward() of sum(pixels * w); returns (outputs, grads)."""
    bg = background.clone().requires_grad_()
    verts = clip.clone().requires_grad_()
    cols = colors.clone().requires_grad_()
    out = rasterise(bg, verts, cols, faces, config=config, clip=c)
    (out[0] * weights).sum().backward()
    return out, (verts.grad, cols.grad, bg.grad)


def _launch_counts():
    """{kernel: launches so far} from the wrappers' counters."""
    from dirt_tpu_torch.ops import fused_bwd, packed_bwd, raster_fwd

    return {
        "raster_fwd_packed": raster_fwd.LAUNCHES,
        "packed_prologue": packed_bwd.LAUNCHES_PROLOGUE,
        "packed_bwd": packed_bwd.LAUNCHES_BWD,
        "raster_fwd_dense": raster_fwd.LAUNCHES_DENSE,
        "fused_bwd": fused_bwd.LAUNCHES,
    }


def _reset_launch_counts():
    from dirt_tpu_torch.ops import fused_bwd, packed_bwd, raster_fwd

    raster_fwd.LAUNCHES = raster_fwd.LAUNCHES_DENSE = 0
    packed_bwd.LAUNCHES_PROLOGUE = packed_bwd.LAUNCHES_BWD = 0
    fused_bwd.LAUNCHES = 0


def _need_launches(path, counts, kernels):
    missed = [k for k in kernels if counts[k] < 1]
    if missed:
        raise RuntimeError(f"{path} missed a kernel: {missed} of {counts}")


def _plain_patches():
    """Patches that put each kernel wrapper's plain version in its place
    (``start()`` / ``stop()`` them): the same path with no kernel."""
    from dirt_tpu_torch.ops import fused_bwd, packed_bwd, raster_fwd

    def plain_forward(table2, bins, background_chw, *, tile_h, tile_w,
                      rows=None):
        return raster_fwd.raster_forward_packed_plain(
            rows, bins, background_chw, tile_h=tile_h, tile_w=tile_w)

    def plain_rows(prep, c_lo=0, c_hi=None):
        return packed_bwd.packed_entry_rows_plain(
            prep, packed_bwd._entry_table_rows(prep), c_lo,
            prep.budget_chunks if c_hi is None else c_hi)

    def plain_fused(geo, bins, counts, fid, bits, sval, pix_cf, grad_cf,
                    num_rows, *, tile_h, tile_w, bbox=None):
        return fused_bwd.fused_backward_rows_plain(
            geo, fid, bits, sval, pix_cf, grad_cf, num_rows)

    return (
        mock.patch.object(raster_fwd, "raster_forward_packed", plain_forward),
        mock.patch.object(packed_bwd, "fused_neighbor_prologue",
                          packed_bwd.fused_neighbor_prologue_plain),
        mock.patch.object(packed_bwd, "packed_entry_rows", plain_rows),
        mock.patch.object(raster_fwd, "raster_forward",
                          raster_fwd.raster_forward_plain),
        mock.patch.object(fused_bwd, "fused_backward_rows", plain_fused),
    )


def _packed_live(bins, tile_h):
    """Iterations the packed kernels run: per (tile, strip), the strip's run
    clamped to its tile's n_iters, summed."""
    strips = tile_h // 8
    lo = bins.iter_off.long().reshape(-1, strips)
    hi = torch.minimum(lo + bins.strip_iters.long().reshape(-1, strips),
                       bins.n_iters.long()[:, None])
    return int(torch.clamp(hi - lo, min=0).sum())


def _check_packed_kernels(tag, face_verts, face_attrs, background, weights,
                          config, card, runs=RUNS, plain_runs=RUNS):
    """raster_fwd_packed, packed_prologue and packed_bwd against their plain
    versions on one scene's real bins, rows and outputs; ``weights`` is the
    upstream gradient. Returns {kernel: max_abs_err, ms, plain_ms, bound_ms,
    bound_by}; raises on a mismatch."""
    from dirt_tpu_torch.ops import packed_bwd, raster, raster_fwd
    from dirt_tpu_torch.ops.triangle_setup import setup_planes

    table2, bins, bg_chw, cfg = raster.prepare_packed(
        face_verts, face_attrs, background, config
    )
    if bool(bins.overflow):
        raise RuntimeError(f"[{tag}] binning overflowed under caps {config}")
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    channels, hp, wp = bg_chw.shape
    plane = hp * wp
    record = {}

    def kernel():
        return raster_fwd.raster_forward_packed(
            table2, bins, bg_chw, rows=bins.rows, **geom)

    def plain():
        return raster_fwd.raster_forward_packed_plain(
            bins.rows, bins, bg_chw, **geom)

    pix_k, fid_k, z_k = kernel()
    pix_p, fid_p, z_p = plain()
    _sync()
    fid_bad = int((fid_k != fid_p).sum())
    z_bad = int((z_k != z_p).sum())
    pix_bad = int((~torch.isclose(pix_k, pix_p, **TOL)).sum())
    err = float((pix_k - pix_p).abs().max())
    live = _packed_live(bins, cfg.tile_h)
    covered = int((fid_k >= 0).sum())
    width = bins.rows.shape[1]
    row_bytes = live * 8 * width * 4        # the rows the live iterations read
    meta_bytes = 4 * (2 * bins.n_iters.numel() + 2 * bins.iter_off.numel())
    record["raster_fwd_packed"] = dict(
        max_abs_err=err, ms=_median_ms(kernel, runs),
        plain_ms=_median_ms(plain, plain_runs),
        **_bound(row_bytes + meta_bytes + 4 * plane * (2 * channels + 2),
                 live * 1024 * TEST_FLOPS + covered * _attr_flops(channels)))
    print(f"[{tag}] raster_fwd_packed rows "
          f"{tuple(bins.rows.shape)} bg {tuple(bg_chw.shape)}: fid "
          f"mismatches {fid_bad}, zbuf "
          f"mismatches {z_bad}, pixels outside allclose(rtol=1e-6, atol=1e-6)"
          f" {pix_bad}, max |pix diff| {err:.3g}; kernel "
          f"{record['raster_fwd_packed']['ms']:.4f} ms, plain "
          f"{record['raster_fwd_packed']['plain_ms']:.4f} ms, bound "
          f"{record['raster_fwd_packed']['bound_ms']:.4f} ms by "
          f"{record['raster_fwd_packed']['bound_by']} (medians of "
          f"{runs} and {plain_runs}, {card})")
    if fid_bad or z_bad or pix_bad:
        raise RuntimeError(f"[{tag}] raster_fwd_packed disagrees with its "
                           "plain version")

    # The backward's inputs: the forward's outputs (the sizes used here need
    # no tile padding) and the upstream gradient.
    grad_cf = weights.permute(2, 0, 1).contiguous()
    pro_args = (fid_k, z_k, pix_k, grad_cf)
    bits_k, sval_k = packed_bwd.fused_neighbor_prologue(*pro_args)
    bits_p, sval_p = packed_bwd.fused_neighbor_prologue_plain(*pro_args)
    _sync()
    bits_bad = int((bits_k != bits_p).sum())
    sval_bad = int((~torch.isclose(sval_k, sval_p, **TOL)).sum())
    err = float((sval_k - sval_p).abs().max())
    record["packed_prologue"] = dict(
        max_abs_err=err,
        ms=_median_ms(lambda: packed_bwd.fused_neighbor_prologue(*pro_args),
                      runs),
        plain_ms=_median_ms(
            lambda: packed_bwd.fused_neighbor_prologue_plain(*pro_args),
            plain_runs),
        **_bound(4 * plane * (2 + 2 * channels + 5),
                 plane * 4 * (3 * channels + 1)))
    print(f"[{tag}] packed_prologue fid {tuple(fid_k.shape)} "
          f"pix {tuple(pix_k.shape)}: bits mismatches {bits_bad} (of "
          f"{int((bits_p != 0).sum())} nonzero), sval outside "
          f"allclose(rtol=1e-6, atol=1e-6) {sval_bad}, max |sval diff| "
          f"{err:.3g}; kernel {record['packed_prologue']['ms']:.4f} ms, "
          f"plain {record['packed_prologue']['plain_ms']:.4f} ms, bound "
          f"{record['packed_prologue']['bound_ms']:.4f} ms by "
          f"{record['packed_prologue']['bound_by']} (medians of "
          f"{runs} and {plain_runs}, {card})")
    if bits_bad or sval_bad:
        raise RuntimeError(f"[{tag}] packed_prologue disagrees with its "
                           "plain version")

    geo, att, _ = setup_planes(face_verts, face_attrs)
    prep = packed_bwd.prepare_backward_packed(
        geo, att, fid_k, z_k, pix_k.permute(1, 2, 0), weights, bins,
        cfg.tile_h, cfg.tile_w)
    rows_k = packed_bwd.packed_entry_rows(prep)
    rows_p = packed_bwd.packed_entry_rows_plain(
        prep, bins.rows, 0, prep.budget_chunks)
    _sync()
    rows_bad = int((~torch.isclose(rows_k, rows_p, **TOL_BWD)).sum())
    err = float((rows_k - rows_p).abs().max())
    same = torch.equal(rows_k, packed_bwd.packed_entry_rows(prep))
    record["packed_bwd"] = dict(
        max_abs_err=err,
        ms=_median_ms(lambda: packed_bwd.packed_entry_rows(prep), runs),
        plain_ms=_median_ms(lambda: packed_bwd.packed_entry_rows_plain(
            prep, bins.rows, 0, prep.budget_chunks), plain_runs),
        **_bound(row_bytes + meta_bytes + 4 * plane * (6 + 2 * channels)
                 + 4 * rows_k.numel(), covered * _core_flops(channels)))
    print(f"[{tag}] packed_bwd entry rows "
          f"{tuple(rows_k.shape)}: values outside allclose(rtol=1e-5, "
          f"atol=1e-6) {rows_bad}, max |diff| {err:.3g}, max |row| "
          f"{float(rows_p.abs().max()):.4g}, nonzero rows "
          f"{int((rows_p != 0).any(1).sum())}, second run equal {same}; "
          f"kernel {record['packed_bwd']['ms']:.4f} ms, plain "
          f"{record['packed_bwd']['plain_ms']:.4f} ms, bound "
          f"{record['packed_bwd']['bound_ms']:.4f} ms by "
          f"{record['packed_bwd']['bound_by']} (medians of {runs} "
          f"and {plain_runs}, {card})")
    if rows_bad or not same:
        raise RuntimeError(f"[{tag}] packed_bwd disagrees with its plain "
                           "version or with itself")
    _sync()
    return record


def _check_dense_kernels(tag, face_verts, face_attrs, size, config, weights,
                         card, runs=RUNS, plain_runs=3):
    """raster_fwd_dense and fused_bwd against their plain versions on one
    scene at ``size`` x ``size`` (a multiple of the tile, so nothing is
    padded); ``weights`` [size, size, C] is the upstream gradient. Returns
    {kernel: max_abs_err, ms, plain_ms, bound_ms, bound_by}; raises on a
    mismatch."""
    from dirt_tpu_torch.ops import fused_bwd, packed_bwd, raster, raster_fwd
    from dirt_tpu_torch.ops.triangle_setup import setup_planes

    channels = face_attrs.shape[-1]
    background = torch.zeros((size, size, channels), device=face_verts.device)
    table, bins, bg_chw, cfg = raster.prepare_dense(
        face_verts, face_attrs, background, config)
    if bool(bins.overflow.any()):
        raise RuntimeError(f"[{tag}] dense binning overflowed under {cfg}")
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    num_faces = face_verts.shape[0]
    _, hp, wp = bg_chw.shape
    plane = hp * wp
    record = {}

    def kernel():
        return raster_fwd.raster_forward(table, bins.bins, bins.counts,
                                         bg_chw, **geom)

    def plain():
        return raster_fwd.raster_forward_plain(table, bins.bins, bins.counts,
                                               bg_chw, **geom)

    pix_k, fid_k, z_k = kernel()
    pix_p, fid_p, z_p = plain()
    _sync()
    fid_bad = int((fid_k != fid_p).sum())
    z_bad = int((z_k != z_p).sum())
    pix_bad = int((~torch.isclose(pix_k, pix_p, **TOL)).sum())
    err = float((pix_k - pix_p).abs().max())
    listed = int(bins.counts.sum())
    covered = int((fid_k >= 0).sum())
    list_bytes = 4 * (listed + bins.counts.numel())
    # The tests rasterising needs: one per pixel of each face's box (clipped
    # to the image), not one per pixel of every tile the face is listed in.
    box = bins.bbox.long()
    box_px = int((torch.clamp(box[:, 1] - box[:, 0] + 1, min=0)
                  * torch.clamp(box[:, 3] - box[:, 2] + 1, min=0)).sum())
    record["raster_fwd_dense"] = dict(
        max_abs_err=err, ms=_median_ms(kernel, runs),
        plain_ms=_median_ms(plain, plain_runs, warmup=1),
        **_bound(4 * table.numel() + list_bytes
                 + 4 * plane * (2 * channels + 2),
                 box_px * TEST_FLOPS + covered * _attr_flops(channels)))
    print(f"[{tag}] raster_fwd_dense table {tuple(table.shape)} bins "
          f"{tuple(bins.bins.shape)} (listed {listed}, largest tile "
          f"{int(bins.counts.max())}, box pixels {box_px}) tiles {cfg.tile_h}x{cfg.tile_w} bg "
          f"{tuple(bg_chw.shape)}: fid mismatches {fid_bad}, zbuf mismatches "
          f"{z_bad}, pixels outside allclose(rtol=1e-6, atol=1e-6) {pix_bad}, "
          f"max |pix diff| {err:.3g}, covered {covered} px; kernel "
          f"{record['raster_fwd_dense']['ms']:.4f} ms, plain "
          f"{record['raster_fwd_dense']['plain_ms']:.4f} ms, bound "
          f"{record['raster_fwd_dense']['bound_ms']:.4f} ms by "
          f"{record['raster_fwd_dense']['bound_by']} (medians of "
          f"{runs} and {plain_runs}, {card})")
    if fid_bad or z_bad or pix_bad or not covered:
        raise RuntimeError(f"[{tag}] raster_fwd_dense disagrees with its "
                           "plain version")

    grad_cf = weights.permute(2, 0, 1).contiguous()
    bits, sval = packed_bwd.fused_neighbor_prologue(fid_k, z_k, pix_k,
                                                    grad_cf)
    geo, _, _ = setup_planes(face_verts, face_attrs)
    geo = geo.contiguous()
    args = (geo, bins.bins, bins.counts, fid_k, bits, sval, pix_k, grad_cf,
            num_faces + 1)

    def fused():
        return fused_bwd.fused_backward_rows(*args, bbox=bins.bbox, **geom)

    def fused_plain():
        return fused_bwd.fused_backward_rows_plain(
            geo, fid_k, bits, sval, pix_k, grad_cf, num_faces + 1)

    rows_k = fused()
    rows_p = fused_plain()
    _sync()
    scale = rows_p.abs().amax(dim=0, keepdim=True)
    rows_bad = int(((rows_k - rows_p).abs() > TOL_ROWS * scale + 1e-6).sum())
    err = float((rows_k - rows_p).abs().max())
    same = torch.equal(rows_k, fused())
    record["fused_bwd"] = dict(
        max_abs_err=err, ms=_median_ms(fused, runs),
        plain_ms=_median_ms(fused_plain, plain_runs, warmup=1),
        **_bound(4 * 17 * num_faces + list_bytes + 16 * num_faces
                 + 4 * plane * (6 + 2 * channels) + 4 * rows_k.numel(),
                 covered * _core_flops(channels)))
    print(f"[{tag}] fused_bwd rows {tuple(rows_k.shape)}: values outside "
          f"{TOL_ROWS:g} * max |column| + 1e-6: {rows_bad}, max |diff| "
          f"{err:.3g}, max |row| {float(rows_p.abs().max()):.4g}, nonzero "
          f"rows {int((rows_p != 0).any(1).sum())}, second run equal {same}; "
          f"kernel {record['fused_bwd']['ms']:.4f} ms, plain "
          f"{record['fused_bwd']['plain_ms']:.4f} ms, bound "
          f"{record['fused_bwd']['bound_ms']:.4f} ms by "
          f"{record['fused_bwd']['bound_by']} (medians of {runs} and "
          f"{plain_runs}, {card})")
    if rows_bad or not same or not bool((rows_k != 0).any()):
        raise RuntimeError(f"[{tag}] fused_bwd disagrees with its plain "
                           "version or with itself")
    _sync()
    return record


def _posed_sphere(n_lat, n_lon, device):
    """(object-space vertices, clip-space vertices, faces, uvs) of a UV
    sphere under the camera of ``bench_configs._posed``."""
    from dirt_tpu_torch.core import mesh

    verts_obj, faces, uvs = mesh.uv_sphere(n_lat=n_lat, n_lon=n_lon)
    verts_obj = torch.as_tensor(verts_obj, device=device)
    rot = torch.tensor([0.4, 0.3, 0.0], device=device)
    return (verts_obj, _clip_verts(verts_obj, rot, device),
            torch.as_tensor(faces.astype(np.int64), device=device),
            torch.as_tensor(uvs, device=device))


def _rand(seed, *shape, device):
    return torch.as_tensor(
        np.random.RandomState(seed).rand(*shape).astype(np.float32),
        device=device)


def _honest(clip, faces, size):
    """Count-then-allocate config, and a hard check that it renders
    untruncated (``bench_configs._honest``)."""
    import dirt_tpu_torch

    config = dirt_tpu_torch.suggest_raster_config(clip, faces, size, size)
    overflow = dirt_tpu_torch.rasterise_with_aux(
        torch.zeros((size, size, 3), device=clip.device), clip,
        torch.zeros((clip.shape[0], 3), device=clip.device), faces,
        config=config)[3]
    if bool(overflow):
        raise RuntimeError(f"suggested caps overflow: {config}")
    return config


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def config5_render(device):
    """(render, leaves) of config 5 of ``bench_configs.py`` on the port: the
    10,224-face sphere at 1024 x 1024 through the deferred pipeline (9-channel
    G-buffer, 128 x 128 checkerboard, Phong) under count-then-allocate caps
    (the packed engine). ``render(verts, pose, **kwargs)`` is
    ``entry.deferred_render``; the leaves are (object-space vertices, pose)."""
    from dirt_tpu_torch import entry
    from dirt_tpu_torch.core import mesh

    verts_obj, faces, uvs, _, proj = entry.deferred_scene(72, 72,
                                                          device=device)
    texture = torch.as_tensor(mesh.checkerboard_texture(128, 10, 3),
                              device=device)
    pose = torch.tensor([0.4, 0.3, 0.0], device=device)
    config = _honest(_clip_verts(verts_obj, pose, device), faces, SIZE)

    def render(verts, pose, **kwargs):
        return entry.deferred_render(verts, pose, faces, uvs, texture, proj,
                                     SIZE, config, **kwargs)

    return render, (verts_obj, pose)


def config4_loss(device):
    """(loss_fn, leaves) of config 4 of ``bench_configs.py`` on the port: the
    2,208-face sphere at 512 x 512, diffuse + specular vertex shading, the
    dense engine under count-then-allocate caps; ``loss_fn(light, pose)`` is
    ``sum(image * w)`` with ``w = RandomState(1).rand(512, 512, 3)``."""
    import dirt_tpu_torch
    from dirt_tpu_torch import entry
    from dirt_tpu_torch.core import lighting

    verts_obj, faces, _, _, proj = entry.deferred_scene(device=device)
    pose = torch.tensor([0.4, 0.3, 0.0], device=device)
    config = _honest(_clip_verts(verts_obj, pose, device), faces, 512)
    white = torch.ones((verts_obj.shape[0], 3), device=device)
    background = torch.zeros((512, 512, 3), device=device)
    weights = _rand(1, 512, 512, 3, device=device)
    one3 = torch.ones(3, device=device)

    def loss_fn(light, pose):
        world = _world(verts_obj, device, pose)
        normals = lighting.vertex_normals(world, faces)
        ldir = light / torch.linalg.norm(light)
        shaded = lighting.diffuse_directional(
            normals, white, ldir, one3
        ) + lighting.specular_directional(
            world, normals, white, torch.zeros(3, device=device), ldir, one3,
            24.0)
        clip = torch.cat([world, torch.ones_like(world[:, :1])], 1) @ proj
        return (dirt_tpu_torch.rasterise(background, clip, shaded, faces,
                                         config=config) * weights).sum()

    return loss_fn, (torch.tensor([0.3, 0.8, 0.52], device=device), pose)


def _raster_inputs(fn):
    """Run ``fn()`` and return what its one rasterisation handed the raster
    op: (face_verts_screen, face_attrs, background, config), detached. These
    are the clipped, gathered faces the engine's kernels see on that path."""
    from dirt_tpu_torch.ops import raster

    seen = []
    inner = raster._forward_impl

    def record(face_verts, face_attrs, background, config):
        seen.append((face_verts.detach(), face_attrs.detach(),
                     background.detach(), config))
        return inner(face_verts, face_attrs, background, config)

    with mock.patch.object(raster, "_forward_impl", record):
        fn()
    (inputs,) = seen
    return inputs


def _step_check(tag, loss_fn, leaves, card, runs=10, plain=True):
    """One forward + backward of ``loss_fn(*leaves)`` on the kernel path,
    the same on the plain path (every kernel patched out), and times.
    Gradients must be finite, nonzero and within TOL_DEFERRED of the plain
    path's. Returns (loss, launches of the kernel-path step)."""
    def step():
        fresh = [t.detach().clone().requires_grad_() for t in leaves]
        loss = loss_fn(*fresh)
        loss.backward()
        return loss.detach(), [t.grad for t in fresh]

    _reset_launch_counts()
    loss_k, grads_k = step()
    _sync()
    launches = _launch_counts()
    for g in grads_k:
        if g is None or not bool(torch.isfinite(g).all()) \
                or not bool(g.abs().sum() > 0):
            raise RuntimeError(f"[{tag}] gradient missing, not finite or "
                               "zero")
    errs = []
    plain_ms = float("nan")
    if plain:
        patches = _plain_patches()
        for patch in patches:
            patch.start()
        before = _launch_counts()
        loss_p, grads_p = step()
        _sync()
        plain_ms = _median_ms(step, runs=3, warmup=0)
        if before != _launch_counts():
            raise RuntimeError(f"[{tag}] plain path launched a kernel")
        for patch in patches:
            patch.stop()
        errs = [_rel_err(g_k, g_p) for g_k, g_p in zip(grads_k, grads_p)]
        if not abs(float(loss_k) - float(loss_p)) <= 1e-5 * abs(float(loss_p)):
            raise RuntimeError(f"[{tag}] kernel and plain path losses "
                               f"disagree: {float(loss_k)} {float(loss_p)}")
        if not all(e <= TOL_DEFERRED for e in errs):
            raise RuntimeError(f"[{tag}] kernel and plain path gradients "
                               f"disagree: {errs}")
    with torch.no_grad():
        fwd_ms = _median_ms(lambda: loss_fn(*leaves), runs)
    step_ms = _median_ms(step, runs)
    versus = (f"kernel vs plain path max |grad diff| / max |grad| "
              f"{' '.join(f'{e:.3g}' for e in errs)} (limit "
              f"{TOL_DEFERRED:g}), plain path fwd+bwd {plain_ms:.4f} ms "
              f"(median of 3); " if plain else "")
    print(f"[{tag}] loss {float(loss_k):.6g}; gradients finite; {versus}"
          f"launches {launches}; forward {fwd_ms:.4f} ms, fwd+bwd "
          f"{step_ms:.4f} ms (medians of {runs}) ({card})")
    return float(loss_k), launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import dirt_tpu_torch
    from dirt_tpu_torch.ops import _build, raster
    from dirt_tpu_torch.ops.triangle_setup import screen_from_clip

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    # --- 1. versions and card -------------------------------------------
    card = card_line()
    print(f"[1 versions] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices "
          f"{torch.cuda.device_count()}")
    print(card)

    # --- 2. build ---------------------------------------------------------
    start = time.perf_counter()
    nvcc_s = _build.build(KERNELS)
    for kernel_name in KERNELS:
        _build.load(kernel_name)
    build_s = time.perf_counter() - start
    print(f"[2 build] {len(KERNELS)} kernels built in parallel + loaded in "
          f"{build_s:.2f} s")
    for kernel_name in KERNELS:
        ptxas = [ln.strip() for ln in _build.build_log(kernel_name)
                 .splitlines() if "registers" in ln or "spill" in ln]
        built = (f"nvcc done after {nvcc_s[kernel_name]:.2f} s"
                 if kernel_name in nvcc_s else "already built")
        print(f"[2 build] {kernel_name} "
              f"({_build.library_path(kernel_name).name}): {built}; "
              + " | ".join(ptxas))
    _sync()

    # --- 3. kernels vs plain versions at the main path's shapes -----------
    verts_obj, clip, colors, faces, background, weights = _bench_scene(
        device)
    config = dirt_tpu_torch.suggest_raster_config(
        clip, faces, SIZE, SIZE, clip=False
    )
    face_verts = screen_from_clip(clip, SIZE, SIZE)[faces]
    record = _check_packed_kernels("3 kernel vs plain", face_verts,
                                   colors[faces], background, weights,
                                   config, card)

    # --- 4. main path: forward and backward -------------------------------
    configs = {
        c: dirt_tpu_torch.suggest_raster_config(
            clip, faces, SIZE, SIZE, clip=c)
        for c in (False, True)
    }
    _reset_launch_counts()
    runs = {
        c: _grads(dirt_tpu_torch.rasterise_with_aux, background, clip,
                  colors, faces, weights, configs[c], c)
        for c in (False, True)
    }
    _sync()
    launches = _launch_counts()
    _need_launches("packed main path", launches, KERNELS[:3])

    covered = {}
    for c, ((pixels, fid, zbuf, overflow), grads) in runs.items():
        if bool(overflow):
            raise RuntimeError(f"overflow flag set (clip={c}, {configs[c]})")
        if (tuple(pixels.shape) != (SIZE, SIZE, CHANNELS)
                or tuple(fid.shape) != (SIZE, SIZE)
                or tuple(zbuf.shape) != (SIZE, SIZE)):
            raise RuntimeError(f"bad output shapes (clip={c})")
        hit = fid >= 0
        covered[c] = int(hit.sum())
        if not bool(torch.isfinite(pixels).all()):
            raise RuntimeError(f"non-finite pixels (clip={c})")
        if int(fid.max()) >= faces.shape[0]:
            raise RuntimeError(f"face id out of range (clip={c})")
        if not bool(((zbuf[hit] >= -1) & (zbuf[hit] <= 1)).all()):
            raise RuntimeError(f"covered depth outside [-1, 1] (clip={c})")
        if not bool(((pixels >= -1e-5) & (pixels <= 1 + 1e-5)).all()):
            raise RuntimeError(f"colors outside [0, 1] (clip={c})")
        d_v, d_c, d_bg = grads
        for label, g in (("vertices", d_v), ("colors", d_c),
                         ("background", d_bg)):
            if g is None or not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"{label} gradient missing or not finite "
                                   f"(clip={c})")
        if not (bool(d_v.abs().sum() > 0) and bool(d_c.abs().sum() > 0)):
            raise RuntimeError(f"zero vertex or color gradient (clip={c})")
        if not (torch.equal(d_bg[~hit], weights[~hit])
                and bool((d_bg[hit] == 0).all())):
            raise RuntimeError(f"d_background is not w off the mesh and 0 "
                               f"on it (clip={c})")
    if covered[False] == 0 or covered[False] != covered[True]:
        raise RuntimeError(f"covered pixels differ or are zero: {covered}")
    if not torch.equal(runs[False][0][1], runs[True][0][1]):
        raise RuntimeError("fid differs between clip=False and clip=True")

    # The same path with every kernel replaced by its plain version: the
    # same image and gradients within TOL_GRAD, and no kernel launch.
    plain_patches = _plain_patches()

    def fwd(c):
        return dirt_tpu_torch.rasterise_with_aux(
            background, clip, colors, faces, config=configs[c], clip=c)

    def step(c):
        return _grads(dirt_tpu_torch.rasterise_with_aux, background, clip,
                      colors, faces, weights, configs[c], c)

    times = {}
    grad_err = {}
    for patch in plain_patches:
        patch.start()
    counts = _launch_counts()
    for c in (False, True):
        (pix_pl, _, _, _), grads_pl = step(c)
        _sync()
        if not torch.allclose(pix_pl, runs[c][0][0], **TOL):
            raise RuntimeError(f"kernel and plain path images disagree "
                               f"(clip={c})")
        grad_err[c] = []
        for label, g_k, g_p in zip(("vertices", "colors", "background"),
                                   runs[c][1], grads_pl):
            grad_err[c].append(_rel_err(g_k, g_p))
            if not grad_err[c][-1] <= TOL_GRAD:
                raise RuntimeError(f"kernel and plain path {label} gradients "
                                   f"disagree (clip={c}): max |diff| / max "
                                   f"|grad| {grad_err[c][-1]:.3g}")
        times[("plain fwd", c)] = _median_ms(lambda: fwd(c))
        times[("plain step", c)] = _median_ms(lambda: step(c), runs=5,
                                              warmup=1)
    if counts != _launch_counts():
        raise RuntimeError("plain path launched a kernel")
    for patch in plain_patches:
        patch.stop()

    for c in (False, True):
        times[("fwd", c)] = _median_ms(lambda: fwd(c))
        times[("step", c)] = _median_ms(lambda: step(c))
        # The backward alone, on one retained graph; every repeat must give
        # the same gradients (the kernels are deterministic, and the
        # residuals survive retain_graph).
        verts = clip.clone().requires_grad_()
        cols = colors.clone().requires_grad_()
        bg = background.clone().requires_grad_()
        loss = (dirt_tpu_torch.rasterise(
            bg, verts, cols, faces, config=configs[c], clip=c)
            * weights).sum()
        first = torch.autograd.grad(loss, (verts, cols, bg),
                                    retain_graph=True)
        times[("bwd", c)] = _median_ms(lambda: torch.autograd.grad(
            loss, (verts, cols, bg), retain_graph=True))
        again = torch.autograd.grad(loss, (verts, cols, bg),
                                    retain_graph=True)
        if not all(_rel_err(a, b) <= TOL_GRAD for a, b in zip(first, again)):
            raise RuntimeError(f"repeated backward differs (clip={c})")
    prep_ms = _median_ms(lambda: raster.prepare_packed(
        face_verts, colors[faces], background, config))
    _sync()
    for c in (False, True):
        cf = configs[c]
        print(f"[4 main path clip={c}] caps tile_h={cf.tile_h} "
              f"expand_cap={cf.expand_cap} budget={cf.budget} "
              f"pool_cap={cf.pool_cap} work_cap={cf.work_cap} "
              f"clip_cap={cf.clip_cap}; overflow False; covered {covered[c]}"
              f" px; gradients finite, d_background = w off the mesh; "
              f"kernel vs plain path max |grad diff| / max |grad|: vertices "
              f"{grad_err[c][0]:.3g} colors {grad_err[c][1]:.3g} background "
              f"{grad_err[c][2]:.3g} (limit {TOL_GRAD:g})")
        step_ms = times[("step", c)]
        print(f"[4 main path clip={c}] forward {times[('fwd', c)]:.4f} ms, "
              f"fwd+bwd {step_ms:.4f} ms ({SIZE * SIZE / 1e6 / step_ms * 1e3:.2f}"
              f" Mpix/s fwd+bwd), backward alone {times[('bwd', c)]:.4f} ms "
              f"(kernel path, median of {RUNS}); plain path: forward "
              f"{times[('plain fwd', c)]:.4f} ms (median of {RUNS}), fwd+bwd "
              f"{times[('plain step', c)]:.4f} ms (median of 5) ({card})")
    print(f"[4 main path] kernel launches {launches}; clip=False stages: "
          f"setup+binning+table {prep_ms:.4f} ms, raster kernel "
          f"{record['raster_fwd_packed']['ms']:.4f} ms, prologue kernel "
          f"{record['packed_prologue']['ms']:.4f} ms, backward kernel "
          f"{record['packed_bwd']['ms']:.4f} ms ({card})")

    # --- 5. a few training steps ------------------------------------------
    target = dirt_tpu_torch.rasterise(
        background, clip, colors, faces, config=configs[False], clip=False)
    rot = torch.tensor([0.4, 0.3, 0.0], device=device)
    d_rot = torch.tensor([0.03, -0.02, 0.02], device=device,
                         requires_grad=True)
    d_col = (0.15 * torch.randn(colors.shape, generator=torch.Generator(
        device).manual_seed(2), device=device)).requires_grad_()
    opt = torch.optim.Adam([d_rot, d_col], lr=0.01)
    losses = []
    start = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        opt.zero_grad()
        image = dirt_tpu_torch.rasterise(
            background, _clip_verts(verts_obj, rot + d_rot, device),
            colors + d_col, faces, config=configs[False], clip=False)
        loss = ((image - target) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    train_s = time.perf_counter() - start
    print(f"[5 train] {TRAIN_STEPS} Adam steps (lr 0.01) on pose + colors at "
          f"{SIZE}^2: L2 loss {losses[0]:.6g} -> {losses[-1]:.6g} "
          f"(all: {', '.join(f'{v:.4g}' for v in losses)}); {train_s:.2f} s "
          f"({card})")
    if not losses[-1] < losses[0] or not np.isfinite(losses).all():
        raise RuntimeError("training loss did not fall")

    # --- 6. the packed kernels at the G-buffer's 9 channels ----------------
    colors9 = _rand(3, clip.shape[0], 9, device=device)
    _check_packed_kernels(
        "6 packed kernels C=9", face_verts, colors9[faces],
        torch.zeros((SIZE, SIZE, 9), device=device),
        _rand(4, SIZE, SIZE, 9, device=device), config, card, plain_runs=3)

    # --- 7. the dense kernels vs plain versions ------------------------------
    from dirt_tpu_torch import entry
    from dirt_tpu_torch.core import mesh
    from dirt_tpu_torch.core.texture import sample_texture
    from dirt_tpu_torch.render.gbuffer import render_gbuffer

    # Config 4's and the flagship step's own shapes: the faces each path's
    # render hands the raster op (2,208 faces + the near-plane clip's slots),
    # taken from one run of the path itself.
    c4_loss, c4_leaves = config4_loss(device)
    with torch.no_grad():
        c4_fv, c4_fa, _, c4_cfg = _raster_inputs(lambda: c4_loss(*c4_leaves))
    _check_dense_kernels(
        f"7 dense kernels config4 512^2 ({c4_fv.shape[0]} face slots of the "
        f"path's own render)", c4_fv, c4_fa, 512, c4_cfg,
        _rand(1, 512, 512, 3, device=device), card)
    dense_big = dirt_tpu_torch.suggest_raster_config(
        clip, faces, SIZE, SIZE,
        config=dirt_tpu_torch.RasterConfig(engine="dense"), clip=False)
    _check_dense_kernels(
        "7 dense kernels bench sphere 1024^2", face_verts, colors[faces],
        SIZE, dense_big, weights, card)
    step_fn, (e_verts, e_pose) = entry.entry()
    with torch.no_grad():
        e_fv, e_fa, _, e_cfg = _raster_inputs(lambda: step_fn(e_verts, e_pose))
    record.update(_check_dense_kernels(
        f"7 dense kernels flagship G-buffer 256^2 ({e_fv.shape[0]} face "
        f"slots of the step's own render)", e_fv, e_fa, 256, e_cfg,
        _rand(5, 256, 256, 9, device=device), card))

    # --- 8. the deferred pipeline at full width -------------------------------
    pose = torch.tensor([0.4, 0.3, 0.0], device=device)
    e_obj, e_faces, e_uvs, e_tex, e_proj = entry.deferred_scene(device=device)
    c5_render, c5_leaves = config5_render(device)

    for label, render, leaves, size, need in (
        ("8 deferred config5 1024^2 packed", c5_render, c5_leaves, SIZE,
         KERNELS[:3]),
        ("8 deferred flagship 256^2 dense",
         lambda v, p, **kw: entry.deferred_render(
             v, p, e_faces, e_uvs, e_tex, e_proj, 256, None, **kw),
         (e_obj, pose), 256,
         ("raster_fwd_dense", "packed_prologue", "fused_bwd")),
    ):
        with torch.no_grad():
            image, gb = render(*leaves, with_gbuffer=True)
        hit = int((gb["fid"] >= 0).sum())
        if (bool(gb["overflow"]) or tuple(image.shape) != (size, size, 3)
                or not bool(torch.isfinite(image).all()) or not hit
                or not bool((image[gb["fid"] < 0] == 0).all())):
            raise RuntimeError(f"[{label}] bad render: overflow "
                               f"{bool(gb['overflow'])}, covered {hit}")
        w = _rand(1, size, size, 3, device=device)
        _, counts = _step_check(
            label, lambda v, p: (render(v, p) * w).sum(), leaves, card)
        _need_launches(label, counts, need)
        print(f"[{label}] overflow False, covered {hit} px, G-buffer "
              f"channels {sum(gb[k].shape[-1] for k in ('position', 'normal', 'uv', 'mask'))}")
        if "dense" in label:
            launches.update({k: counts[k] for k in ("raster_fwd_dense",
                                                    "fused_bwd")})

    # The flagship entry point itself, and Adam on its loss.
    first, counts = _step_check("8 flagship entry()", step_fn,
                                (e_verts, e_pose), card, plain=False)
    _need_launches("flagship entry()", counts,
                   ("raster_fwd_dense", "packed_prologue", "fused_bwd"))
    e_verts = e_verts.clone().requires_grad_()
    e_pose = e_pose.clone().requires_grad_()
    opt = torch.optim.Adam([e_verts, e_pose], lr=0.01)
    losses = []
    start = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        opt.zero_grad()
        loss = step_fn(e_verts, e_pose)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    train_s = time.perf_counter() - start
    print(f"[8 flagship train] {TRAIN_STEPS} Adam steps (lr 0.01) on "
          f"vertices + pose at 256^2: loss {losses[0]:.6g} -> "
          f"{losses[-1]:.6g} (all: {', '.join(f'{v:.4g}' for v in losses)}); "
          f"{train_s:.2f} s ({card})")
    if (not losses[-1] < losses[0] or not np.isfinite(losses).all()
            or abs(losses[0] - first) > 1e-5 * first):
        raise RuntimeError("flagship loss did not fall, or its first value "
                           "is not the step's")

    # --- 9. configs 1-4 of bench_configs.py -------------------------------------
    dense_need = ("raster_fwd_dense", "packed_prologue", "fused_bwd")

    def run_config(label, loss_fn, leaves):
        _, counts = _step_check(label, loss_fn, leaves, card)
        _need_launches(label, counts, dense_need)

    tri = torch.tensor([[-0.5, -0.5, 0, 1], [0.5, -0.5, 0, 1],
                        [0.0, 0.6, 0, 1]], device=device)
    tri_faces = torch.tensor([[0, 1, 2]], device=device)
    w1 = _rand(1, 64, 64, 1, device=device)
    ones1 = torch.ones((3, 1), device=device)
    bg1 = torch.zeros((64, 64, 1), device=device)
    run_config("9 config1 single-tri 64^2",
               lambda v: (dirt_tpu_torch.rasterise(bg1, v, ones1, tri_faces)
                          * w1).sum(), (tri,))

    cube_v, cube_f = mesh.cube()
    cube_clip = _clip_verts(torch.as_tensor(cube_v, device=device), pose,
                            device)
    cube_f = torch.as_tensor(cube_f.astype(np.int64), device=device)
    w2 = _rand(1, 256, 256, 3, device=device)
    bg2 = torch.zeros((256, 256, 3), device=device)
    run_config("9 config2 cube 256^2",
               lambda c, co: (dirt_tpu_torch.rasterise(bg2, c, co, cube_f)
                              * w2).sum(),
               (cube_clip, _rand(0, 8, 3, device=device)))

    _, s_clip, s_faces, s_uvs = _posed_sphere(24, 48, device)
    dense_cfg4 = _honest(s_clip, s_faces, 512)
    w3 = _rand(1, 512, 512, 3, device=device)

    def config3_loss(c, tex):
        gb = render_gbuffer(c, s_faces, {"uv": s_uvs}, 512, 512,
                            config=dense_cfg4)
        return (sample_texture(tex, gb["uv"]) * gb["mask"] * w3).sum()

    run_config("9 config3 textured 512^2", config3_loss,
               (s_clip, torch.as_tensor(mesh.checkerboard_texture(128, 10, 3),
                                        device=device)))

    run_config("9 config4 lit 512^2", c4_loss, c4_leaves)

    print(json.dumps({"kernels": [{
        "name": k,
        "route": "cuda",
        "source": f"dirt_tpu_torch/csrc/{k}.cu",
        "replaces": REPLACES[k],
        "launches": launches[k],
        **record[k],
        "library_ms": None,
    } for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
