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
   perturbed pose and perturbed colors; the loss must fall.

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
KERNELS = ("raster_fwd_packed", "packed_prologue", "packed_bwd")
TRAIN_STEPS = 10


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


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import dirt_tpu_torch
    from dirt_tpu_torch.ops import _build, packed_bwd, raster, raster_fwd
    from dirt_tpu_torch.ops.triangle_setup import screen_from_clip, \
        setup_planes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    # --- 1. versions and card -------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
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
    table2, bins, bg_chw, cfg = raster.prepare_packed(
        face_verts, colors[faces], background, config
    )
    if bool(bins.overflow):
        raise RuntimeError("bench scene binning overflowed under "
                           f"suggested caps {config}")
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
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
    record["raster_fwd_packed"] = dict(
        max_abs_err=err, ms=_median_ms(kernel), plain_ms=_median_ms(plain))
    print(f"[3 kernel vs plain] raster_fwd_packed rows "
          f"{tuple(bins.rows.shape)} bg {tuple(bg_chw.shape)}: fid "
          f"mismatches {fid_bad}, zbuf "
          f"mismatches {z_bad}, pixels outside allclose(rtol=1e-6, atol=1e-6)"
          f" {pix_bad}, max |pix diff| {err:.3g}; kernel "
          f"{record['raster_fwd_packed']['ms']:.4f} ms, plain "
          f"{record['raster_fwd_packed']['plain_ms']:.4f} ms (median of "
          f"{RUNS}, {card})")
    if fid_bad or z_bad or pix_bad:
        raise RuntimeError("raster_fwd_packed disagrees with its plain "
                           "version")

    # The backward's inputs at the main path's shapes: the forward's
    # outputs (1024^2 needs no tile padding) and the bench's gradient.
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
        ms=_median_ms(lambda: packed_bwd.fused_neighbor_prologue(*pro_args)),
        plain_ms=_median_ms(
            lambda: packed_bwd.fused_neighbor_prologue_plain(*pro_args)),
    )
    print(f"[3 kernel vs plain] packed_prologue fid {tuple(fid_k.shape)} "
          f"pix {tuple(pix_k.shape)}: bits mismatches {bits_bad} (of "
          f"{int((bits_p != 0).sum())} nonzero), sval outside "
          f"allclose(rtol=1e-6, atol=1e-6) {sval_bad}, max |sval diff| "
          f"{err:.3g}; kernel {record['packed_prologue']['ms']:.4f} ms, "
          f"plain {record['packed_prologue']['plain_ms']:.4f} ms (median of "
          f"{RUNS}, {card})")
    if bits_bad or sval_bad:
        raise RuntimeError("packed_prologue disagrees with its plain version")

    geo, att, _ = setup_planes(face_verts, colors[faces])
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
        ms=_median_ms(lambda: packed_bwd.packed_entry_rows(prep)),
        plain_ms=_median_ms(lambda: packed_bwd.packed_entry_rows_plain(
            prep, bins.rows, 0, prep.budget_chunks)),
    )
    print(f"[3 kernel vs plain] packed_bwd entry rows "
          f"{tuple(rows_k.shape)}: values outside allclose(rtol=1e-5, "
          f"atol=1e-6) {rows_bad}, max |diff| {err:.3g}, max |row| "
          f"{float(rows_p.abs().max()):.4g}, nonzero rows "
          f"{int((rows_p != 0).any(1).sum())}, second run equal {same}; "
          f"kernel {record['packed_bwd']['ms']:.4f} ms, plain "
          f"{record['packed_bwd']['plain_ms']:.4f} ms (median of {RUNS}, "
          f"{card})")
    if rows_bad or not same:
        raise RuntimeError("packed_bwd disagrees with its plain version or "
                           "with itself")
    _sync()

    # --- 4. main path: forward and backward -------------------------------
    configs = {
        c: dirt_tpu_torch.suggest_raster_config(
            clip, faces, SIZE, SIZE, clip=c)
        for c in (False, True)
    }
    raster_fwd.LAUNCHES = 0
    packed_bwd.LAUNCHES_PROLOGUE = 0
    packed_bwd.LAUNCHES_BWD = 0
    runs = {
        c: _grads(dirt_tpu_torch.rasterise_with_aux, background, clip,
                  colors, faces, weights, configs[c], c)
        for c in (False, True)
    }
    _sync()
    launches = {
        "raster_fwd_packed": raster_fwd.LAUNCHES,
        "packed_prologue": packed_bwd.LAUNCHES_PROLOGUE,
        "packed_bwd": packed_bwd.LAUNCHES_BWD,
    }
    if min(launches.values()) < 1:
        raise RuntimeError(f"main path missed a kernel: {launches}")

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
    def plain_forward(table2, bins, background_chw, *, tile_h, tile_w,
                      rows=None):
        return raster_fwd.raster_forward_packed_plain(
            rows, bins, background_chw, tile_h=tile_h, tile_w=tile_w)

    def plain_rows(prep, c_lo=0, c_hi=None):
        return packed_bwd.packed_entry_rows_plain(
            prep, packed_bwd._entry_table_rows(prep), c_lo,
            prep.budget_chunks if c_hi is None else c_hi)

    plain_patches = (
        mock.patch.object(raster_fwd, "raster_forward_packed", plain_forward),
        mock.patch.object(packed_bwd, "fused_neighbor_prologue",
                          packed_bwd.fused_neighbor_prologue_plain),
        mock.patch.object(packed_bwd, "packed_entry_rows", plain_rows),
    )

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
    counts = (raster_fwd.LAUNCHES, packed_bwd.LAUNCHES_PROLOGUE,
              packed_bwd.LAUNCHES_BWD)
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
    if counts != (raster_fwd.LAUNCHES, packed_bwd.LAUNCHES_PROLOGUE,
                  packed_bwd.LAUNCHES_BWD):
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

    source = {
        "raster_fwd_packed": "dirt_tpu/ops/raster_fwd.py:413",
        "packed_prologue": "dirt_tpu/ops/packed_bwd.py:293",
        "packed_bwd": "dirt_tpu/ops/packed_bwd.py:96",
    }
    print(json.dumps({"kernels": [{
        "name": k,
        "route": "cuda",
        "source": f"dirt_tpu_torch/csrc/{k}.cu",
        "replaces": source[k],
        "launches": launches[k],
        **record[k],
    } for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
