#!/usr/bin/env python3
"""Smoke run of dirt_tpu_torch on one CUDA card (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's main path once at full size, the way a user calls it:
the 10,224-face bench sphere (``mesh.uv_sphere(72, 72)``, the camera of
``bench.py``) rendered at 1024x1024 with 3 channels through
``suggest_raster_config`` + ``rasterise_with_aux``, with ``clip=False`` and
``clip=True``. Phases, one line each (any failure raises and exits
non-zero; nothing is caught):

1. torch / CUDA versions and the card's name and power limit;
2. build of every CUDA kernel of the path from ``dirt_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (the bench scene's real bins and rows): fid and zbuf
   must be equal, pixels allclose(rtol=1e-6, atol=1e-6);
4. the main path: overflow flag clear, equal and nonzero covered pixels
   with and without clipping, launch counts > 0, output checks, and the
   forward times (median of 20, CUDA events) of the kernel path and of
   the same path with the plain version in the kernel's place.

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


def _bench_scene(device):
    from dirt_tpu_torch.core import matrices, mesh

    verts_obj, faces, _ = mesh.uv_sphere(n_lat=72, n_lon=72)

    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    mv = matrices.compose(
        matrices.rodrigues(t([0.4, 0.3, 0.0])),
        matrices.translation(t([0.0, 0.0, -3.0])),
    )
    proj = matrices.perspective_projection(t(0.1), t(20.0), t(0.045), t(1.0))
    clip = matrices.transform_homogeneous(
        torch.as_tensor(verts_obj, device=device), matrices.compose(mv, proj)
    )
    colors = torch.as_tensor(
        np.random.RandomState(0).rand(len(verts_obj), 3).astype(np.float32),
        device=device,
    )
    faces = torch.as_tensor(faces.astype(np.int64), device=device)
    background = torch.zeros((SIZE, SIZE, CHANNELS), device=device)
    return clip, colors, faces, background


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import dirt_tpu_torch
    from dirt_tpu_torch.ops import _build, raster, raster_fwd
    from dirt_tpu_torch.ops.triangle_setup import screen_from_clip

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
    _build.load("raster_fwd_packed")
    build_s = time.perf_counter() - start
    ptxas = [ln.strip() for ln in _build.build_log("raster_fwd_packed")
             .splitlines() if "registers" in ln or "spill" in ln]
    print(f"[2 build] raster_fwd_packed built+loaded in {build_s:.2f} s "
          f"({_build.library_path('raster_fwd_packed').name}); "
          + " | ".join(ptxas))
    _sync()

    # --- 3. kernel vs plain version at the main path's shapes -------------
    clip, colors, faces, background = _bench_scene(device)
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
    max_abs_err = float((pix_k - pix_p).abs().max())
    kernel_ms = _median_ms(kernel)
    plain_ms = _median_ms(plain)
    print(f"[3 kernel vs plain] raster_fwd_packed rows "
          f"{tuple(bins.rows.shape)} bg {tuple(bg_chw.shape)}: fid "
          f"mismatches {fid_bad}, zbuf "
          f"mismatches {z_bad}, pixels outside allclose(rtol=1e-6, atol=1e-6)"
          f" {pix_bad}, max |pix diff| {max_abs_err:.3g}; kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms (median of {RUNS}, "
          f"{card})")
    if fid_bad or z_bad or pix_bad:
        raise RuntimeError("kernel disagrees with its plain version")
    _sync()

    # --- 4. main path -----------------------------------------------------
    configs = {
        c: dirt_tpu_torch.suggest_raster_config(
            clip, faces, SIZE, SIZE, clip=c)
        for c in (False, True)
    }
    raster_fwd.LAUNCHES = 0
    outs = {
        c: dirt_tpu_torch.rasterise_with_aux(
            background, clip, colors, faces, config=configs[c], clip=c)
        for c in (False, True)
    }
    _sync()
    launches = raster_fwd.LAUNCHES
    if launches < 1:
        raise RuntimeError("main path never launched raster_fwd_packed")

    covered = {}
    for c, (pixels, fid, zbuf, overflow) in outs.items():
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
    if covered[False] == 0 or covered[False] != covered[True]:
        raise RuntimeError(f"covered pixels differ or are zero: {covered}")
    if not torch.equal(outs[False][1], outs[True][1]):
        raise RuntimeError("fid differs between clip=False and clip=True")

    # The same forward with the plain version in the kernel's place:
    # identical outputs, and no kernel launch.
    def plain_dispatch(table2, bins, background_chw, *, tile_h, tile_w,
                       rows=None):
        return raster_fwd.raster_forward_packed_plain(
            rows, bins, background_chw, tile_h=tile_h, tile_w=tile_w)

    def fwd(c):
        return dirt_tpu_torch.rasterise_with_aux(
            background, clip, colors, faces, config=configs[c], clip=c)

    times = {}
    with mock.patch.object(raster_fwd, "raster_forward_packed",
                           plain_dispatch):
        before = raster_fwd.LAUNCHES
        plain_out = fwd(False)
        _sync()
        if raster_fwd.LAUNCHES != before:
            raise RuntimeError("plain path launched the kernel")
        for c in (False, True):
            times[("plain", c)] = _median_ms(lambda: fwd(c))
    if not torch.equal(plain_out[1], outs[False][1]) or not torch.allclose(
            plain_out[0], outs[False][0], **TOL):
        raise RuntimeError("kernel path and plain path disagree")
    for c in (False, True):
        times[("kernel", c)] = _median_ms(lambda: fwd(c))
    prep_ms = _median_ms(lambda: raster.prepare_packed(
        face_verts, colors[faces], background, config))
    _sync()
    for c in (False, True):
        cf = configs[c]
        print(f"[4 main path clip={c}] caps tile_h={cf.tile_h} "
              f"expand_cap={cf.expand_cap} budget={cf.budget} "
              f"pool_cap={cf.pool_cap} work_cap={cf.work_cap} "
              f"clip_cap={cf.clip_cap}; overflow False; covered {covered[c]}"
              f" px; forward {times[('kernel', c)]:.4f} ms kernel path, "
              f"{times[('plain', c)]:.4f} ms plain path (median of {RUNS}, "
              f"{card})")
    print(f"[4 main path] kernel launches {launches}; clip=False stages: "
          f"setup+binning+table {prep_ms:.4f} ms, raster kernel "
          f"{kernel_ms:.4f} ms ({card})")

    print(json.dumps({"kernels": [{
        "name": "raster_fwd_packed",
        "route": "cuda",
        "source": "dirt_tpu_torch/csrc/raster_fwd_packed.cu",
        "replaces": "dirt_tpu/ops/raster_fwd.py:413",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
