#!/usr/bin/env python3
"""Benchmark of dirt_tpu_torch's main path on one CUDA card (H100).

    python3 bench_torch.py

Prints ONE JSON line first, ``{"metric", "value", "unit", "vs_baseline"}``:
the Mpix/s of one forward + backward step at 1024x1024 on the scene of
``bench.py`` (``mesh.uv_sphere(72, 72)``, 10,224 faces, its camera, colors
``RandomState(0)``, zero background, 3 channels), ``loss = sum(pixels *
w)`` with ``w = RandomState(1).rand(1024, 1024, 3)``, gradients to vertices
and colors, ``clip=False``, under honest caps: ``suggest_raster_config``'s,
kept in ``bench_cache/configs_torch.json`` (``utils.configstore``) and
re-validated by one render whose overflow flag must stay clear. ``value``
is 1024 * 1024 / 1e6 over the median of ``SAMPLES`` (20) step times
(``utils.benchtime``: CUDA events around one synchronised call, after
three warm-up calls). ``vs_baseline`` divides it by ``BASELINE_MPIX_S``,
this script's first figure on an H100, never a TPU number.

Then one line per measurement, each starting with ``#``: min and median
ms of the forward alone and of the step, Mpix/s, peak device memory
(``torch.cuda.max_memory_allocated`` over the step) and the roofline
context: the least time the card could take for the same work, the larger
of the bytes the call must move (inputs read once, outputs written once)
over 3.35 TB/s and the float32 operations its covered pixels need over 67
TFLOP/s (an H100 SXM's published peaks). The lines:

1. the tracked step (packed engine, which ``suggest_raster_config`` picks
   for the scene);
2. the dense, the streaming (CSR) and the packed engine side by side, on
   the same scene under each engine's own honest caps;
3. 256x256;
4. 1024x1024 with ``clip=True`` (near-plane clipping, the API's default);
5. the 99,904-face sphere (``mesh.uv_sphere(224, 224)``, same camera)
   under the packed engine (what ``suggest_raster_config`` picks with
   ``clip=False``) and under the streaming engine;
6. the 1,001,112-face sphere (``mesh.uv_sphere(708, 708)``, the scale of
   ``tools/bench_large.py``'s largest cell), the same two engines.

After each of these lines, one starting ``# graphed`` times the same step
as one CUDA-graph replay (``utils.graphstep.GraphedStep``, the counterpart
of the reference's ``jax.jit`` of its step), beside the eager step's min and
median, with the capture's time, the peak memory allocated over capture
and replays and what the graph's private pool reserves between replays.
The tracked first line stays the eager step.

Build time of the kernels and each line's set-up of its honest caps (the
exact counts on the card, ``count_packed_exact`` or the CSR counts, and the
one validating render) are printed apart, as set-up. Without a CUDA device
the script exits non-zero and measures nothing; it never falls back to the
CPU.

``bench_scene`` and ``camera_clip`` build the scene for ``chip_smoke.py``
too, and the roofline helpers serve its kernel records.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# This script's first figure (Mpix/s, tracked line), on one NVIDIA H100
# 80GB HBM3 at a 700.00 W power limit; later runs divide by it.
BASELINE_MPIX_S = 57.24
METRIC = "Mpix/s fwd+bwd, 1024^2, 10k-tri sphere, 1 H100, dirt_tpu_torch"
# Timed calls per measurement; every run of the tracked line takes as many.
SAMPLES = 20

# Published peaks of one H100 SXM: HBM bytes/s and float32 FLOP/s outside
# the tensor cores (the kernels use no tensor core).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12
# Arithmetic of one (pixel, face) coverage and depth test, of one pixel's
# attribute evaluation, and of cotangent_core.cuh for one covered pixel.
TEST_FLOPS = 22
# The kernels the measured paths launch (packed, dense, streaming).
KERNELS = ("raster_fwd_packed", "packed_prologue", "packed_bwd",
           "raster_fwd_dense", "fused_bwd", "raster_fwd_csr", "fused_bwd_csr",
           "max_scan")


def attr_flops(channels):
    return 6 + 5 * channels


def core_flops(channels):
    return 330 + 6 * channels + (12 + 3 * channels)


def bound(nbytes, flops):
    """bound_ms and bound_by: the larger of bytes over the memory rate and
    operations over the float32 peak."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def camera_clip(verts_obj, rot, device):
    """Clip-space vertices [V, 4] under the camera of ``bench.py``:
    Rodrigues ``rot``, 3 units down -z, perspective (near 0.1, far 20,
    focal 0.045, aspect 1)."""
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


def bench_scene(size, device, n=72):
    """The scene of ``bench.py:88-112`` on ``device``: (object-space
    vertices, clip-space vertices, colors ``RandomState(0)``, faces int64,
    zero background [size, size, 3], upstream gradient ``w =
    RandomState(1).rand(size, size, 3)``) of ``mesh.uv_sphere(n, n)``."""
    from dirt_tpu_torch.core import mesh

    verts_obj, faces, _ = mesh.uv_sphere(n_lat=n, n_lon=n)
    verts_obj = torch.as_tensor(verts_obj, device=device)
    rot = torch.tensor([0.4, 0.3, 0.0], device=device)
    clip = camera_clip(verts_obj, rot, device)
    colors = torch.as_tensor(
        np.random.RandomState(0).rand(len(verts_obj), 3)
        .astype(np.float32), device=device,
    )
    faces = torch.as_tensor(faces.astype(np.int64), device=device)
    background = torch.zeros((size, size, 3), device=device)
    weights = torch.as_tensor(
        np.random.RandomState(1).rand(size, size, 3)
        .astype(np.float32), device=device,
    )
    return verts_obj, clip, colors, faces, background, weights


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _floor(scene, covered, step):
    """The least time of a forward (``step`` False) or forward + backward
    to vertices and colors: each input read once and each output written
    once, and the float32 operations of the covered pixels."""
    _, clip, colors, faces, background, _ = scene
    height, width, channels = background.shape
    image = height * width * channels * 4
    inputs = (clip.numel() * 4 + colors.numel() * 4 + faces.numel() * 8
              + image)
    flops = covered * (TEST_FLOPS + attr_flops(channels))
    if not step:
        return bound(inputs + image, flops)
    # The upstream gradient read; vertex and color gradients written.
    return bound(inputs + image + image + clip.numel() * 4
                 + colors.numel() * 4, flops + covered * core_flops(channels))


def engine_of(config, num_faces):
    """The engine that renders ``num_faces`` faces under ``config``."""
    from dirt_tpu_torch.ops import raster

    if raster.streams(config, num_faces):
        return "csr"
    return raster.resolve_engine(config, num_faces)


def _paths(scene, config, clip_flag):
    """(forward, step) of ``scene`` under ``config``: ``forward(verts,
    cols)`` the image, ``step(verts, cols)`` the gradients of ``sum(image *
    w)`` to vertices and colors."""
    import dirt_tpu_torch

    _, _, _, faces, background, weights = scene

    def forward(verts, cols):
        return dirt_tpu_torch.rasterise(background, verts, cols, faces,
                                        config=config, clip=clip_flag)

    def step(verts, cols):
        verts = verts.detach().requires_grad_()
        cols = cols.detach().requires_grad_()
        (forward(verts, cols) * weights).sum().backward()
        return verts.grad, cols.grad

    return forward, step


def measure(label, scene, config, clip_flag, samples):
    """Times of the forward and of the step of ``scene`` under ``config``:
    (the step's (min, median) seconds, the line that reports both)."""
    import dirt_tpu_torch
    from dirt_tpu_torch.utils.benchtime import device_time_stats

    _, clip, colors, faces, background, weights = scene
    height, width = background.shape[:2]
    forward, step = _paths(scene, config, clip_flag)
    pixels, fid, _, overflow = dirt_tpu_torch.rasterise_with_aux(
        background, clip, colors, faces, config=config, clip=clip_flag)
    if bool(overflow):
        raise RuntimeError(f"{label}: the overflow flag is set under {config}")
    covered = int((fid >= 0).sum())
    if covered == 0 or not bool(torch.isfinite(pixels).all()):
        raise RuntimeError(f"{label}: empty or non-finite render")
    fwd = device_time_stats(forward, (clip, colors), samples=samples)
    torch.cuda.reset_peak_memory_stats()
    full = device_time_stats(step, (clip, colors), samples=samples)
    peak = torch.cuda.max_memory_allocated()
    mpix = height * width / 1e6
    lines = []
    for name, (t_min, t_med), floor in (
            ("fwd", fwd, _floor(scene, covered, False)),
            ("fwd+bwd", full, _floor(scene, covered, True))):
        lines.append(
            f"{name} min {t_min * 1e3:.3f} ms median {t_med * 1e3:.3f} ms "
            f"({mpix / t_med:.1f} Mpix/s; bound {floor['bound_ms']:.4g} ms "
            f"by {floor['bound_by']}, median {t_med * 1e3 / floor['bound_ms']:.0f}"
            f"x it)")
    return full, (f"# {label}: {faces.shape[0]} faces {height}x{width} "
                  f"{engine_of(config, faces.shape[0])} engine, {samples} "
                  f"samples each; " + "; ".join(lines)
                  + f"; peak memory {peak / 2**20:.1f} MiB over the step")


def measure_graphed(label, scene, config, clip_flag, samples, eager):
    """The step of ``measure`` as one CUDA-graph replay
    (``utils.graphstep.GraphedStep``), timed as the eager step is, beside
    the eager step's (min, median) seconds ``eager``: the line that reports
    both, with the capture's time (its warm-up calls included), the peak
    memory allocated over capture and replays and the bytes the graph's
    private pool reserves between replays."""
    from dirt_tpu_torch.utils.benchtime import device_time_stats, timed
    from dirt_tpu_torch.utils.graphstep import WARMUP, GraphedStep

    _, clip, colors, faces, background, _ = scene
    height, width = background.shape[:2]
    torch.cuda.reset_peak_memory_stats()
    graphed, capture_s = timed(clip.device, GraphedStep,
                               _paths(scene, config, clip_flag)[1],
                               (clip, colors))
    t_min, t_med = device_time_stats(graphed, (clip, colors),
                                     samples=samples)
    peak = torch.cuda.max_memory_allocated()
    pool = graphed.pool_bytes()
    mpix = height * width / 1e6
    return (f"# graphed {label}: {faces.shape[0]} faces {height}x{width} "
            f"{engine_of(config, faces.shape[0])} engine, {samples} samples "
            f"each; fwd+bwd eager min {eager[0] * 1e3:.3f} ms median "
            f"{eager[1] * 1e3:.3f} ms ({mpix / eager[1]:.1f} Mpix/s), graphed "
            f"min {t_min * 1e3:.3f} ms median {t_med * 1e3:.3f} ms "
            f"({mpix / t_med:.1f} Mpix/s; eager median / graphed median "
            f"{eager[1] / t_med:.2f}); capture ({WARMUP} warm-up calls "
            f"included) {capture_s:.3f} s; peak memory {peak / 2**20:.1f} MiB "
            f"allocated over capture and replays; the graph's private pool "
            f"reserves {pool / 2**20:.1f} MiB, held between replays")


def honest(key, scene, clip_flag, **fields):
    """``configstore.cached_config`` for the scene, with ``fields`` fixed."""
    import dirt_tpu_torch
    from dirt_tpu_torch.utils import configstore

    _, clip, _, faces, background, _ = scene
    height, width = background.shape[:2]
    return configstore.cached_config(
        key, clip, faces, height, width,
        config=dirt_tpu_torch.RasterConfig(**fields), clip=clip_flag)


def main():
    if not torch.cuda.is_available():
        sys.exit("bench_torch: no CUDA device (torch.cuda.is_available() "
                 "is False); this benchmark runs on the card only")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from dirt_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    start = time.perf_counter()
    _build.build(KERNELS)
    build_s = time.perf_counter() - start

    start = time.perf_counter()
    scene = bench_scene(1024, device)
    config = honest("torch_sphere72_1024_auto", scene, False)
    setup_s = time.perf_counter() - start
    (t_min, t_med), line = measure("1024^2 tracked step", scene, config,
                                   False, SAMPLES)
    value = 1024 * 1024 / 1e6 / t_med
    print(json.dumps({
        "metric": METRIC,
        "value": round(value, 2),
        "unit": "Mpix/s",
        "vs_baseline": round(value / BASELINE_MPIX_S, 3),
    }), flush=True)
    print(f"# card: {card_line()}; {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}; kernels built in "
          f"{build_s:.1f} s, caps set up in {setup_s:.1f} s", flush=True)
    print(line + f" (Mpix/s at the min {1024 * 1024 / 1e6 / t_min:.2f})",
          flush=True)
    print(measure_graphed("1024^2 tracked step", scene, config, False,
                          SAMPLES, (t_min, t_med)), flush=True)

    small = bench_scene(256, device)
    big = bench_scene(1024, device, n=224)
    huge = bench_scene(1024, device, n=708)
    for label, key, case, clip_flag, fields in (
            ("1024^2", "sphere72_1024_dense", scene, False,
             dict(engine="dense")),
            ("1024^2", "sphere72_1024_csr", scene, False,
             dict(streaming=True)),
            ("1024^2", "sphere72_1024_packed", scene, False,
             dict(engine="packed")),
            ("256^2", "sphere72_256_auto", small, False, {}),
            ("1024^2 clip=True", "sphere72_1024_auto_clip", scene, True, {}),
            ("99,904-face sphere 1024^2", "sphere224_1024_auto", big, False,
             {}),
            ("99,904-face sphere 1024^2", "sphere224_1024_csr", big, False,
             dict(streaming=True)),
            ("1,001,112-face sphere 1024^2", "sphere708_1024_auto", huge,
             False, {}),
            ("1,001,112-face sphere 1024^2", "sphere708_1024_csr", huge,
             False, dict(streaming=True))):
        start = time.perf_counter()
        cfg = honest(f"torch_{key}", case, clip_flag, **fields)
        setup_s = time.perf_counter() - start
        eager, line = measure(label, case, cfg, clip_flag, SAMPLES)
        print(line + f"; caps set up in {setup_s:.2f} s: {cfg}", flush=True)
        print(measure_graphed(label, case, cfg, clip_flag, SAMPLES, eager),
              flush=True)


if __name__ == "__main__":
    main()
