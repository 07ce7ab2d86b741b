#!/usr/bin/env python3
"""Per-config benchmark of dirt_tpu_torch on one CUDA card (H100).

    python3 bench_configs_torch.py

Port of ``bench_configs.py``: the five capability configs, one line each
with the forward and the gradient step (``loss = sum(image * w)``, ``w =
RandomState(1).rand(size, size, C)``, backward to every leaf), eager and as
CUDA-graph replays (``utils.graphstep``: the counterpart of the JAX sheet's
jitted device-side loop), min and median of ``SAMPLES`` event-timed
synchronised calls (``utils.benchtime``), Mpix/s at the median, peak device
memory over the eager step, the graphs' capture time and pool bytes. Every
config renders under count-then-allocate caps (``suggest_raster_config``) whose
overflow flag one render must leave clear (:func:`honest`, as
``bench_configs._honest``; the JAX sheet uses them from config 3 on, here
configs 1-2 take them too):

1. one flat triangle, orthographic, 64 x 64, 1 channel (dense engine);
2. the 12-face cube, perspective, random vertex colors, 256 x 256;
3. a 2,208-face UV sphere's UV G-buffer + bilinear texture lookup, 512 x
   512, gradients to the clip-space vertices and the texture;
4. the same sphere with diffuse + specular vertex shading, 512 x 512,
   gradients to the light direction and the pose;
5. deferred shading of the 10,224-face sphere (9-channel G-buffer,
   texture, Phong), 1024 x 1024, gradients to the vertices and the pose
   (packed engine).

The scenes live here once: ``chip_smoke.py`` and ``tools/`` import
:data:`CONFIGS`, and ``demos/torch_demo5_deferred.py`` builds config 5's
scene and caps through :func:`deferred_scene`. Without a CUDA device the
script exits non-zero and measures nothing.
"""

import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import bench_torch  # noqa: E402

SAMPLES = 20
POSE = (0.4, 0.3, 0.0)


class Config(NamedTuple):
    """One config: ``forward(*leaves)`` the image, ``loss(*leaves)`` the
    scalar ``sum(image * w)``, under ``raster`` (the honest caps)."""

    name: str
    size: int
    forward: Callable
    loss: Callable
    leaves: tuple
    raster: object


def weights(size, channels, device):
    """``RandomState(1).rand(size, size, channels)`` as float32."""
    return torch.as_tensor(
        np.random.RandomState(1).rand(size, size, channels)
        .astype(np.float32), device=device)


def honest(clip, faces, size):
    """Count-then-allocate caps, and a hard check that one render under them
    is untruncated (a time is only meaningful for a complete render)."""
    import dirt_tpu_torch

    config = dirt_tpu_torch.suggest_raster_config(clip, faces, size, size)
    device = clip.device
    overflow = dirt_tpu_torch.rasterise_with_aux(
        torch.zeros((size, size, 3), device=device), clip,
        torch.zeros((clip.shape[0], 3), device=device), faces,
        config=config)[3]
    if bool(overflow):
        raise RuntimeError(f"the suggested caps overflow: {config}")
    return config


def posed(verts_obj, device):
    """Clip-space vertices at :data:`POSE` under the bench camera
    (``bench_torch.camera_clip``, as ``bench_configs._posed``)."""
    return bench_torch.camera_clip(
        verts_obj, torch.tensor(POSE, device=device), device)


def deferred_scene(n_lat, n_lon, size, device):
    """(verts_obj, faces, uvs, texture, projection, raster) of config 5 and
    demo 5: ``uv_sphere(n_lat, n_lon)``, the 128 x 128 checkerboard of 10
    squares, the bench projection, under :func:`honest` caps at
    :data:`POSE`."""
    from dirt_tpu_torch import entry

    verts_obj, faces, uvs, texture, projection = entry.deferred_scene(
        n_lat, n_lon, device, checker=(128, 10))
    raster = honest(posed(verts_obj, device), faces, size)
    return verts_obj, faces, uvs, texture, projection, raster


def _sphere(n_lat, n_lon, device):
    """(object-space vertices, faces int64, uvs) of a UV sphere."""
    from dirt_tpu_torch.core import mesh

    verts, faces, uvs = mesh.uv_sphere(n_lat=n_lat, n_lon=n_lon)
    return (torch.as_tensor(verts, device=device),
            torch.as_tensor(faces.astype(np.int64), device=device),
            torch.as_tensor(uvs, device=device))


def _weighted(name, size, forward, leaves, raster, channels, device):
    w = weights(size, channels, device)
    return Config(name, size, forward,
                  lambda *args: (forward(*args) * w).sum(), leaves, raster)


def config1(device):
    import dirt_tpu_torch

    size = 64
    verts = torch.tensor([[-0.5, -0.5, 0, 1], [0.5, -0.5, 0, 1],
                          [0.0, 0.6, 0, 1]], device=device)
    colors = torch.ones((3, 1), device=device)
    faces = torch.tensor([[0, 1, 2]], device=device)
    background = torch.zeros((size, size, 1), device=device)
    raster = honest(verts, faces, size)

    def forward(v):
        return dirt_tpu_torch.rasterise(background, v, colors, faces,
                                        config=raster)

    return _weighted("config1 single-tri flat ortho 64^2", size, forward,
                     (verts,), raster, 1, device)


def config2(device):
    import dirt_tpu_torch
    from dirt_tpu_torch.core import mesh

    size = 256
    verts_obj, faces = mesh.cube()
    clip = posed(torch.as_tensor(verts_obj, device=device), device)
    colors = torch.as_tensor(np.random.RandomState(0).rand(
        len(verts_obj), 3).astype(np.float32), device=device)
    faces = torch.as_tensor(faces.astype(np.int64), device=device)
    background = torch.zeros((size, size, 3), device=device)
    raster = honest(clip, faces, size)

    def forward(c, co):
        return dirt_tpu_torch.rasterise(background, c, co, faces,
                                        config=raster)

    return _weighted("config2 cube zbuffer perspective 256^2", size,
                     forward, (clip, colors), raster, 3, device)


def config3(device):
    from dirt_tpu_torch.core import mesh
    from dirt_tpu_torch.core.texture import sample_texture
    from dirt_tpu_torch.render.gbuffer import render_gbuffer

    size = 512
    verts_obj, faces, uvs = _sphere(24, 48, device)
    clip = posed(verts_obj, device)
    texture = torch.as_tensor(mesh.checkerboard_texture(128, 10, 3),
                              device=device)
    raster = honest(clip, faces, size)

    def forward(c, tex):
        gb = render_gbuffer(c, faces, {"uv": uvs}, size, size, config=raster)
        return sample_texture(tex, gb["uv"]) * gb["mask"]

    return _weighted("config3 textured UV + bilinear grads 512^2", size,
                     forward, (clip, texture), raster, 3, device)


def config4(device):
    import dirt_tpu_torch
    from dirt_tpu_torch.core import lighting, matrices

    size = 512
    verts_obj, faces, _ = _sphere(24, 48, device)
    pose = torch.tensor(POSE, device=device)
    raster = honest(posed(verts_obj, device), faces, size)
    white = torch.ones((verts_obj.shape[0], 3), device=device)
    background = torch.zeros((size, size, 3), device=device)
    projection = matrices.perspective_projection(
        0.1, 20.0, 0.045, 1.0).to(device)
    one3 = torch.ones(3, device=device)
    offset = torch.tensor([0.0, 0.0, -3.0], device=device)

    def forward(light, pose):
        model_view = matrices.compose(matrices.rodrigues(pose),
                                      matrices.translation(offset))
        world = matrices.transform_homogeneous(verts_obj, model_view)[..., :3]
        normals = lighting.vertex_normals(world, faces)
        direction = light / torch.linalg.norm(light)
        shaded = lighting.diffuse_directional(
            normals, white, direction, one3
        ) + lighting.specular_directional(
            world, normals, white, torch.zeros(3, device=device), direction,
            one3, 24.0)
        clip = torch.cat([world, torch.ones_like(world[:, :1])], 1) \
            @ projection
        return dirt_tpu_torch.rasterise(background, clip, shaded, faces,
                                        config=raster)

    light = torch.tensor([0.3, 0.8, 0.52], device=device)
    return _weighted("config4 lit lambert+specular grads 512^2", size,
                     forward, (light, pose), raster, 3, device)


def config5(device, size=1024, n_lat=72, n_lon=72):
    """The deferred pipeline; ``forward(verts, pose, **kwargs)`` is
    ``entry.deferred_render`` (``with_gbuffer=True`` also returns the
    G-buffer). ``size`` and the sphere's ``n_lat`` x ``n_lon`` cut it down
    for the CPU tests."""
    from dirt_tpu_torch import entry

    verts_obj, faces, uvs, texture, projection, raster = deferred_scene(
        n_lat, n_lon, size, device)
    pose = torch.tensor(POSE, device=device)

    def forward(verts, pose, **kwargs):
        return entry.deferred_render(verts, pose, faces, uvs, texture,
                                     projection, size, raster, **kwargs)

    return _weighted("config5 deferred 10k-tri inverse 1024^2", size,
                     forward, (verts_obj, pose), raster, 3, device)


CONFIGS = (config1, config2, config3, config4, config5)


def gradient_step(config):
    """``step(*leaves)``: ``loss.backward()`` to every leaf; returns the
    gradients."""
    def step(*leaves):
        leaves = [t.detach().requires_grad_() for t in leaves]
        config.loss(*leaves).backward()
        return [t.grad for t in leaves]

    return step


def forward_step(config):
    """``forward(*leaves)``: the image, without autograd."""
    def forward(*leaves):
        with torch.no_grad():
            return config.forward(*leaves)

    return forward


def graphed_steps(config):
    """(forward, gradient step) of ``config`` as CUDA-graph replays
    (``utils.graphstep.GraphedStep``, captured here on ``config.leaves``),
    the port's counterpart of the JAX sheet's jitted device-side loop: the
    forward returns the image, the step ``(loss, *gradients)``
    (``graphstep.value_and_grad``). The outputs are the graphs' own
    tensors, overwritten by the next call."""
    from dirt_tpu_torch.utils.graphstep import GraphedStep, value_and_grad

    return (GraphedStep(forward_step(config), config.leaves),
            GraphedStep(value_and_grad(config.loss), config.leaves))


def report(config):
    """The config's line: forward and gradient step, eager and as
    CUDA-graph replays (:func:`graphed_steps`), min and median ms, Mpix/s
    at the median; peak memory over the eager step, the graphs' capture
    time and the bytes their private pools hold."""
    from dirt_tpu_torch.utils.benchtime import device_time_stats, timed

    fwd = device_time_stats(forward_step(config), config.leaves,
                            samples=SAMPLES)
    torch.cuda.reset_peak_memory_stats()
    step = device_time_stats(gradient_step(config), config.leaves,
                             samples=SAMPLES)
    peak = torch.cuda.max_memory_allocated()
    (g_fwd, g_step), capture_s = timed(config.leaves[0].device,
                                       graphed_steps, config)
    fwd_g = device_time_stats(g_fwd, config.leaves, samples=SAMPLES)
    step_g = device_time_stats(g_step, config.leaves, samples=SAMPLES)
    pool = g_fwd.pool_bytes() + g_step.pool_bytes()
    mpix = config.size * config.size / 1e6
    return (f"{config.name:44s} fwd min {fwd[0] * 1e3:8.3f} median "
            f"{fwd[1] * 1e3:8.3f} ms ({mpix / fwd[1]:7.1f} Mpix/s)   "
            f"grad-step min {step[0] * 1e3:8.3f} median {step[1] * 1e3:8.3f}"
            f" ms ({mpix / step[1]:6.1f} Mpix/s)   peak {peak / 2**20:.1f} "
            f"MiB; graphed fwd min {fwd_g[0] * 1e3:.3f} median "
            f"{fwd_g[1] * 1e3:.3f} ms, grad-step min {step_g[0] * 1e3:.3f} "
            f"median {step_g[1] * 1e3:.3f} ms ({mpix / step_g[1]:.1f} "
            f"Mpix/s; eager median / graphed median {fwd[1] / fwd_g[1]:.2f} "
            f"and {step[1] / step_g[1]:.2f}), both captured in "
            f"{capture_s:.3f} s, pools {pool / 2**20:.1f} MiB; overflow "
            f"clear under {config.raster}")


def main():
    if not torch.cuda.is_available():
        sys.exit("bench_configs_torch: no CUDA device "
                 "(torch.cuda.is_available() is False); it runs on the card "
                 "only")
    from dirt_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    start = time.perf_counter()
    _build.build(bench_torch.KERNELS)
    print(f"# card: {bench_torch.card_line()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; kernels built in "
          f"{time.perf_counter() - start:.1f} s; {SAMPLES} samples each",
          flush=True)
    for make in CONFIGS:
        print(report(make(device)), flush=True)


if __name__ == "__main__":
    main()
