"""Deferred (per-pixel) shading over a G-buffer, in plain PyTorch.

Counterpart of ``dirt_tpu/render/deferred.py``: normals re-normalised per
pixel, optional bilinear texture lookup via interpolated UVs, Lambertian +
Phong terms, all masked by coverage. It is differentiable w.r.t. every
input (G-buffer, texture, lights, camera), so gradients flow back through
the rasterizer to geometry and pose.

The math runs on the G-buffer's own [H, W, C] layout with the channel axis
last; the JAX package's channels-first detour is a layout device of its
backend.
"""

from __future__ import annotations

import torch

from dirt_tpu_torch.core.lighting import relu_split
from dirt_tpu_torch.core.texture import sample_texture


def _unit(v):
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-12)


def shade_deferred(
    gbuffer,
    light_direction,
    light_color,
    ambient=0.0,
    texture=None,
    albedo=None,
    camera_position=None,
    specular_color=None,
    shininess: float = 16.0,
    background=None,
):
    """Shade a G-buffer with a directional light (+ optional specular).

    Args:
        gbuffer: dict with "normal" [H, W, 3], "mask" [H, W, 1]; "uv"
            [H, W, 2] required when ``texture`` is given; "position"
            [H, W, 3] (world space) required for specular.
        light_direction: [3] unit vector toward the light.
        light_color: [C].
        ambient: scalar or [C] ambient term.
        texture: optional [Ht, Wt, C] texture sampled at the G-buffer UVs.
        albedo: optional [H, W, C] base color (defaults to 1s; multiplied
            with the texture if both given).
        camera_position: [3], enables the Phong specular term.
        specular_color: [C] specular albedo (defaults to light_color).
        background: optional [H, W, C] composited where mask == 0.
    Returns:
        [H, W, C] shaded image, on the device of the G-buffer.
    """
    normal = gbuffer["normal"]
    mask = gbuffer["mask"]
    device = normal.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    n = _unit(normal)
    ldir = f32(light_direction)
    lcol = f32(light_color)

    base = mask * 0.0 + 1.0 if albedo is None else f32(albedo)
    if texture is not None:
        base = base * sample_texture(f32(texture), gbuffer["uv"])

    cos_nl = torch.sum(n * ldir, dim=-1, keepdim=True)
    color = base * (relu_split(cos_nl) * lcol + f32(ambient))

    if camera_position is not None:
        view = _unit(f32(camera_position) - gbuffer["position"])
        reflected = 2.0 * cos_nl * n - ldir
        cos_rv = relu_split(
            torch.sum(reflected * view, dim=-1, keepdim=True))
        spec_col = lcol if specular_color is None else f32(specular_color)
        lit = (cos_nl > 0.0).to(color.dtype)
        color = color + spec_col * lit * torch.pow(cos_rv, shininess)

    color = color * mask
    if background is not None:
        color = color + f32(background) * (1.0 - mask)
    return color
