"""Normals, texture lookup and deferred Phong shading of the reference."""

from __future__ import annotations

import torch


def vertex_normals(vertices, faces):
    """Area-weighted smooth normals [V, 3]: each face's cross product
    ``(v1 - v0) x (v2 - v0)`` added to its three vertices, normalised as
    ``n / sqrt(|n|^2 + 1e-12)``."""
    v0, v1, v2 = (vertices[faces[:, k]] for k in range(3))
    cross = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    acc = torch.zeros_like(vertices)
    for k in range(3):
        acc = acc.index_add(0, faces[:, k], cross)
    return acc / torch.sqrt(torch.sum(acc * acc, -1, keepdim=True) + 1e-12)


def unit(v):
    return v / torch.sqrt(torch.sum(v * v, -1, keepdim=True) + 1e-12)


def sample_bilinear(texture, uv):
    """Bilinear lookup with clamped edges: u right and v up in [0, 1], (0,
    0) the bottom-left texel corner; texel (r, c) has its centre at u = (c
    + 0.5) / Wt, v = 1 - (r + 0.5) / Ht."""
    ht, wt, channels = texture.shape
    u = (uv[..., 0] * wt - 0.5).clamp(0.0, wt - 1.0)
    v = ((1.0 - uv[..., 1]) * ht - 0.5).clamp(0.0, ht - 1.0)
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    c0, r0 = u0.long(), v0.long()
    c1, r1 = (c0 + 1).clamp(max=wt - 1), (r0 + 1).clamp(max=ht - 1)
    flat = texture.reshape(-1, channels)

    def texel(r, c):
        return flat[(r * wt + c).reshape(-1)].reshape(*r.shape, channels)

    top = texel(r0, c0) * (1.0 - fu) + texel(r0, c1) * fu
    bottom = texel(r1, c0) * (1.0 - fu) + texel(r1, c1) * fu
    return top * (1.0 - fv) + bottom * fv


def shade_deferred(position, normal, uv, mask, texture, shading: dict):
    """[H, W, C] colour of a G-buffer: the texture times (Lambert +
    ambient), plus a Phong highlight where the normal faces the light, all
    times the mask. ``shading`` gives ``light`` (towards the light, not yet
    of unit length), ``light_color``, ``ambient``, ``shininess`` and
    ``camera_position``."""
    dtype, device = normal.dtype, normal.device

    def const(key):
        return torch.as_tensor(shading[key], dtype=dtype, device=device)

    light = const("light")
    light = light / torch.sqrt(torch.sum(light * light))
    color_l = const("light_color")
    n = unit(normal)
    base = sample_bilinear(texture, uv)
    cos_nl = torch.sum(n * light, -1, keepdim=True)
    color = base * (torch.clamp(cos_nl, min=0.0) * color_l
                    + shading["ambient"])
    view = unit(const("camera_position") - position)
    reflected = 2.0 * cos_nl * n - light
    cos_rv = torch.clamp(torch.sum(reflected * view, -1, keepdim=True),
                         min=0.0)
    lit = (cos_nl > 0.0).to(dtype)
    color = color + color_l * lit * torch.pow(cos_rv, shading["shininess"])
    return color * mask
