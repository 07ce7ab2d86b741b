"""The reference of the ``lit`` pipeline: per-vertex Lambert and Phong
shading from a directional light (upstream DIRT's ``dirt.lighting``), then
the shaded colours rasterised as they are, under the camera ``[v, 1] @
model`` for world positions and ``[world, 1] @ projection`` for clip space.

The shading, written from DIRT's definitions, per vertex with unit normal
n (``shading.vertex_normals``), light direction l (``light`` over its
length), view direction v (``unit(camera - position)``) and reflection r
= 2 (n.l) n - l:

    diffuse  = albedo * light_color * max(n.l, 0)
    specular = specular_albedo * light_color * [n.l > 0] * max(r.v, 0)^shininess

Conventions the port's ``core/lighting.py`` has to make alike:

* ``max(x, 0)`` passes one half of the gradient at x = 0 (written here as
  ``(x + |x|) / 2``; the port's ``relu_split``);
* one-sided: a vertex turned away from the light (n.l <= 0) gets neither
  term. Upstream's specular has no ``[n.l > 0]``: its reflection is the
  same about -n, which would light the far side of a mesh; ``dirt_tpu``
  and the port mask it, and so does the reference;
* unit vectors as ``x / sqrt(|x|^2 + 1e-12)`` (normals, view), the light as
  ``l / |l|``, as the pipeline normalises it before the call.
"""

from __future__ import annotations

import torch

from benchmark.reference.camera import (
    homogeneous,
    mm,
    model_matrix,
    perspective,
)
from benchmark.reference.raster import screen
from benchmark.reference.shading import unit, vertex_normals


def _relu(x):
    """max(x, 0) with the gradient one half at 0."""
    return 0.5 * (x + torch.abs(x))


def shade(world, normals, light, shading: dict):
    """[V, 3] colours of the vertices at ``world`` with unit ``normals``
    under the (not normalised) ``light``; ``shading`` gives
    ``light_color``, ``albedo``, ``specular_albedo``, ``shininess`` and
    ``camera_position``."""
    dtype, device = world.dtype, world.device

    def const(key):
        return torch.as_tensor(shading[key], dtype=dtype, device=device)

    light = light / torch.sqrt(torch.sum(light * light))
    color_l = const("light_color")
    cos_nl = torch.sum(normals * light, -1, keepdim=True)
    diffuse = const("albedo") * color_l * _relu(cos_nl)
    view = unit(const("camera_position") - world)
    reflected = 2.0 * cos_nl * normals - light
    cos_rv = _relu(torch.sum(reflected * view, -1, keepdim=True))
    lit = (cos_nl > 0.0).to(dtype)
    specular = (shading["specular_albedo"] * color_l * lit
                * torch.pow(cos_rv, shading["shininess"]))
    return diffuse + specular


def prepare(config, inputs, params, prec):
    """(screen faces [F, 3, 4], shaded face colours [F, 3, 3], background,
    shade = the identity)."""
    verts, faces = inputs["verts"], inputs["faces"]
    camera, size = config["camera"], config["size"]
    world = mm(homogeneous(verts), model_matrix(params["pose"], camera, prec),
               prec)[:, :3]
    normals = vertex_normals(world, faces)
    colors = shade(world, normals, params["light"], config["shading"])
    clip = mm(homogeneous(world),
              perspective(camera, world.dtype, world.device), prec)
    background = torch.zeros((size, size, colors.shape[1]),
                             dtype=world.dtype, device=world.device)
    return (screen(clip, size, size)[faces], colors[faces], background,
            lambda pixels: pixels)
