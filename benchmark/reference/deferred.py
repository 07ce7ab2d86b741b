"""The reference of the ``deferred`` pipeline (DIRT's ``samples/deferred.py``).

Object-space vertices, scaled by ``1 + bump`` per vertex, rotated by the
pose and moved by the camera's offset, give world positions; smooth
normals; the projection gives clip space. A 9-channel G-buffer (position,
normal, uv, mask) is rasterised and shaded per pixel
(``shading.shade_deferred``).
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
from benchmark.reference.shading import shade_deferred, vertex_normals

GBUFFER = (("position", 3), ("normal", 3), ("uv", 2), ("mask", 1))


def prepare(config, inputs, params, prec):
    """(screen faces [F, 3, 4], face attributes [F, 3, 9], background,
    shade): ``shade(gbuffer)`` is the image of a rasterised G-buffer."""
    verts, faces = inputs["verts"], inputs["faces"]
    if "bump" in params:
        verts = verts * (1.0 + params["bump"][:, None])
    camera, size = config["camera"], config["size"]
    world = mm(homogeneous(verts), model_matrix(params["pose"], camera, prec),
               prec)[:, :3]
    normals = vertex_normals(world, faces)
    clip = mm(homogeneous(world),
              perspective(camera, world.dtype, world.device), prec)
    attrs = torch.cat([world, normals, inputs["uvs"],
                       torch.ones_like(world[:, :1])], 1)
    background = torch.zeros((size, size, attrs.shape[1]), dtype=world.dtype,
                             device=world.device)

    def shade(gbuffer):
        parts = torch.split(gbuffer, [n for _, n in GBUFFER], -1)
        return shade_deferred(*parts, inputs["texture"], config["shading"])

    return screen(clip, size, size)[faces], attrs[faces], background, shade
