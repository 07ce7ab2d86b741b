"""The reference of the ``vertex_color`` pipeline: per-vertex colours,
rasterised as they are, under the camera ``[v, 1] @ (model @ projection)``
(``bench.py``'s)."""

from __future__ import annotations

import torch

from benchmark.reference.camera import (
    homogeneous,
    mm,
    model_matrix,
    perspective,
)
from benchmark.reference.raster import screen


def prepare(config, inputs, params, prec):
    """(screen faces, face colours [F, 3, C], background, shade = the
    identity)."""
    verts, faces = inputs["verts"], inputs["faces"]
    camera, size = config["camera"], config["size"]
    matrix = mm(model_matrix(params["pose"], camera, prec),
                perspective(camera, verts.dtype, verts.device), prec)
    clip = mm(homogeneous(verts), matrix, prec)
    colors = params["colors"]
    background = torch.zeros((size, size, colors.shape[1]),
                             dtype=verts.dtype, device=verts.device)
    return (screen(clip, size, size)[faces], colors[faces], background,
            lambda pixels: pixels)
