"""The reference of the ``textured`` pipeline (upstream DIRT's
``samples/textured.py``): the mesh's UVs and a coverage mask rasterised
under the camera ``[v, 1] @ (model @ projection)``, then the texture
looked up bilinearly at each pixel's UV with clamped edges
(``shading.sample_bilinear``) and masked.

``steps.loss_and_grads`` differentiates the lookup exactly, as TF's
autodiff did after DIRT's ``rasterise``: the texture's gradient comes
through ``shade`` alone, the pose's through the UVs and the raster. The
matrix products run in float64 (``prec="tf32"``: the control's rounding,
``camera.mm``), never on TF32 units.
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
from benchmark.reference.shading import sample_bilinear


def prepare(config, inputs, params, prec):
    """(screen faces [F, 3, 4], face attributes [F, 3, 3] (u, v, 1),
    background, shade): ``shade(pixels)`` is the masked lookup of
    ``params["texture"]`` at the rasterised UVs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    verts, faces = inputs["verts"], inputs["faces"]
    camera, size = config["camera"], config["size"]
    matrix = mm(model_matrix(params["pose"], camera, prec),
                perspective(camera, verts.dtype, verts.device), prec)
    clip = mm(homogeneous(verts), matrix, prec)
    attrs = torch.cat([inputs["uvs"], torch.ones_like(verts[:, :1])], 1)
    background = torch.zeros((size, size, attrs.shape[1]), dtype=verts.dtype,
                             device=verts.device)
    texture = params["texture"]

    def shade(pixels):
        return sample_bilinear(texture, pixels[..., :2]) * pixels[..., 2:]

    return screen(clip, size, size)[faces], attrs[faces], background, shade
