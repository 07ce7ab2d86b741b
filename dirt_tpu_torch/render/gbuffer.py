"""G-buffer rendering: rasterize arbitrary named attribute sets in one pass.

Counterpart of ``dirt_tpu/render/gbuffer.py``: world positions / normals /
UVs / mask are barycentrically interpolated into image-space buffers by a
single rasterization, and shading happens per pixel afterwards in plain
PyTorch (``dirt_tpu_torch.render.deferred``).

All channels ride one raster launch: attributes are concatenated on the
channel axis, rasterized, and split back by name.
"""

from __future__ import annotations

import torch

from dirt_tpu_torch.ops.raster import RasterConfig
from dirt_tpu_torch.rasterise_ops import _as_inputs, _rasterise_core


def render_gbuffer(
    vertices_clip, faces, attributes, height: int, width: int,
    config: RasterConfig | None = None, include_mask: bool = True,
    clip: bool = True,
):
    """Rasterize named per-vertex attributes into image-space buffers.

    Args:
        vertices_clip: [V, 4] clip-space positions.
        faces: [F, 3] integers.
        attributes: dict name -> [V, K] per-vertex attributes.
        include_mask: add a "mask" buffer (1 where covered, 0 background).
        clip: near-plane clip crossing faces (GL parity; see
            ``rasterise_ops.rasterise``). "fid" reports original face ids.
    Returns:
        dict name -> [H, W, K] buffers (plus "mask" -> [H, W, 1]) and
        "fid", "zbuf", "overflow"; differentiable w.r.t. vertices and
        attribute values. Everything lives on the device of
        ``vertices_clip``.
    """
    vertices_clip = torch.as_tensor(vertices_clip, dtype=torch.float32)
    device = vertices_clip.device
    names = list(attributes.keys())
    parts = [torch.as_tensor(attributes[n], dtype=torch.float32,
                             device=device) for n in names]
    if include_mask:
        parts.append(torch.ones((vertices_clip.shape[0], 1),
                                dtype=torch.float32, device=device))
        names.append("mask")
    widths = [p.shape[-1] for p in parts]
    vertices_clip, stacked, faces = _as_inputs(
        vertices_clip, torch.cat(parts, dim=-1), faces)  # [V, sum(K)]

    background = torch.zeros((height, width, stacked.shape[-1]),
                             dtype=torch.float32, device=device)
    pixels, fid, zbuf, overflow = _rasterise_core(
        background, vertices_clip, stacked, faces, config or RasterConfig(),
        clip,
    )
    out = dict(zip(names, torch.split(pixels, widths, dim=-1)))
    out["fid"] = fid
    out["zbuf"] = zbuf
    out["overflow"] = overflow
    return out
