"""Public rasterization API (PyTorch).

Counterpart of ``dirt_tpu/rasterise_ops.py``: ``rasterise`` renders one
mesh, ``rasterise_with_aux`` also returns face ids, depth and the overflow
flag, ``rasterise_batch`` renders a batch of views of one mesh, and
``suggest_raster_config`` measures caps that cannot overflow. All three
renderers are differentiable with respect to background, vertices and
vertex colors.
Vertices are OpenGL-style clip-space homogeneous coordinates ``[V, 4]``;
``vertex_colors`` may carry any number of channels; ``faces`` is an
``[F, 3]`` integer triangle list. Everything runs on the device of
``vertices``; the background keeps the ``[H, W, C]`` layout.

The per-face vertex gather is plain ``verts[faces]`` indexing: the JAX
package's incidence-table gather exists because XLA's scatter-add is slow
on a TPU, and has no counterpart here.
"""

from __future__ import annotations

import torch

from dirt_tpu_torch.ops.clipping import clip_compact_screen, inside_counts
from dirt_tpu_torch.ops.raster import (
    STREAMING_FACES,
    RasterConfig,
    rasterize_screen,
    suggest_config,
)
from dirt_tpu_torch.ops.triangle_setup import screen_from_clip
from dirt_tpu_torch.utils import trace


def _auto_clip_cap(num_faces: int) -> int:
    """Default secondary-slot budget: 1/32 of the mesh, at least 64.

    Faces crossing the near plane form a curve through the mesh, not an
    area; overflow is flagged on the API and ``suggest_raster_config``
    measures the exact requirement.
    """
    return min(max(num_faces // 32, 64), num_faces)


def _as_inputs(vertices, vertex_colors, faces):
    vertices = torch.as_tensor(vertices, dtype=torch.float32)
    device = vertices.device
    vertex_colors = torch.as_tensor(
        vertex_colors, dtype=torch.float32, device=device
    )
    faces = torch.as_tensor(faces, device=device).to(torch.int64)
    if faces.numel() == 0:
        raise ValueError(f"faces is empty (shape {list(faces.shape)}): "
                         f"there is no triangle to rasterise")
    return vertices, vertex_colors, faces


def _resolve_background(background, height, width, channels, device):
    if background is not None:
        return torch.as_tensor(background, dtype=torch.float32, device=device)
    if height is None or width is None or channels is None:
        raise ValueError(
            "height, width and channels must be given when background is None"
        )
    return torch.zeros((height, width, channels), dtype=torch.float32,
                       device=device)


def _clip_space_faces(vertices, vertex_colors, faces, height, width,
                      config, clip):
    """Gather per-face data and (optionally) near-plane clip it.

    Returns (face_verts, face_attrs, config, orig_id, clip_overflow) —
    ``orig_id`` maps raster slot -> original face id (None when
    ``clip=False``, where it is the identity), ``clip_overflow`` flags
    dropped secondaries.
    """
    num_faces = faces.shape[0]
    if clip:
        cap = config.clip_cap
        if cap is None:
            cap = _auto_clip_cap(num_faces)
        cap = min(cap, num_faces)
        with trace.span("clip", vertices):
            face_verts, fa_c, orig_id, clip_ovf = clip_compact_screen(
                vertices[faces], vertex_colors[faces], cap, height, width
            )
        if config.streaming is None:
            config = config._replace(streaming=num_faces > STREAMING_FACES)
        return face_verts, fa_c, config, orig_id, clip_ovf
    verts_screen = screen_from_clip(vertices, height, width)
    no_overflow = torch.zeros((), dtype=torch.bool, device=vertices.device)
    return (
        verts_screen[faces], vertex_colors[faces], config, None, no_overflow
    )


def _rasterise_core(background, vertices, vertex_colors, faces, config,
                    clip):
    h, w = background.shape[0], background.shape[1]
    face_verts, face_attrs, config, orig_id, clip_ovf = _clip_space_faces(
        vertices, vertex_colors, faces, h, w, config, clip
    )
    pixels, fid, zbuf, overflow = rasterize_screen(
        face_verts, face_attrs, background, config
    )
    if orig_id is not None:
        # Clipped sub-triangles live at compacted slots; report the
        # ORIGINAL face id like the reference would.
        orig = orig_id.to(torch.int32)[torch.clamp(fid, min=0).long()]
        fid = torch.where(fid >= 0, orig, fid)
    return pixels, fid, zbuf, overflow | clip_ovf


def rasterise(
    background, vertices, vertex_colors, faces,
    height=None, width=None, channels=None,
    config: RasterConfig | None = None, clip: bool = True,
):
    """Rasterize one triangle mesh with z-buffering and attribute interp.

    Args:
        background: [H, W, C] image the mesh is composited over, or None
            (zeros; then height/width/channels are required).
        vertices: [V, 4] clip-space positions.
        vertex_colors: [V, C] per-vertex attributes.
        faces: [F, 3] integer vertex indices.
        clip: near-plane clip faces crossing w = 0 in homogeneous space
            (GL parity). Set False when geometry is known to be entirely
            in front of the camera; crossing faces are then culled whole.
    Returns:
        [H, W, C] rendered image.
    """
    vertices, vertex_colors, faces = _as_inputs(vertices, vertex_colors,
                                                faces)
    background = _resolve_background(
        background, height, width, channels, vertices.device
    )
    return _rasterise_core(
        background, vertices, vertex_colors, faces,
        config or RasterConfig(), clip,
    )[0]


def rasterise_with_aux(
    background, vertices, vertex_colors, faces,
    config: RasterConfig | None = None, clip: bool = True,
):
    """Like ``rasterise`` but also returns non-diff aux outputs.

    Returns:
        (pixels [H, W, C], fid [H, W] int32, zbuf [H, W] f32,
         overflow [] bool tensor). ``overflow`` True means a static cap
        truncated faces and the image may be missing coverage — rebuild
        the config with :func:`suggest_raster_config` and re-render.
    """
    vertices, vertex_colors, faces = _as_inputs(vertices, vertex_colors,
                                                faces)
    background = torch.as_tensor(background, dtype=torch.float32,
                                 device=vertices.device)
    return _rasterise_core(
        background, vertices, vertex_colors, faces,
        config or RasterConfig(), clip,
    )


def rasterise_batch(
    background, vertices, vertex_colors, faces,
    height=None, width=None, channels=None,
    config: RasterConfig | None = None, clip: bool = True,
):
    """Batched rasterization over the leading dim of background, vertices
    and vertex_colors (multi-view fitting).

    ``faces`` is shared across the batch. Scenes render one after another
    (a single render already fills the card) and the images are stacked:
    [B, H, W, C]. ``background`` None means zeros of the given size.
    """
    vertices, vertex_colors, faces = _as_inputs(vertices, vertex_colors,
                                                faces)
    if background is None:
        background = _resolve_background(
            None, height, width, channels, vertices.device
        ).expand(vertices.shape[0], -1, -1, -1)
    return torch.stack([
        rasterise(bg, verts, colors, faces, config=config, clip=clip)
        for bg, verts, colors in zip(background, vertices, vertex_colors)
    ])


def suggest_raster_config(
    vertices, faces, height: int, width: int,
    config: RasterConfig | None = None, margin: float = 1.25,
    clip: bool = True,
):
    """Count-then-allocate: a RasterConfig that cannot overflow this scene.

    Measures exact occupancy and spans for the given clip-space geometry
    (host-synchronizing) and returns a concrete config with just-large-
    enough caps. ``clip`` must match the flag later passed to
    ``rasterise`` so the measured face set is the rendered one.
    """
    vertices = torch.as_tensor(vertices, dtype=torch.float32).detach()
    faces = torch.as_tensor(faces, device=vertices.device).to(torch.int64)
    config = config or RasterConfig()
    if clip and config.clip_cap is None:
        # Exact secondary-slot requirement, so the compaction cannot
        # overflow for this geometry.
        live = int(torch.sum(inside_counts(vertices[faces]) == 2))
        cap = min(max(int(live * margin), 8), faces.shape[0])
        config = config._replace(clip_cap=cap)
    dummy = torch.zeros((vertices.shape[0], 1), dtype=torch.float32,
                        device=vertices.device)
    face_verts, _, config, _, _ = _clip_space_faces(
        vertices, dummy, faces, height, width, config, clip
    )
    return suggest_config(face_verts, height, width, config, margin)
