"""Vertex normals and per-vertex lighting models (PyTorch).

Counterpart of ``dirt_tpu/core/lighting.py``: ``vertex_normals``,
``vertex_normals_pre_split``, ``split_vertices_by_face``,
``diffuse_directional``, ``specular_directional``.

Conventions:

* Meshes are counter-clockwise wound when viewed from outside; normals point
  outward.
* ``light_direction`` is the unit vector pointing **from the surface toward
  the light** (so a light overhead along +y has direction (0, 1, 0)).
* All functions broadcast over leading batch dimensions of the vertex
  tensors; ``faces`` is shared across the batch (``[F, 3]`` integers).

The face -> vertex sums, and the backward of the vertex gathers, are
``index_put_(accumulate=True)`` calls: on a CUDA device they sort the
indices and sum each vertex's terms in that order, so normals and their
gradients repeat bit for bit run to run. ``index_add_`` and
``index_select``'s backward sum with atomics there, which made two eager
gradient steps of demo 5 differ.

On the card, ``vertex_normals``, ``diffuse_directional`` and
``specular_directional`` each run inside a ``shade`` span
(``utils/trace.py``) where no other span is open: two markers a call.
"""

from __future__ import annotations

import torch

from dirt_tpu_torch.utils import trace


def _f32(x, like=None):
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _faces(faces, device):
    return torch.as_tensor(faces, device=device).to(torch.int64)


def _face_cross_products(vertices, faces):
    """Unnormalised face normals (2x face area magnitude), [..., F, 3]."""
    v0, v1, v2 = (vertices[..., faces[:, k], :] for k in range(3))
    return torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)


def _add_at_vertices(acc, index, rows):
    """``acc`` [..., V, D] with ``rows`` [..., F, D] added at the vertices
    ``index`` [F], as a sorted (repeatable) sum."""
    return acc.movedim(-2, 0).index_put(
        (index,), rows.movedim(-2, 0), accumulate=True).movedim(0, -2)


def vertex_normals(vertices, faces, epsilon: float = 1e-12):
    """Area-weighted smooth vertex normals.

    Each face's (unnormalised) normal is added to its three vertices (the
    cross-product magnitude is twice the face area, giving the usual area
    weighting), then normalised.

    Args:
        vertices: [..., V, 3] float.
        faces: [F, 3] integers.
    Returns:
        [..., V, 3] unit normals.
    """
    vertices = _f32(vertices)
    faces = _faces(faces, vertices.device)
    with trace.outer_span("shade", vertices):
        cross = _face_cross_products(vertices, faces)  # [..., F, 3]
        acc = torch.zeros_like(vertices)
        for k in range(3):
            acc = _add_at_vertices(acc, faces[:, k], cross)
        norm = torch.sqrt(torch.sum(acc * acc, dim=-1, keepdim=True)
                          + epsilon)
        return acc / norm


def split_vertices_by_face(vertices, faces):
    """Duplicate vertices so every face owns a private copy of its corners.

    Used for flat shading and per-face attributes.

    Args:
        vertices: [..., V, D] float.
        faces: [F, 3] integers.
    Returns:
        (new_vertices [..., F*3, D], new_faces [F, 3] = arange(F*3)).
    """
    vertices = _f32(vertices)
    faces = _faces(faces, vertices.device)
    new_vertices = vertices.index_select(-2, faces.reshape(-1))
    new_faces = torch.arange(
        faces.shape[0] * 3, dtype=torch.int32, device=vertices.device
    ).reshape(-1, 3)
    return new_vertices, new_faces


def vertex_normals_pre_split(vertices, faces, epsilon: float = 1e-12):
    """Normals for a mesh already split by ``split_vertices_by_face``.

    Every vertex belongs to exactly one face, so its normal is that face's
    unit normal (flat shading).
    """
    vertices = _f32(vertices)
    faces = _faces(faces, vertices.device)
    cross = _face_cross_products(vertices, faces)  # [..., F, 3]
    norm = torch.sqrt(torch.sum(cross * cross, dim=-1, keepdim=True)
                      + epsilon)
    per_vertex = torch.repeat_interleave(cross / norm, 3, dim=-2)
    # For a pre-split mesh faces == arange, so per_vertex rows already align
    # with vertex rows; place them through the face indices anyway.
    return torch.zeros_like(vertices).index_copy(
        -2, faces.reshape(-1), per_vertex
    )


def relu_split(x):
    """max(x, 0) whose gradient at x == 0 is one half, as ``jnp.maximum``'s
    (``torch.clamp`` would pass the whole gradient there)."""
    return torch.maximum(x, x.new_zeros(()))


def _clamped_cosine(normals, direction, double_sided):
    cos = torch.sum(normals * direction, dim=-1, keepdim=True)
    if double_sided:
        return torch.abs(cos)
    return relu_split(cos)


def diffuse_directional(
    vertex_normals, vertex_colors, light_direction, light_color,
    double_sided: bool = False,
):
    """Lambertian shading from a directional light.

    Args:
        vertex_normals: [..., V, 3] unit normals.
        vertex_colors: [..., V, C] albedo.
        light_direction: [..., 3] unit vector toward the light.
        light_color: [..., C].
        double_sided: light both faces (|N.L| instead of max(N.L, 0)).
    Returns:
        [..., V, C] reflected color.
    """
    normals = _f32(vertex_normals)
    colors = _f32(vertex_colors, normals)
    direction = _f32(light_direction, normals)[..., None, :]
    lcolor = _f32(light_color, normals)[..., None, :]
    with trace.outer_span("shade", normals):
        cos = _clamped_cosine(normals, direction, double_sided)
        return colors * lcolor * cos


def specular_directional(
    vertex_positions, vertex_normals, vertex_colors, camera_position,
    light_direction, light_color, shininess, double_sided: bool = False,
):
    """Phong specular highlight from a directional light.

    The light direction is reflected about the vertex normal and dotted with
    the view direction, raised to ``shininess``.

    Args:
        vertex_positions: [..., V, 3] world/eye-space positions.
        vertex_normals: [..., V, 3] unit normals.
        vertex_colors: [..., V, C] specular albedo.
        camera_position: [..., 3] position the scene is viewed from.
        light_direction: [..., 3] unit vector toward the light.
        light_color: [..., C].
        shininess: scalar Phong exponent.
    Returns:
        [..., V, C] specular contribution.
    """
    positions = _f32(vertex_positions)
    normals = _f32(vertex_normals, positions)
    colors = _f32(vertex_colors, positions)
    cam = _f32(camera_position, positions)[..., None, :]
    ldir = _f32(light_direction, positions)[..., None, :]
    lcolor = _f32(light_color, positions)[..., None, :]
    with trace.outer_span("shade", positions):
        view = cam - positions
        view = view / torch.sqrt(
            torch.sum(view * view, dim=-1, keepdim=True) + 1e-12
        )
        cos_nl = torch.sum(normals * ldir, dim=-1, keepdim=True)
        if double_sided:
            sign = torch.sign(torch.where(cos_nl == 0.0, 1.0, cos_nl))
            normals = normals * sign
            cos_nl = torch.abs(cos_nl)
        # Reflection of the (toward-light) direction about the normal.
        reflected = 2.0 * cos_nl * normals - ldir
        cos_rv = relu_split(torch.sum(reflected * view, dim=-1,
                                      keepdim=True))
        # No highlight on faces turned away from the light.
        lit = (cos_nl > 0.0).to(positions.dtype)
        return colors * lcolor * lit * torch.pow(cos_rv, shininess)
