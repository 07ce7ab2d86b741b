"""Mesh construction utilities for demos, tests and benchmarks.

A verbatim copy of ``dirt_tpu/core/mesh.py`` (numpy only): importing it
from ``dirt_tpu`` would load jax through ``dirt_tpu/__init__.py``.

The reference builds its sample meshes inline in ``samples/*.py``
(reconstructed — SURVEY.md section 2.2); these helpers centralise the same
shapes plus a UV-sphere generator for the large benchmark meshes.
All meshes are counter-clockwise wound viewed from outside.
"""

from __future__ import annotations

import numpy as np


def unit_quad():
    """Two-triangle unit quad in the z=0 plane, spanning [-1, 1]^2."""
    vertices = np.array(
        [[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [1.0, 1.0, 0.0], [-1.0, 1.0, 0.0]],
        np.float32,
    )
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return vertices, faces


def cube(size: float = 1.0):
    """Axis-aligned cube centred at the origin; 8 vertices, 12 triangles."""
    s = size / 2.0
    vertices = np.array(
        [
            [-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s],  # z = -s
            [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s],      # z = +s
        ],
        np.float32,
    )
    faces = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # back  (-z), outward = -z
            [4, 5, 6], [4, 6, 7],  # front (+z)
            [0, 1, 5], [0, 5, 4],  # bottom (-y)
            [3, 6, 2], [3, 7, 6],  # top (+y)
            [0, 4, 7], [0, 7, 3],  # left (-x)
            [1, 2, 6], [1, 6, 5],  # right (+x)
        ],
        np.int32,
    )
    return vertices, faces


def uv_sphere(n_lat: int = 32, n_lon: int = 64, radius: float = 1.0):
    """UV sphere with ~2 * n_lat * n_lon triangles (used for 10k-tri benches).

    Returns (vertices [V, 3] f32, faces [F, 3] i32, uvs [V, 2] f32).
    """
    lats = np.linspace(0.0, np.pi, n_lat + 1)
    lons = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)
    lat_grid, lon_grid = np.meshgrid(lats, lons, indexing="ij")
    x = radius * np.sin(lat_grid) * np.cos(lon_grid)
    y = radius * np.cos(lat_grid)
    z = radius * np.sin(lat_grid) * np.sin(lon_grid)
    vertices = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    uvs = np.stack(
        [lon_grid / (2.0 * np.pi), 1.0 - lat_grid / np.pi], axis=-1
    ).reshape(-1, 2).astype(np.float32)

    faces = []
    stride = n_lon + 1
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * stride + j
            b = a + 1
            c = a + stride
            d = c + 1
            if i > 0:
                faces.append([a, b, c])
            if i < n_lat - 1:
                faces.append([b, d, c])
    faces = np.array(faces, np.int32)
    return vertices, faces, uvs


def checkerboard_texture(size: int = 64, squares: int = 8, channels: int = 3):
    """A checkerboard texture for the textured demos/tests."""
    idx = np.arange(size) * squares // size
    pattern = (idx[:, None] + idx[None, :]) % 2
    tex = np.where(pattern[..., None] > 0, 0.9, 0.2).astype(np.float32)
    return np.broadcast_to(tex, (size, size, channels)).copy()
