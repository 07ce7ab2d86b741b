"""The inputs of a cell, made from its configuration file and its seed.

Meshes and textures are the benchmark's own copies (numpy), so that a change
to the port cannot change what is measured: ``uv_sphere`` makes the faces of
``dirt_tpu_torch/core/mesh.py``'s generator in the same order, without its
Python loop; ``checkerboard_texture`` is that module's. The same arrays go
to the program (float32 tensors on the card) and to the reference (float64).
"""

from __future__ import annotations

import numpy as np
import torch


def uv_sphere(n_lat: int, n_lon: int, radius: float = 1.0):
    """UV sphere: (vertices [V, 3] f32, faces [F, 3] i64, uvs [V, 2] f32),
    counter-clockwise seen from outside, F = 2 * n_lat * n_lon - 2 * n_lon.

    For each band i and segment j in row-major order: the triangle (a, b,
    c) unless i is the top band, then (b, d, c) unless i is the bottom
    band, with a = i * (n_lon + 1) + j, b = a + 1, c = a + n_lon + 1, d = c
    + 1."""
    lats = np.linspace(0.0, np.pi, n_lat + 1)
    lons = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)
    lat_grid, lon_grid = np.meshgrid(lats, lons, indexing="ij")
    x = radius * np.sin(lat_grid) * np.cos(lon_grid)
    y = radius * np.cos(lat_grid)
    z = radius * np.sin(lat_grid) * np.sin(lon_grid)
    vertices = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    uvs = np.stack([lon_grid / (2.0 * np.pi), 1.0 - lat_grid / np.pi],
                   axis=-1).reshape(-1, 2).astype(np.float32)

    i, j = np.meshgrid(np.arange(n_lat), np.arange(n_lon), indexing="ij")
    a = i * (n_lon + 1) + j
    b, c = a + 1, a + n_lon + 1
    d = c + 1
    tris = np.stack([np.stack([a, b, c], -1), np.stack([b, d, c], -1)], 2)
    keep = np.stack([i > 0, i < n_lat - 1], 2)
    faces = tris[keep].astype(np.int64)
    return vertices, faces, uvs


def checkerboard_texture(size: int, squares: int, channels: int = 3):
    """[size, size, channels] f32 checkerboard of 0.9 and 0.2."""
    idx = np.arange(size) * squares // size
    pattern = (idx[:, None] + idx[None, :]) % 2
    tex = np.where(pattern[..., None] > 0, 0.9, 0.2).astype(np.float32)
    return np.broadcast_to(tex, (size, size, channels)).copy()


MESHES = {"uv_sphere": lambda spec: uv_sphere(spec["n_lat"], spec["n_lon"])}


def scene_arrays(config: dict) -> dict:
    """The numpy arrays of a configuration: ``verts`` [V, 3], ``faces``
    [F, 3] int64, ``uvs`` [V, 2] and, where the configuration has one,
    ``texture``. Raises if the mesh does not have the face count the
    configuration states."""
    spec = config["mesh"]
    verts, faces, uvs = MESHES[spec["kind"]](spec)
    if faces.shape[0] != config["faces"]:
        raise ValueError(f"{config['name']}: the mesh has {faces.shape[0]} "
                         f"faces, the configuration states {config['faces']}")
    arrays = {"verts": verts, "faces": faces, "uvs": uvs}
    if "texture" in config:
        tex = config["texture"]
        arrays["texture"] = checkerboard_texture(tex["size"], tex["squares"])
    return arrays


def to_device(arrays: dict, device, dtype=torch.float32) -> dict:
    """Float arrays as ``dtype`` tensors on ``device``; faces stay int64."""
    return {name: torch.as_tensor(
        value, dtype=torch.int64 if value.dtype.kind == "i" else dtype,
        device=device) for name, value in arrays.items()}


def seed_sequence(seed: int, stream: str) -> np.random.Generator:
    """numpy generator of one named stream of a run's seed (any whole
    number, larger than 32 bits too)."""
    key = [int(b) for b in stream.encode()]
    return np.random.default_rng(np.random.SeedSequence([seed, *key]))


def device_generator(seed: int, stream: str, device) -> torch.Generator:
    """torch generator on ``device`` seeded from one stream of the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed_sequence(seed, stream).integers(0, 2 ** 62)))
    return gen


def poses_near(seed: int, stream: str, centre, spread: float, count: int):
    """[count, 3] float32 axis-angle poses, each axis drawn uniformly
    within ``spread`` radians of ``centre``."""
    rng = seed_sequence(seed, stream)
    offsets = rng.uniform(-spread, spread, size=(count, 3))
    return (np.asarray(centre, np.float64)[None] + offsets).astype(np.float32)
