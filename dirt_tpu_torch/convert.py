"""Carry state across from ``dirt_tpu`` without importing jax.

* :func:`config_from_jax` turns a ``dirt_tpu.ops.raster.RasterConfig``, or
  its ``_asdict()`` (such as the entries of ``bench_cache/configs.json``),
  into the port's :class:`~dirt_tpu_torch.ops.raster.RasterConfig`.
* :func:`scene_from_numpy` builds the port's input tensors from the numpy
  arrays a ``dirt_tpu`` caller feeds it.
* :func:`deferred_scene_from_numpy` does the same for the scene of the
  deferred pipeline (``__graft_entry__.entry()``, config 5 of
  ``bench_configs.py``): mesh, UVs, texture and projection.
"""

from __future__ import annotations

import numpy as np
import torch

from dirt_tpu_torch.ops.raster import RasterConfig


def config_from_jax(cfg_or_dict) -> RasterConfig:
    """The port's RasterConfig with the same field values.

    Accepts anything with ``_asdict()`` (a NamedTuple) or a mapping. An
    unknown field raises: the two configs have the same fields.
    """
    fields = (cfg_or_dict._asdict() if hasattr(cfg_or_dict, "_asdict")
              else dict(cfg_or_dict))
    unknown = set(fields) - set(RasterConfig._fields)
    if unknown:
        raise ValueError(f"unknown RasterConfig fields: {sorted(unknown)}")
    return RasterConfig(**fields)


def scene_from_numpy(background, vertices, vertex_colors, faces, device):
    """(background, vertices, vertex_colors, faces) as tensors on ``device``.

    Floats become float32 and faces int64; ``background`` may be None.
    """
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    bg = None if background is None else f32(background)
    faces_t = torch.as_tensor(np.asarray(faces, np.int64), device=device)
    return bg, f32(vertices), f32(vertex_colors), faces_t


def deferred_scene_from_numpy(verts_obj, faces, uvs, texture, projection,
                              device):
    """(verts_obj, faces, uvs, texture, projection) as tensors on ``device``.

    Floats become float32 (object-space vertices [V, 3], UVs [V, 2], texture
    [Ht, Wt, C], projection [4, 4]) and faces int64.
    """
    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    faces_t = torch.as_tensor(np.array(faces, np.int64), device=device)
    return f32(verts_obj), faces_t, f32(uvs), f32(texture), f32(projection)
