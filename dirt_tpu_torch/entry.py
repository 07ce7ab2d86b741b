"""The flagship step: deferred G-buffer render + shading + L2 loss.

Counterpart of ``__graft_entry__.entry()`` of the JAX package (its
single-device half): a textured, Phong-lit UV sphere rendered through
``render_gbuffer`` (9 channels: position, normal, uv, mask) and
``shade_deferred``, and the mean squared error against a black target.
The loss is differentiable w.r.t. the object-space vertices and the pose.
"""

from __future__ import annotations

import torch

from dirt_tpu_torch.core import lighting, matrices, mesh
from dirt_tpu_torch.ops.raster import RasterConfig
from dirt_tpu_torch.render.deferred import shade_deferred
from dirt_tpu_torch.render.gbuffer import render_gbuffer


def deferred_scene(n_lat: int = 24, n_lon: int = 48, device="cuda"):
    """(verts_obj [V, 3], faces [F, 3], uvs [V, 2], texture, projection)
    of the flagship scene, as tensors on ``device``."""
    from dirt_tpu_torch.convert import deferred_scene_from_numpy

    verts_obj, faces, uvs = mesh.uv_sphere(n_lat=n_lat, n_lon=n_lon)
    texture = mesh.checkerboard_texture(64, 8, 3)
    projection = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)
    return deferred_scene_from_numpy(verts_obj, faces, uvs, texture,
                                     projection.numpy(), device)


def deferred_render(verts_obj, pose, faces, uvs, texture, projection,
                    size: int, config: RasterConfig | None = None,
                    with_gbuffer: bool = False):
    """[size, size, 3] image of the posed, textured, lit mesh.

    World transform (Rodrigues ``pose``, 3 units down -z), smooth normals,
    projection, G-buffer (position | normal | uv | mask), deferred shading
    with ambient 0.12 and a Phong highlight (shininess 24) seen from the
    origin. Runs on the device of ``verts_obj``. ``with_gbuffer`` also
    returns the G-buffer dict (whose "overflow" flag says whether a raster
    cap truncated the render).
    """
    device = verts_obj.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    light_dir = f32([0.35, 0.75, 0.56])
    light_dir = light_dir / torch.linalg.norm(light_dir)
    model = matrices.compose(
        matrices.rodrigues(f32(pose)),
        matrices.translation(f32([0.0, 0.0, -3.0])),
    )
    world = matrices.transform_homogeneous(verts_obj, model)[..., :3]
    normals = lighting.vertex_normals(world, faces)
    ones = torch.ones(world.shape[:-1] + (1,), dtype=world.dtype,
                      device=device)
    clip = torch.cat([world, ones], dim=-1) @ projection
    gb = render_gbuffer(
        clip, faces, {"position": world, "normal": normals, "uv": uvs},
        size, size, config=config,
    )
    image = shade_deferred(
        gb, light_dir, torch.ones(3, device=device), ambient=0.12,
        texture=texture, camera_position=torch.zeros(3, device=device),
        shininess=24.0,
    )
    return (image, gb) if with_gbuffer else image


def entry(device="cuda", size: int = 256, n_lat: int = 24, n_lon: int = 48):
    """(forward_step, example_args): the flagship loss on one device.

    ``forward_step(verts, pose)`` renders the default scene (a 2,208-face
    sphere at 256 x 256, auto config: the dense engine) and returns the mean
    squared error against a black target. Runs on the card unless
    ``device`` says otherwise.
    """
    verts_obj, faces, uvs, texture, projection = deferred_scene(
        n_lat, n_lon, device=device)
    config = RasterConfig()

    def forward_step(verts, pose):
        img = deferred_render(verts, pose, faces, uvs, texture, projection,
                              size, config)
        return torch.mean(img ** 2)

    pose = torch.tensor([0.4, 0.3, 0.0], device=verts_obj.device)
    return forward_step, (verts_obj, pose)
