"""Per-vertex lighting through the port's public API, as demo 4 renders:
the posed mesh's smooth normals (``core.lighting.vertex_normals``), a
Lambert term (``diffuse_directional``) plus a Phong highlight
(``specular_directional``) from a directional light, rasterised by
``dirt_tpu_torch.rasterise_with_aux`` with the configuration's ``clip``
flag, under ``bench.py``'s camera (world ``[v, 1] @ model``, clip ``[world,
1] @ projection``). ``light`` is the direction towards the light, not of
unit length: the render normalises it, so that a fit moves it freely.
``suggest_raster_config`` picks the engine."""

from __future__ import annotations

import torch

from benchmark.reference import camera as cam
from benchmark.scenes import to_device

# The scene arrays the pipeline reads.
INPUTS = ("verts", "faces")


def shape(name, scene):
    if name not in ("light", "pose"):
        raise ValueError(f"the lit pipeline has no parameter {name}")
    return (3,)


def true_value(name, config, scene):
    value = config["shading"]["light"] if name == "light" else config["pose"]
    return torch.tensor(value, dtype=torch.float32,
                        device=scene["verts"].device)


def scene(config, arrays, device):
    out = to_device({k: v for k, v in arrays.items() if k != "uvs"}, device)
    shading, size = config["shading"], config["size"]
    verts = out["verts"].shape[0]

    def const(value):
        return torch.as_tensor(value, dtype=torch.float32, device=device)

    out["albedo"] = const(shading["albedo"]).expand(verts, 3).contiguous()
    out["specular_albedo"] = torch.full((verts, 3),
                                        shading["specular_albedo"],
                                        device=device)
    out["light_color"] = const(shading["light_color"])
    out["camera_position"] = const(shading["camera_position"])
    out["background"] = torch.zeros((size, size, config["channels"]),
                                    device=device)
    out["projection"] = cam.perspective(config["camera"], torch.float32, device)
    out["offset"] = cam.translation(config["camera"]["offset"],
                                    torch.float32, device)
    return out


def _world(scene, params):
    # The offset is made once per scene: a tensor made from host data is
    # a copy that a CUDA-graph capture refuses.
    model = cam.rodrigues(params["pose"]) @ scene["offset"]
    return (cam.homogeneous(scene["verts"]) @ model)[:, :3]


def clip_vertices(config, scene, params):
    return cam.homogeneous(_world(scene, params)) @ scene["projection"]


def render(config, scene, raster, params):
    import dirt_tpu_torch
    from dirt_tpu_torch.core import lighting

    world = _world(scene, params)
    light = params["light"] / torch.linalg.norm(params["light"])
    normals = lighting.vertex_normals(world, scene["faces"])
    shaded = lighting.diffuse_directional(
        normals, scene["albedo"], light, scene["light_color"],
    ) + lighting.specular_directional(
        world, normals, scene["specular_albedo"], scene["camera_position"],
        light, scene["light_color"], config["shading"]["shininess"],
    )
    clip = cam.homogeneous(world) @ scene["projection"]
    pixels, fid, _, overflow = dirt_tpu_torch.rasterise_with_aux(
        scene["background"], clip, shaded, scene["faces"], config=raster,
        clip=config["clip"])
    return {"image": pixels, "fid": fid, "overflow": overflow,
            "gbuffer": None}
