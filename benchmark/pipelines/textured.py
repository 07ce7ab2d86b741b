"""A texture sampled at the rasterised UVs, as upstream DIRT's
``samples/textured.py`` renders: ``render_gbuffer`` rasterises the mesh's
UVs and a coverage mask with the configuration's ``clip`` flag, and
``core.texture.sample_texture`` looks the texture up bilinearly at each
pixel's UV, masked to the covered pixels. The camera is ``bench.py``'s
(``[v, 1] @ (model @ projection)``). ``texture`` is a parameter (a fit
trains it); the configuration's checkerboard is its true value.
``suggest_raster_config`` picks the engine."""

from __future__ import annotations

import torch

from benchmark.reference import camera as cam
from benchmark.scenes import to_device

# The scene arrays the pipeline reads.
INPUTS = ("verts", "faces", "uvs")


def shape(name, scene):
    if name not in ("texture", "pose"):
        raise ValueError(f"the textured pipeline has no parameter {name}")
    return (3,) if name == "pose" else tuple(scene["true_texture"].shape)


def true_value(name, config, scene):
    if name == "texture":
        return scene["true_texture"].clone()
    if name != "pose":
        raise ValueError(f"the textured pipeline has no parameter {name}")
    return torch.tensor(config["pose"], dtype=torch.float32,
                        device=scene["verts"].device)


def scene(config, arrays, device):
    out = to_device({k: v for k, v in arrays.items() if k != "texture"},
                    device)
    out["true_texture"] = torch.as_tensor(arrays["texture"],
                                          dtype=torch.float32, device=device)
    if list(out["true_texture"].shape) != config["texture_shape"]:
        raise ValueError(f"{config['name']}: the texture has the shape "
                         f"{list(out['true_texture'].shape)}, the "
                         f"configuration states {config['texture_shape']}")
    out["projection"] = cam.perspective(config["camera"], torch.float32,
                                        device)
    out["offset"] = cam.translation(config["camera"]["offset"],
                                    torch.float32, device)
    return out


def clip_vertices(config, scene, params):
    # The offset is made once per scene: a tensor made from host data is
    # a copy that a CUDA-graph capture refuses.
    model = cam.rodrigues(params["pose"]) @ scene["offset"]
    return cam.homogeneous(scene["verts"]) @ (model @ scene["projection"])


def render(config, scene, raster, params):
    from dirt_tpu_torch.core.texture import sample_texture
    from dirt_tpu_torch.render.gbuffer import render_gbuffer

    size = config["size"]
    gb = render_gbuffer(clip_vertices(config, scene, params), scene["faces"],
                        {"uv": scene["uvs"]}, size, size, config=raster,
                        clip=config["clip"])
    image = sample_texture(params["texture"], gb["uv"]) * gb["mask"]
    return {"image": image, "fid": gb["fid"], "overflow": gb["overflow"],
            "gbuffer": None}
