"""The deferred pipeline through ``dirt_tpu_torch.entry.deferred_render``:
a 9-channel G-buffer (position, normal, uv, mask) of the posed mesh, scaled
by ``1 + bump`` per vertex, textured and Phong-lit (light, ambient and
shininess are the entry's own; the configuration states them for the
reference)."""

from __future__ import annotations

import torch

from benchmark.reference import camera as cam
from benchmark.scenes import to_device

# The scene arrays the pipeline reads.
INPUTS = ("verts", "faces", "uvs", "texture")


def shape(name, scene):
    return (3,) if name == "pose" else (scene["verts"].shape[0],)


def true_value(name, config, scene):
    device = scene["verts"].device
    if name == "pose":
        return torch.tensor(config["pose"], dtype=torch.float32,
                            device=device)
    return torch.zeros(shape(name, scene), device=device)


def scene(config, arrays, device):
    out = to_device(arrays, device)
    out["projection"] = cam.perspective(config["camera"], torch.float32,
                                        device)
    out["offset"] = cam.translation(config["camera"]["offset"],
                                    torch.float32, device)
    return out


def _verts(scene, params):
    if "bump" not in params:
        return scene["verts"]
    return scene["verts"] * (1.0 + params["bump"][:, None])


def clip_vertices(config, scene, params):
    # The offset is made once per scene: a tensor made from host data is
    # a copy that a CUDA-graph capture refuses.
    model = cam.rodrigues(params["pose"]) @ scene["offset"]
    world = (cam.homogeneous(_verts(scene, params)) @ model)[:, :3]
    return cam.homogeneous(world) @ scene["projection"]


def render(config, scene, raster, params):
    from dirt_tpu_torch import entry

    image, gb = entry.deferred_render(
        _verts(scene, params), params["pose"], scene["faces"], scene["uvs"],
        scene["texture"], scene["projection"], config["size"], raster,
        with_gbuffer=True)
    return {"image": image, "fid": gb["fid"], "overflow": gb["overflow"],
            "gbuffer": tuple(gb[name] for name in
                             ("position", "normal", "uv", "mask"))}
