"""Per-vertex colours through ``dirt_tpu_torch.rasterise_with_aux``, under
``bench.py``'s camera computed here (``[v, 1] @ (model @ projection)``),
with the configuration's ``clip`` flag."""

from __future__ import annotations

import torch

from benchmark.reference import camera as cam
from benchmark.scenes import to_device

# The scene arrays the pipeline reads.
INPUTS = ("verts", "faces")


def shape(name, scene):
    return (3,) if name == "pose" else (scene["verts"].shape[0],
                                        scene["channels"])


def true_value(name, config, scene):
    if name != "pose":
        raise ValueError(f"the vertex_color pipeline has no true {name}: "
                         f"the mix draws it")
    return torch.tensor(config["pose"], dtype=torch.float32,
                        device=scene["verts"].device)


def scene(config, arrays, device):
    out = to_device({k: v for k, v in arrays.items() if k != "uvs"}, device)
    size = config["size"]
    out["channels"] = config["channels"]
    out["background"] = torch.zeros((size, size, config["channels"]),
                                    device=device)
    out["projection"] = cam.perspective(config["camera"], torch.float32, device)
    out["offset"] = cam.translation(config["camera"]["offset"],
                                    torch.float32, device)
    return out


def clip_vertices(config, scene, params):
    # The offset is made once per scene: a tensor made from host data is
    # a copy that a CUDA-graph capture refuses.
    model = cam.rodrigues(params["pose"]) @ scene["offset"]
    return cam.homogeneous(scene["verts"]) @ (model @ scene["projection"])


def render(config, scene, raster, params):
    import dirt_tpu_torch

    pixels, fid, _, overflow = dirt_tpu_torch.rasterise_with_aux(
        scene["background"], clip_vertices(config, scene, params),
        params["colors"], scene["faces"], config=raster, clip=config["clip"])
    return {"image": pixels, "fid": fid, "overflow": overflow,
            "gbuffer": None}
