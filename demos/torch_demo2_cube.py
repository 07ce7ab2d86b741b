"""Demo 2 on dirt_tpu_torch: a 12-triangle cube, perspective, 256x256.

    python3 demos/torch_demo2_cube.py

Port of ``demos/demo2_cube.py``: ``mesh.cube()`` turned by Rodrigues
(0.5, 0.8, 0), 3 units down -z, perspective (near 0.1, far 20, right 0.05,
aspect 1), colored by position, z-buffered over a 0.1 gray background.
Writes ``demos/out_torch/demo2_cube.ppm``. Runs on the card
(``device="cuda"``) and raises without one.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import dirt_tpu_torch  # noqa: E402
from dirt_tpu_torch.core import matrices, mesh  # noqa: E402
from dirt_tpu_torch.utils.image import save_ppm  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out_torch")
SIZE = 256


def scene(device="cuda"):
    """(background [256, 256, 3], clip-space vertices [8, 4], colors [8, 3],
    faces [12, 3])."""
    verts_obj, faces = mesh.cube()
    verts_obj = torch.as_tensor(verts_obj, device=device)
    model_view = matrices.compose(
        matrices.rodrigues(torch.tensor([0.5, 0.8, 0.0], device=device)),
        matrices.translation(torch.tensor([0.0, 0.0, -3.0], device=device)),
    )
    projection = matrices.perspective_projection(0.1, 20.0, 0.05, 1.0)
    clip = matrices.transform_homogeneous(
        verts_obj, matrices.compose(model_view, projection.to(device)))
    background = torch.full((SIZE, SIZE, 3), 0.1, device=device)
    return (background, clip, verts_obj + 0.5,
            torch.as_tensor(faces, device=device))


def render(device="cuda"):
    """(image [256, 256, 3], fid [256, 256]) of the cube."""
    pixels, fid, _, _ = dirt_tpu_torch.rasterise_with_aux(*scene(device))
    return pixels, fid


def main(device="cuda", out=OUT):
    """Render and save the cube; returns (image, fid)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("demo 2 runs on a CUDA card, and none is "
                           "available (torch.cuda.is_available() is False)")
    os.makedirs(out, exist_ok=True)
    image, fid = render(device)
    cov = float((image.sum(-1) > 0.4).float().mean())
    print(f"cube: coverage fraction {cov:.3f}")
    save_ppm(os.path.join(out, "demo2_cube.ppm"), image)
    if not cov > 0.05:
        raise RuntimeError(f"demo 2: coverage fraction {cov}")
    print("saved", os.path.join(out, "demo2_cube.ppm"))
    return image, fid


if __name__ == "__main__":
    main()
