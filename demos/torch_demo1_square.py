"""Demo 1 on dirt_tpu_torch: a flat white square, 64x64, orthographic.

    python3 demos/torch_demo1_square.py

Port of ``demos/demo1_square.py``: two triangles in clip space (w = 1),
rendered with one channel over a zero background, 1,024 pixels covered
(32 x 32). Writes ``demos/out_torch/demo1_square.ppm``. Runs on the card
(``device="cuda"``) and raises without one.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import dirt_tpu_torch  # noqa: E402
from dirt_tpu_torch.utils.image import save_ppm  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out_torch")
SIZE = 64


def scene(device="cuda"):
    """(background [64, 64, 1], vertices [4, 4], colors [4, 1], faces)."""
    vertices = torch.tensor(
        [[-0.5, -0.5, 0.0, 1.0], [0.5, -0.5, 0.0, 1.0],
         [0.5, 0.5, 0.0, 1.0], [-0.5, 0.5, 0.0, 1.0]], device=device)
    faces = torch.tensor([[0, 1, 2], [0, 2, 3]], device=device)
    colors = torch.ones((4, 1), device=device)
    return torch.zeros((SIZE, SIZE, 1), device=device), vertices, colors, faces


def render(device="cuda"):
    """(image [64, 64, 1], fid [64, 64]) of the square."""
    pixels, fid, _, _ = dirt_tpu_torch.rasterise_with_aux(*scene(device))
    return pixels, fid


def main(device="cuda", out=OUT):
    """Render and save the square; returns (image, fid)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("demo 1 runs on a CUDA card, and none is "
                           "available (torch.cuda.is_available() is False)")
    os.makedirs(out, exist_ok=True)
    image, fid = render(device)
    coverage = int((image[..., 0] > 0.5).sum())
    print(f"square: {coverage} covered pixels (expect 1024 = 32x32)")
    save_ppm(os.path.join(out, "demo1_square.ppm"), image)
    if abs(coverage - 1024) > 64:
        raise RuntimeError(f"demo 1: {coverage} covered pixels, not ~1024")
    print("saved", os.path.join(out, "demo1_square.ppm"))
    return image, fid


if __name__ == "__main__":
    main()
