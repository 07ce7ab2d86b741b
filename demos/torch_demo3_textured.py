"""Demo 3 on dirt_tpu_torch: UV G-buffer + bilinear texture, 512x512.

    python3 demos/torch_demo3_textured.py

Port of ``demos/demo3_textured.py``: a checker-textured UV sphere
(``uv_sphere(24, 48)``: 2,208 faces, 64 x 64 texture of 8 squares), turned
by Rodrigues (0.3, 0.5, 0.1), 3 units down -z; its G-buffer of UVs and mask
(the dense engine at this face count) sampled bilinearly. Then the texture
is recovered from the rendered image by 60 steps of gradient descent (lr
300) on the mean squared error, the gradient flowing through
``core.texture.sample_texture`` into the texture. Writes
``demos/out_torch/demo3_textured.ppm`` and
``demo3_recovered_texture.ppm``. ``DIRT_DEMO_SIZE`` and
``DIRT_DEMO_STEPS`` set the defaults of :func:`main`'s arguments. Runs on
the card (``device="cuda"``) and raises without one.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from dirt_tpu_torch.core import matrices, mesh  # noqa: E402
from dirt_tpu_torch.core.texture import sample_texture  # noqa: E402
from dirt_tpu_torch.render.gbuffer import render_gbuffer  # noqa: E402
from dirt_tpu_torch.utils.benchtime import timed  # noqa: E402
from dirt_tpu_torch.utils.image import save_ppm  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out_torch")
SIZE = int(os.environ.get("DIRT_DEMO_SIZE", "512"))
STEPS = int(os.environ.get("DIRT_DEMO_STEPS", "60"))
LR = 300.0


def problem(size=SIZE, device="cuda"):
    """(loss_fn, params, render, texture): ``render(texture)`` the masked
    texture lookup through the G-buffer; ``loss_fn(texture)`` the mean
    squared error against the render of the checkerboard; ``params`` the
    initial ``{"texture"}``, gray 0.5."""
    verts_obj, faces, uvs = mesh.uv_sphere(n_lat=24, n_lon=48)
    texture = torch.as_tensor(mesh.checkerboard_texture(64, 8, 3),
                              device=device)
    model_view = matrices.compose(
        matrices.rodrigues(torch.tensor([0.3, 0.5, 0.1], device=device)),
        matrices.translation(torch.tensor([0.0, 0.0, -3.0], device=device)),
    )
    projection = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)
    clip = matrices.transform_homogeneous(
        torch.as_tensor(verts_obj, device=device),
        matrices.compose(model_view, projection.to(device)))
    faces = torch.as_tensor(faces, device=device)
    uvs = torch.as_tensor(uvs, device=device)

    def render(tex):
        gb = render_gbuffer(clip, faces, {"uv": uvs}, size, size)
        return sample_texture(tex, gb["uv"]) * gb["mask"]

    with torch.no_grad():
        target = render(texture)

    def loss_fn(texture):
        return torch.mean((render(texture) - target) ** 2)

    return loss_fn, {"texture": torch.full_like(texture, 0.5)}, render, \
        texture


def fit(loss_fn, params, steps):
    """``steps`` steps of gradient descent on the texture. Returns (params,
    the loss of every step before its update [steps])."""
    texture = params["texture"].detach().clone().requires_grad_()
    losses = []
    for _ in range(steps):
        loss = loss_fn(texture)
        (grad,) = torch.autograd.grad(loss, [texture])
        with torch.no_grad():
            texture -= LR * grad
        losses.append(loss.detach())
    return {"texture": texture.detach()}, torch.stack(losses)


def main(size=SIZE, steps=STEPS, device="cuda", out=OUT):
    """Run the demo; returns {"l0", "l1", "losses", "steps",
    "ms_per_step"}."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("demo 3 runs on a CUDA card, and none is "
                           "available (torch.cuda.is_available() is False)")
    os.makedirs(out, exist_ok=True)
    loss_fn, params, render, texture = problem(size, device)
    with torch.no_grad():
        save_ppm(os.path.join(out, "demo3_textured.ppm"), render(texture))
    l0 = float(loss_fn(**params))
    (params, losses), loop_s = timed(device, fit, loss_fn, params, steps)
    l1 = float(loss_fn(**params))
    ms_per_step = loop_s / steps * 1e3
    print(f"texture recovery: loss {l0:.5f} -> {l1:.5f} ({steps} steps, "
          f"{ms_per_step:.3f} ms/step on {device.type})")
    save_ppm(os.path.join(out, "demo3_recovered_texture.ppm"),
             params["texture"])
    if not l1 < 0.3 * l0:
        raise RuntimeError(f"demo 3: the loss fell only {l0} -> {l1}")
    print("saved", os.path.join(out, "demo3_textured.ppm"))
    return {"l0": l0, "l1": l1, "losses": losses, "steps": steps,
            "ms_per_step": ms_per_step}


if __name__ == "__main__":
    main()
