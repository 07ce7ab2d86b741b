"""Demo 4 on dirt_tpu_torch: Lambert + specular vertex shading, 512x512.

    python3 demos/torch_demo4_lit.py

Port of ``demos/demo4_lit.py``: a UV sphere (``uv_sphere(24, 48)``: 2,208
faces, albedo (0.9, 0.6, 0.3)) shaded per vertex (diffuse + specular,
shininess 20, specular albedo 0.4, camera at the origin) and rasterised
over black (the dense engine at this face count). Then the light direction
and a pose offset are recovered from the rendered image by 80 steps of
gradient descent on the mean squared error (lr 3 for the light, 0.5 for the
pose). Writes ``demos/out_torch/demo4_lit.ppm``. ``DIRT_DEMO_SIZE`` and
``DIRT_DEMO_STEPS`` set the defaults of :func:`main`'s arguments. Runs on
the card (``device="cuda"``) and raises without one.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import dirt_tpu_torch  # noqa: E402
from dirt_tpu_torch.core import lighting, matrices, mesh  # noqa: E402
from dirt_tpu_torch.utils.benchtime import timed  # noqa: E402
from dirt_tpu_torch.utils.image import save_ppm  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out_torch")
SIZE = int(os.environ.get("DIRT_DEMO_SIZE", "512"))
STEPS = int(os.environ.get("DIRT_DEMO_STEPS", "80"))
TRUE_LIGHT = (0.3, 0.8, 0.52)
TRUE_POSE = (0.4, 0.3, 0.0)
INIT = {"light": (0.0, 1.0, 0.3), "pose": (0.55, 0.2, 0.05)}
LR = {"light": 3.0, "pose": 0.5}


def problem(size=SIZE, device="cuda"):
    """(loss_fn, params, render, truth): ``render(light, pose)`` the shaded
    image for an unnormalised light direction and a Rodrigues pose;
    ``loss_fn(light, pose)`` the mean squared error against the render at
    the true light and pose (``truth``); ``params`` the initial
    ``{"light", "pose"}``."""
    verts_obj, faces, _ = mesh.uv_sphere(n_lat=24, n_lon=48)
    verts_obj = torch.as_tensor(verts_obj, device=device)
    faces = torch.as_tensor(faces, device=device)
    albedo = torch.tensor([0.9, 0.6, 0.3], device=device).expand(
        verts_obj.shape[0], 3)
    projection = matrices.perspective_projection(
        0.1, 20.0, 0.045, 1.0).to(device)
    background = torch.zeros((size, size, 3), device=device)
    ones3 = torch.ones(3, device=device)

    def render(light_dir_raw, pose):
        light_dir = light_dir_raw / torch.linalg.norm(light_dir_raw)
        model = matrices.compose(
            matrices.rodrigues(pose),
            matrices.translation(torch.tensor([0.0, 0.0, -3.0],
                                              device=device)),
        )
        world = matrices.transform_homogeneous(verts_obj, model)[..., :3]
        normals = lighting.vertex_normals(world, faces)
        shaded = lighting.diffuse_directional(
            normals, albedo, light_dir, ones3
        ) + lighting.specular_directional(
            world, normals, torch.full_like(albedo, 0.4),
            camera_position=torch.zeros(3, device=device),
            light_direction=light_dir, light_color=ones3, shininess=20.0,
        )
        ones = torch.ones(world.shape[:-1] + (1,), device=device)
        clip = torch.cat([world, ones], -1) @ projection
        return dirt_tpu_torch.rasterise(background, clip, shaded, faces)

    truth = {k: torch.tensor(v, device=device)
             for k, v in (("light", TRUE_LIGHT), ("pose", TRUE_POSE))}
    with torch.no_grad():
        target = render(truth["light"], truth["pose"])

    def loss_fn(light, pose):
        return torch.mean((render(light, pose) - target) ** 2)

    params = {k: torch.tensor(v, device=device) for k, v in INIT.items()}
    return loss_fn, params, render, truth


def fit(loss_fn, params, steps):
    """``steps`` steps of gradient descent on light and pose, each with its
    own rate. Returns (params, the loss of every step before its update
    [steps])."""
    params = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    losses = []
    for _ in range(steps):
        loss = loss_fn(**params)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for (key, value), grad in zip(params.items(), grads):
                value -= LR[key] * grad
        losses.append(loss.detach())
    return {k: v.detach() for k, v in params.items()}, torch.stack(losses)


def main(size=SIZE, steps=STEPS, device="cuda", out=OUT):
    """Run the demo; returns {"l0", "l1", "losses", "steps",
    "ms_per_step", "light", "pose"}."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("demo 4 runs on a CUDA card, and none is "
                           "available (torch.cuda.is_available() is False)")
    os.makedirs(out, exist_ok=True)
    loss_fn, params, render, truth = problem(size, device)
    with torch.no_grad():
        save_ppm(os.path.join(out, "demo4_lit.ppm"),
                 render(truth["light"], truth["pose"]))
    l0 = float(loss_fn(**params))
    (params, losses), loop_s = timed(device, fit, loss_fn, params, steps)
    l1 = float(loss_fn(**params))
    ms_per_step = loop_s / steps * 1e3
    light = params["light"] / torch.linalg.norm(params["light"])
    print(f"light/pose recovery: loss {l0:.6f} -> {l1:.6f} ({steps} steps, "
          f"{ms_per_step:.3f} ms/step on {device.type})")
    print("  light", [round(x, 3) for x in light.tolist()],
          "(true", list(TRUE_LIGHT), ")")
    print("  pose ", [round(x, 3) for x in params["pose"].tolist()],
          "(true", list(TRUE_POSE), ")")
    if not l1 < 0.25 * l0:
        raise RuntimeError(f"demo 4: the loss fell only {l0} -> {l1}")
    print("saved", os.path.join(out, "demo4_lit.ppm"))
    return {"l0": l0, "l1": l1, "losses": losses, "steps": steps,
            "ms_per_step": ms_per_step, "light": light,
            "pose": params["pose"]}


if __name__ == "__main__":
    main()
