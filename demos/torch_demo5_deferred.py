"""Demo 5 on dirt_tpu_torch: deferred inverse rendering at 1024^2.

    python3 demos/torch_demo5_deferred.py

Port of ``demos/demo5_deferred.py``, the flagship pipeline as a trainer: a
G-buffer (position | normal | uv | mask, 9 channels) of a ~10k-triangle UV
sphere (``uv_sphere(72, 72)``: 10,224 faces), textured and Phong-lit by
``shade_deferred``, under ``suggest_raster_config``'s caps on the true pose
(the packed engine at this size): the scene and caps of config 5 of
``bench_configs_torch.py`` (``deferred_scene``). From a perturbed pose, 80
Adam steps fit the pose alone for the first half and pose plus a per-vertex
bump field after (``torch.optim.Adam``, two parameter groups: pose lr 5e-3,
bump lr 0 then 2e-4; both groups' moments update from the first step, as
in the JAX loop). On the card each Adam step is one CUDA-graph replay
(``trainer``), as the JAX loop runs its steps in one jitted ``lax.scan``;
the capture is timed apart from the loop, as the JAX demo compiles ahead of
its. Writes the target and recovered renders, the loss curve
(``demo5_metrics.csv``: ``step,wall_s,loss``) and a resumable checkpoint
(``demo5_ckpt.npz``: ``{"params": {"pose", "bump"}, "m", "v", "step"}`` in
``dirt_tpu``'s file layout, m and v the optimiser's ``exp_avg`` /
``exp_avg_sq``) to ``demos/out_torch/``.

``DIRT_DEMO_SIZE``, ``DIRT_DEMO_STEPS``, ``DIRT_DEMO_LAT`` and
``DIRT_DEMO_LON`` set the defaults of :func:`main`'s arguments, as they set
the JAX demo's. It runs on the card (``device="cuda"``) and raises without
one; on a card it prints the first render's time, the steady forward, the
set-up and capture of the training step and ms/step of the loop from CUDA
events, with the card's name and power limit.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import bench_configs_torch  # noqa: E402
from dirt_tpu_torch import entry  # noqa: E402
from dirt_tpu_torch.utils.benchtime import card_line, timed  # noqa: E402
from dirt_tpu_torch.utils.checkpoint import load_pytree, save_pytree  # noqa: E402
from dirt_tpu_torch.utils.graphstep import GraphedStep  # noqa: E402
from dirt_tpu_torch.utils.image import save_ppm  # noqa: E402
from dirt_tpu_torch.utils.metrics import MetricsLogger  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out_torch")
SIZE = int(os.environ.get("DIRT_DEMO_SIZE", "1024"))
STEPS = int(os.environ.get("DIRT_DEMO_STEPS", "80"))
# ~10k triangles: 2 * 72 * 71 = 10,224
N_LAT = int(os.environ.get("DIRT_DEMO_LAT", "72"))
N_LON = int(os.environ.get("DIRT_DEMO_LON", "72"))

# The pose of the target, on which config 5's caps are measured.
TRUE_POSE = bench_configs_torch.POSE
INIT_POSE = (0.52, 0.22, 0.05)
LR_POSE = 5e-3
LR_BUMP = 2e-4
BETAS = (0.9, 0.999)
EPS = 1e-8


def make_render(faces, uvs, texture, projection, config, size):
    """``render(verts_obj, pose)``: the [size, size, 3] deferred image
    (``entry.deferred_render``: light (0.35, 0.75, 0.56), ambient 0.12,
    shininess 24, camera at the origin)."""
    def render(verts_obj, pose):
        return entry.deferred_render(verts_obj, pose, faces, uvs, texture,
                                     projection, size, config)

    return render


def problem(size=SIZE, n_lat=N_LAT, n_lon=N_LON, device="cuda"):
    """(loss_fn, params, render, target, verts_obj): ``loss_fn(pose, bump)``
    is the mean squared error of the render of ``verts_obj * (1 + bump)`` at
    ``pose`` against the target (the render at the true pose); ``params``
    the initial ``{"pose", "bump"}``."""
    verts_obj, faces, uvs, texture, projection, config = \
        bench_configs_torch.deferred_scene(n_lat, n_lon, size, device)
    render = make_render(faces, uvs, texture, projection, config, size)
    with torch.no_grad():
        target = render(verts_obj, torch.tensor(TRUE_POSE, device=device))

    def loss_fn(pose, bump):
        image = render(verts_obj * (1.0 + bump[:, None]), pose)
        return torch.mean((image - target) ** 2)

    params = {"pose": torch.tensor(INIT_POSE, device=verts_obj.device),
              "bump": torch.zeros(verts_obj.shape[0],
                                  device=verts_obj.device)}
    return loss_fn, params, render, target, verts_obj


def trainer(loss_fn, params, steps):
    """(step, optimiser, (pose, bump)) of ``steps`` Adam steps from
    ``params``: pose only for the first ``steps // 2`` (bump lr 0), then
    pose + bump. ``step(t)`` takes step t (1 to ``steps``) and returns its
    loss before the update, a 0-dim tensor that the next step overwrites on
    the card; pose and bump are updated in place.

    On the card a step is one replay of a CUDA graph captured here
    (``GraphedStep``: the forward, the loss, ``backward()`` and
    ``torch.optim.Adam(capturable=True)``'s update), the counterpart of the
    JAX demo's jitted ``lax.scan``. The bump group's rate is a tensor on the
    card that each replay copies in, as the JAX demo carries its rates into
    its scan. The capture's warm-up calls took Adam steps: the leaves and
    the optimiser's state are set back to the start before this returns."""
    pose = params["pose"].detach().clone().requires_grad_()
    bump = params["bump"].detach().clone().requires_grad_()
    device = pose.device
    rate = torch.zeros((), device=device)
    opt = torch.optim.Adam([{"params": [pose], "lr": LR_POSE},
                            {"params": [bump], "lr": rate}],
                           betas=BETAS, eps=EPS,
                           capturable=device.type == "cuda")

    def adam_step(lr_bump):
        rate.copy_(lr_bump)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(pose, bump)
        loss.backward()
        opt.step()
        return loss.detach()

    rates = torch.tensor([0.0, LR_BUMP], device=device)
    graphed = GraphedStep(adam_step, (rates[0],))
    with torch.no_grad():
        pose.copy_(params["pose"])
        bump.copy_(params["bump"])
    for state in opt.state.values():
        for value in state.values():
            value.zero_()

    def step(t):
        return graphed(rates[int(t > steps // 2)])

    return step, opt, (pose, bump)


def run(step, steps, device):
    """Steps 1 to ``steps`` of ``trainer``'s ``step``: their losses
    [steps], kept on ``device`` (one copy a step) and read once after."""
    losses = torch.empty(steps, device=device)
    for t in range(1, steps + 1):
        losses[t - 1] = step(t)
    return losses


def fit(loss_fn, params, steps):
    """``steps`` Adam steps from ``params`` (``trainer`` and ``run``).
    Returns (params, the optimiser, the loss of every step before its
    update [steps])."""
    step, opt, (pose, bump) = trainer(loss_fn, params, steps)
    losses = run(step, steps, pose.device)
    return {"pose": pose.detach(), "bump": bump.detach()}, opt, losses


def checkpoint_tree(params, opt, steps):
    """The resumable state in ``dirt_tpu``'s demo layout: params, Adam's
    first and second moments by name, and the step count."""
    state = {name: opt.state[group["params"][0]]
             for name, group in zip(("pose", "bump"), opt.param_groups)}
    moments = {key: {name: s[key] for name, s in state.items()}
               for key in ("exp_avg", "exp_avg_sq")}
    return {"params": params, "m": moments["exp_avg"],
            "v": moments["exp_avg_sq"], "step": steps}


def save_run(out, params, opt, losses):
    """Write the loss curve (``demo5_metrics.csv``) and the checkpoint
    (``demo5_ckpt.npz``) to ``out``, and check that the checkpoint loads back
    equal; returns the checkpoint's path."""
    steps = len(losses)
    logger = MetricsLogger(os.path.join(out, "demo5_metrics.csv"),
                           print_every=steps)
    for i, value in enumerate(losses.tolist()):
        logger.log(i + 1, loss=value)
    logger.close()
    ckpt = os.path.join(out, "demo5_ckpt.npz")
    save_pytree(ckpt, checkpoint_tree(params, opt, steps))
    restored = load_pytree(ckpt)
    if not all(torch.equal(torch.as_tensor(restored["params"][k]),
                           params[k].cpu()) for k in params):
        raise RuntimeError("the checkpoint did not load back equal")
    return ckpt


def main(size=SIZE, steps=STEPS, n_lat=N_LAT, n_lon=N_LON, device="cuda",
         out=OUT):
    """Run the demo; returns {"l0", "l1", "losses", "steps", "ms_per_step",
    "pose", "checkpoint"}."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("demo 5 runs on a CUDA card, and none is "
                           "available (torch.cuda.is_available() is False)")
    os.makedirs(out, exist_ok=True)
    where = card_line() if device.type == "cuda" else device.type
    t0 = time.perf_counter()
    loss_fn, params, render, target, verts_obj = problem(size, n_lat, n_lon,
                                                         device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"mesh: {n_lat}x{n_lon} sphere, {size}^2 px ({where}); first "
          f"render (caps, kernel builds, target): "
          f"{time.perf_counter() - t0:.2f} s")
    save_ppm(os.path.join(out, "demo5_deferred.ppm"), target)
    with torch.no_grad():
        _, fwd_s = timed(device, render, verts_obj,
                         torch.tensor(TRUE_POSE, device=device))
    print(f"steady-state forward: {fwd_s * 1e3:.3f} ms "
          f"({size * size / fwd_s / 1e6:.1f} Mpix/s)")

    l0 = float(loss_fn(**params))
    (step, opt, (pose, bump)), setup_s = timed(device, trainer, loss_fn,
                                               params, steps)
    losses, loop_s = timed(device, run, step, steps, device)
    params = {"pose": pose.detach(), "bump": bump.detach()}
    l1 = float(loss_fn(**params))

    ckpt = save_run(out, params, opt, losses)
    ms_per_step = loop_s / steps * 1e3
    print(f"inverse rendering: loss {l0:.6f} -> {l1:.6f} ({steps} Adam "
          f"steps, {ms_per_step:.3f} ms/step; set-up and graph capture "
          f"{setup_s * 1e3:.1f} ms) ({where})")
    print("  pose", [round(x, 3) for x in params["pose"].tolist()],
          "(true", list(TRUE_POSE), ")")
    with torch.no_grad():
        final = render(verts_obj * (1.0 + params["bump"][:, None]),
                       params["pose"])
    save_ppm(os.path.join(out, "demo5_recovered.ppm"), final)
    if not l1 < 0.5 * l0:
        raise RuntimeError(f"demo 5: the loss fell only {l0} -> {l1}")
    print("saved", os.path.join(out, "demo5_deferred.ppm"))
    return {"l0": l0, "l1": l1, "losses": losses, "steps": steps,
            "ms_per_step": ms_per_step, "pose": params["pose"],
            "checkpoint": ckpt}


if __name__ == "__main__":
    main()
