"""What the reference computes for a cell: frames, and steps of a fit with
Adam from a given state.

``pipeline`` is one of this package's pipeline modules (``prepare(config,
inputs, params, prec)``); ``inputs`` and ``params`` are dicts of tensors,
converted here to the dtype of ``prec``.
"""

from __future__ import annotations

import torch

from benchmark.reference.camera import DTYPES
from benchmark.reference.raster import (
    edge_surrogate,
    interpolate,
    rasterise,
)


LOSSES = {"mse": lambda image, target: torch.mean((image - target) ** 2)}


def _as(tensors: dict, dtype):
    return {name: value if not value.is_floating_point()
            else value.to(dtype) for name, value in tensors.items()}


def frame(pipeline, config, inputs, params, prec="float64"):
    """(image [H, W, C'], raster output [H, W, C], fid [H, W]) of one
    frame, without gradients."""
    dtype = DTYPES[prec]
    with torch.no_grad():
        fv, fa, background, shade = pipeline.prepare(
            config, _as(inputs, dtype), _as(params, dtype), prec)
        size = config["size"]
        fid, _ = rasterise(fv, size, size)
        pixels = interpolate(fv, fa, fid, background, prec)
        return shade(pixels), pixels, fid


def loss_and_grads(pipeline, config, inputs, params, target, trained, prec,
                   loss_fn):
    """(loss, image, fid, {name: gradient}) of ``loss_fn(image, target)``
    with DIRT's interior and silhouette terms.

    The per-pixel shading is differentiated exactly, as TF's autodiff did
    after DIRT's ``rasterise``; DIRT's approximate gradient applies only at
    the raster. A parameter's gradient is the sum of its two routes: through
    ``shade`` with the raster output held (a texture that ``shade`` reads)
    and through the raster (DIRT's surrogate). Where one route does not
    reach it, the other is taken as it is."""
    fv, fa, background, shade = pipeline.prepare(config, inputs, params,
                                                 prec)
    size = config["size"]
    fid, zbuf = rasterise(fv, size, size)
    pixels = interpolate(fv, fa, fid, background, prec)
    held = pixels.detach().requires_grad_()
    image = shade(held)
    loss = loss_fn(image, target)
    leaves = [params[name] for name in trained]
    upstream, *shaded = torch.autograd.grad(loss, [held, *leaves],
                                            allow_unused=True)
    total = (torch.sum(pixels * upstream)
             + edge_surrogate(fv, fid, zbuf, pixels, upstream))
    rastered = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = {}
    for name, through_shade, through_raster in zip(trained, shaded,
                                                   rastered):
        if through_shade is None and through_raster is None:
            raise RuntimeError(f"the trained parameter {name!r} reaches "
                               f"neither the raster nor the shading")
        grads[name] = (through_raster if through_shade is None
                       else through_shade if through_raster is None
                       else through_shade + through_raster)
    return loss.detach(), image.detach(), fid, grads


def fit_steps(pipeline, config, inputs, state, fixed, target, fit, first,
              steps, prec="float64"):
    """Adam steps ``first`` to ``first + steps - 1`` of a fit, from
    ``state``.

    ``state`` holds the trained parameters before step ``first``
    (``"params"``) and Adam's moments (``"exp_avg"``, ``"exp_avg_sq"``;
    zeros before step 1); ``fixed`` the parameters not trained; ``target``
    the image the loss compares with. ``fit`` gives ``trained`` (names, in
    the optimiser's order), ``lr(name, t)`` (the rate of step t),
    ``betas``, ``eps`` and ``loss`` (a key of :data:`LOSSES`). Adam as
    ``torch.optim.Adam`` (no weight decay, no amsgrad): ``m = b1 m + (1 -
    b1) g``, ``v = b2 v + (1 - b2) g^2``, ``p -= lr / (1 - b1^t) * m /
    (sqrt(v) / sqrt(1 - b2^t) + eps)``.

    Returns {"losses": [steps] of the loss before each update, "image",
    "fid": step ``first``'s, "grads": its gradient per trained name,
    "change": parameters after the last step minus ``state``'s}.
    """
    dtype = DTYPES[prec]
    inputs, fixed = _as(inputs, dtype), _as(fixed, dtype)
    target = target.to(dtype)
    trained = list(fit["trained"])
    params = {name: state["params"][name].to(dtype).clone()
              for name in trained}
    m = {name: state["exp_avg"][name].to(dtype) for name in trained}
    v = {name: state["exp_avg_sq"][name].to(dtype) for name in trained}
    b1, b2 = fit["betas"]
    out = {"losses": []}
    for t in range(first, first + steps):
        for name in trained:
            params[name].requires_grad_()
        loss, image, fid, grads = loss_and_grads(
            pipeline, config, inputs, {**fixed, **params}, target, trained,
            prec, LOSSES[fit["loss"]])
        out["losses"].append(float(loss))
        if t == first:
            out.update(image=image, fid=fid, grads=grads)
        with torch.no_grad():
            for name in trained:
                g = grads[name]
                m[name] = b1 * m[name] + (1.0 - b1) * g
                v[name] = b2 * v[name] + (1.0 - b2) * g * g
                denom = (torch.sqrt(v[name]) / (1.0 - b2 ** t) ** 0.5
                         + fit["eps"])
                step = fit["lr"](name, t) / (1.0 - b1 ** t)
                params[name] = params[name].detach() - step * m[name] / denom
    out["change"] = {name: params[name].detach()
                     - state["params"][name].to(dtype)
                     for name in trained}
    return out
