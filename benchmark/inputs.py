"""Parameters and raster caps of a run, from its mix, configuration and seed.

A mix gives each parameter a rule:

* ``"true"``: the configuration's value (``pipeline.true_value``);
* ``{"near_true": s}``: that value plus a uniform draw within ``s`` per
  element (numpy, from the seed);
* ``{"fill": v}``: every element ``v``;
* ``{"uniform": [lo, hi]}``: a uniform draw on the card, from the seed.
"""

from __future__ import annotations

import torch

from benchmark.scenes import device_generator, seed_sequence


def make_param(rule, name, pipeline, config, scene, seed, stream):
    """One parameter as a float32 tensor on the scene's device."""
    device = scene["verts"].device
    shape = pipeline.shape(name, scene)
    if rule == "true":
        return pipeline.true_value(name, config, scene)
    if "near_true" in rule:
        spread = rule["near_true"]
        offset = seed_sequence(seed, stream).uniform(-spread, spread, shape)
        return pipeline.true_value(name, config, scene) + torch.as_tensor(
            offset, dtype=torch.float32, device=device)
    if "fill" in rule:
        return torch.full(shape, float(rule["fill"]), device=device)
    if "uniform" in rule:
        lo, hi = rule["uniform"]
        gen = device_generator(seed, stream, device)
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)
    raise ValueError(f"unknown parameter rule for {name}: {rule!r}")


def make_params(rules: dict, pipeline, config, scene, seed, stream):
    """{name: tensor} of every rule in ``rules``."""
    return {name: make_param(rule, name, pipeline, config, scene, seed,
                             f"{stream}.{name}")
            for name, rule in rules.items()}


def pose_grid(centre, spread: float):
    """The 27 poses of the grid {-spread, 0, +spread}^3 around ``centre``
    [3]: a fixed set that covers every pose a mix draws within ``spread``
    per axis, the same for every seed."""
    steps = torch.tensor([-spread, 0.0, spread], device=centre.device)
    grid = torch.stack(torch.meshgrid(steps, steps, steps, indexing="ij"),
                       -1).reshape(-1, 3)
    return list(centre + grid)


def widest(configs):
    """One RasterConfig whose caps are the largest of ``configs``' (they
    must agree on every field that is not a cap)."""
    out = configs[0]
    for config in configs[1:]:
        fields = {}
        for field, mine, theirs in zip(out._fields, out, config):
            if mine == theirs:
                continue
            both_caps = all(isinstance(v, int) and not isinstance(v, bool)
                            for v in (mine, theirs))
            if not both_caps:
                raise ValueError(f"suggested configs differ in {field}: "
                                 f"{mine!r} and {theirs!r}")
            fields[field] = max(mine, theirs)
        out = out._replace(**fields)
    return out


def suggested_caps(pipeline, config, scene, param_sets):
    """``suggest_raster_config``'s caps over ``param_sets`` (host-
    synchronising, once in set-up), the widest of them."""
    import dirt_tpu_torch

    size = config["size"]
    with torch.no_grad():
        return widest([dirt_tpu_torch.suggest_raster_config(
            pipeline.clip_vertices(config, scene, params), scene["faces"],
            size, size, clip=config["clip"]) for params in param_sets])
