"""Faults planted underneath a cell's timed path, to show that the check
refuses them (the tests, and ``calibrate.py`` on the card at full size).

Each fault is ``fault(cell) -> undo``: it replaces one function that the
timed path calls and returns what puts it back. A mix lists under
``faults`` those that its cells can have.

* ``frozen``: Adam's step hands its parameters back unchanged;
* ``frozen_one``: Adam's step hands the last trained parameter back
  unchanged (the bump of ``fit_pose_bump``) and updates the others;
* ``stale_input``: ``GraphedStep`` replays with the arguments of its first
  call, as if it never copied a later call's into its static buffers (a
  fit's rate row, a frame's pose);
* ``half_batch``: the fit's loss is the mean over the top half of the
  image only;
* ``answer``: one pixel of every rendered image is raised by 0.25 where it
  is produced;
* ``stale_pose``: frames render at half their pose, as if the pose input
  never reached the graph.

There is no exchange between chips to leave out: every cell runs on one.
"""

from __future__ import annotations

import torch


def _replace(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    return lambda: setattr(owner, name, old)


def frozen(cell):
    step = torch.optim.Adam.step

    def unchanged(self, closure=None):
        params = [p for group in self.param_groups for p in group["params"]]
        kept = [p.detach().clone() for p in params]
        step(self, closure)
        with torch.no_grad():
            for param, old in zip(params, kept):
                param.copy_(old)
    return _replace(torch.optim.Adam, "step", unchanged)


def frozen_one(cell):
    step = torch.optim.Adam.step

    def one_unchanged(self, closure=None):
        last = self.param_groups[-1]["params"]
        kept = [p.detach().clone() for p in last]
        step(self, closure)
        with torch.no_grad():
            for param, old in zip(last, kept):
                param.copy_(old)
    return _replace(torch.optim.Adam, "step", one_unchanged)


def stale_input(cell):
    from dirt_tpu_torch.utils.graphstep import GraphedStep

    call = GraphedStep.__call__

    def stale(self, *args):
        if "_first_args" not in self.__dict__:
            self._first_args = tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args)
        return call(self, *self._first_args)
    return _replace(GraphedStep, "__call__", stale)


def half_batch(cell):
    def half(image, target):
        rows = image.shape[0] // 2
        return torch.mean((image[:rows] - target[:rows]) ** 2)
    return _replace(cell.loop, "image_loss", half)


def answer(cell):
    render = cell.pipeline.render

    def altered(config, scene, raster, params):
        out = dict(render(config, scene, raster, params))
        size = config["size"]
        bump = torch.zeros_like(out["image"])
        bump[size // 2, size // 2] = 0.25
        out["image"] = out["image"] + bump
        return out
    return _replace(cell.pipeline, "render", altered)


def stale_pose(cell):
    render = cell.pipeline.render

    def stale(config, scene, raster, params):
        return render(config, scene, raster,
                      dict(params, pose=params["pose"] * 0.5))
    return _replace(cell.pipeline, "render", stale)


FAULTS = {"frozen": frozen, "frozen_one": frozen_one,
          "stale_input": stale_input, "half_batch": half_batch,
          "answer": answer, "stale_pose": stale_pose}
