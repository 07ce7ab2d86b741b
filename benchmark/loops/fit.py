"""Fits: Adam steps that bring a pipeline's parameters back to a target.

A step is one ``GraphedStep`` replay of the forward, the loss, ``backward()``
and ``torch.optim.Adam(capturable=True)``'s update; the host then reads the
loss and the overflow flag back, as a loop that watches its loss does. Fits
of ``steps_per_fit`` steps run back to back; each starts from the next of
``starts`` parameter sets drawn from the seed, with Adam's state zeroed.
Where the mix gives ``start_seed``, the sets are drawn from that seed, the
same in every run, and the run's seed only orders them: where a step's
time follows the pose (the packed binning at 1M faces), the seed then
changes what is fitted (the target) and not the work of the window.

Mix keys: ``steps_per_fit``, ``starts``, ``start_seed`` (optional),
``init`` and ``target`` (parameter rules, ``benchmark/inputs.py``),
``trained`` ({name: {"lr": [[from_step, rate], ...]}} in the optimiser's
order), ``betas``, ``eps``, ``loss``, ``check_from`` (the first steps of
the compared windows), ``faults`` (``benchmark/faults.py``),
``trace_steps`` (steps under the profiler) and ``forward_replays``.

``correct`` follows the training protocol: set-up drives the first fit
through the window's own call to the end of the last compared window, and
the reference follows each window's three steps. The window from step 1
starts where the program does; a later window (the step at which a rate
changes) starts from the program's parameters and Adam moments before it,
which the reference cannot reach by itself: where a gradient component
lies near zero its sign can differ between float32 and float64, Adam's
nearly sign-valued steps then part, and so do the two fits (``PERF.md``).
Compared, per window, by the worst leaf: the norm of the window's first
gradient as Adam got it (worked out from its first moment before and after
that step) and the norm of the change over the three steps; the first
step's loss, image and face ids. Numbers of a later window carry its first
step: ``grad_gap.41``.
"""

from __future__ import annotations

import math

import torch

from benchmark import check, inputs
from benchmark.clock import Phases
from benchmark.reference.steps import fit_steps, frame
from benchmark.scenes import scene_arrays, seed_sequence

CHECK_STEPS = 3


def image_loss(image, target):
    """The fit's loss: the mean squared error over every pixel."""
    return torch.mean((image - target) ** 2)


def lr_of(mix, name, t):
    """The rate of parameter ``name`` at step ``t`` (1-based)."""
    rate = None
    for first, value in mix["trained"][name]["lr"]:
        if t >= first:
            rate = value
    return rate


class FitLoop:
    def __init__(self, cell, seed, device, trace):
        from dirt_tpu_torch.utils.graphstep import GraphedStep

        config, mix, pipe = cell.config, cell.mix, cell.pipeline
        self.mix, self.pipe, self.config = mix, pipe, config
        self.phases = Phases(device)
        scene = pipe.scene(config, scene_arrays(config), device)
        self.scene = scene
        self.phases.mark("scene")
        self.target_params = inputs.make_params(
            mix["target"], pipe, config, scene, seed, "target")
        self.starts = [inputs.make_params(
            mix["init"], pipe, config, scene, mix.get("start_seed", seed),
            f"start{k}") for k in range(mix["starts"])]
        if "start_seed" in mix:
            order = seed_sequence(seed, "start_order").permutation(
                mix["starts"])
            self.starts = [self.starts[k] for k in order]
        # Caps over a grid that holds every start pose, the same for every
        # seed, so that the seed changes neither the caps nor the work.
        spread = mix["init"].get("pose", {}).get("near_true", 0.0)
        self.raster = inputs.suggested_caps(
            pipe, config, scene,
            [{**self.target_params, "pose": pose} for pose in
             inputs.pose_grid(self.target_params["pose"], spread)])
        self.phases.mark("caps")
        with torch.no_grad():
            self.target = pipe.render(config, scene, self.raster,
                                      self.target_params)["image"].clone()
        self.phases.mark("target")
        names = list(mix["trained"])
        self.fixed = {n: v for n, v in self.target_params.items()
                      if n not in names}
        self.leaves = {n: self.starts[0][n].clone().requires_grad_()
                       for n in names}
        self.rates = [torch.zeros((), device=device) for _ in names]
        on_card = self.on_card = torch.device(device).type == "cuda"
        self.opt = torch.optim.Adam(
            [{"params": [self.leaves[n]], "lr": rate}
             for n, rate in zip(names, self.rates)],
            betas=tuple(mix["betas"]), eps=mix["eps"], capturable=on_card)
        steps = mix["steps_per_fit"]
        self.lr_table = torch.tensor(
            [[lr_of(mix, n, t) for n in names] for t in range(1, steps + 1)],
            dtype=torch.float32, device=device)
        self.graphed = GraphedStep(self._adam_step, (self.lr_table[0],))
        self.phases.mark("capture")
        # The capture's warm-up calls took Adam steps: start the first fit.
        self.fit, self.t = 0, 1
        self._restart()
        self.forward = None
        if trace:
            self.forward = GraphedStep(self._forward, (self.lr_table[0],))
        self.failed = 0
        self.collected = self._first_steps()
        self.phases.mark("first_steps")

    def _params(self):
        return {**self.fixed, **self.leaves}

    def _adam_step(self, lr_row):
        for i, rate in enumerate(self.rates):
            rate.copy_(lr_row[i])
        self.opt.zero_grad(set_to_none=True)
        out = self.pipe.render(self.config, self.scene, self.raster,
                               self._params())
        loss = image_loss(out["image"], self.target)
        loss.backward()
        self.opt.step()
        flags = torch.stack([loss.detach(), out["overflow"].to(loss.dtype)])
        return flags, out["image"].detach(), out["fid"]

    def _forward(self, lr_row):
        with torch.no_grad():
            out = self.pipe.render(self.config, self.scene, self.raster,
                                   self._params())
            return image_loss(out["image"], self.target)

    def _restart(self):
        start = self.starts[self.fit % len(self.starts)]
        with torch.no_grad():
            for name, leaf in self.leaves.items():
                leaf.copy_(start[name])
            for state in self.opt.state.values():
                for value in state.values():
                    value.zero_()

    def step(self):
        """One step of the current fit (the next fit's first after the
        last); True unless the overflow flag was set or the loss is not
        finite."""
        if self.t > self.mix["steps_per_fit"]:
            self.fit, self.t = self.fit + 1, 1
            self._restart()
        flags, self.image, self.fid = self.graphed(self.lr_table[self.t - 1])
        self.loss, overflow = flags.tolist()
        self.t += 1
        ok = overflow == 0.0 and math.isfinite(self.loss)
        self.failed += not ok
        return ok

    def _state(self):
        """Host copies of the trained parameters and Adam's moments."""
        out = {"params": {}, "exp_avg": {}, "exp_avg_sq": {}}
        for name, leaf in self.leaves.items():
            out["params"][name] = leaf.detach().to("cpu", copy=True)
            state = self.opt.state.get(leaf, {})
            for key in ("exp_avg", "exp_avg_sq"):
                out[key][name] = (state[key].to("cpu", copy=True)
                                  if key in state else
                                  torch.zeros_like(out["params"][name]))
        return out

    def _first_steps(self):
        """The first fit through its compared windows, and what the check
        compares."""
        b1 = self.mix["betas"][0]
        windows = []
        for first in self.mix["check_from"]:
            if first < self.t or first + CHECK_STEPS - 1 > \
                    self.mix["steps_per_fit"]:
                raise ValueError(f"check_from {first} does not fit the mix")
            while self.t < first:
                self.step()
            before = self._state()
            losses = []
            for k in range(CHECK_STEPS):
                self.step()
                losses.append(self.loss)
                if k == 0:
                    image, fid = self.image.cpu(), self.fid.cpu()
                    moments = self._state()["exp_avg"]
                    grads = {n: (moments[n] - b1 * before["exp_avg"][n])
                             / (1.0 - b1) for n in moments}
            after = self._state()["params"]
            windows.append({
                "first": first, "state": before, "losses": losses,
                "image": image, "fid": fid, "grads": grads,
                "change": {n: after[n] - before["params"][n]
                           for n in after}})
        return {"windows": windows,
                "fixed": {n: v.cpu() for n, v in self.fixed.items()},
                "target_params": {n: v.cpu() for n, v in
                                  self.target_params.items()}}

    def forward_ms(self, replays):
        """Mean device ms of a replay of the forward and the loss alone,
        CUDA events around each replay (trace runs only)."""
        if self.forward is None or not self.on_card:
            return None
        total = 0.0
        for _ in range(replays):
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            self.forward(self.lr_table[0])
            end.record()
            end.synchronize()
            total += begin.elapsed_time(end)
        return total / replays

    def close(self):
        """Free the program's state; returns what the check needs."""
        collected = dict(self.collected, failed=self.failed)
        for name in ("graphed", "forward", "opt", "leaves", "scene", "target",
                     "image", "fid", "starts", "target_params", "fixed",
                     "rates", "lr_table"):
            setattr(self, name, None)
        return collected


def build(cell, seed, device, trace):
    return FitLoop(cell, seed, device, trace)


def spec(mix):
    """What the reference needs of the mix."""
    return {"trained": list(mix["trained"]),
            "lr": lambda name, t: lr_of(mix, name, t),
            "betas": tuple(mix["betas"]), "eps": mix["eps"],
            "loss": mix["loss"]}


def reference_readings(cell, collected, device, prec="float64"):
    """[per compared window] the reference's steps from the program's state
    before it."""
    arrays = scene_arrays(cell.config)
    data = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}

    def on(tensors):
        return {k: v.to(device) for k, v in tensors.items()}

    fixed = on(collected["fixed"])
    target, _, _ = frame(cell.reference, cell.config, data,
                         on(collected["target_params"]), prec)
    return [fit_steps(cell.reference, cell.config, data,
                      {k: on(v) for k, v in window["state"].items()}, fixed,
                      target, spec(cell.mix), window["first"], CHECK_STEPS,
                      prec)
            for window in collected["windows"]]


def _cpu(tensors):
    return {k: v.cpu() for k, v in tensors.items()}


def compare(got, ref):
    """The numbers of a fit (see the module docstring): ``got`` and ``ref``
    list the compared windows, ``got``'s with their ``first`` step."""
    numbers = {}
    for window, want in zip(got, ref):
        fid, ref_fid = window["fid"].cpu(), want["fid"].cpu()
        ref_loss = want["losses"][0]
        suffix = "" if window["first"] == 1 else f".{window['first']}"
        numbers.update({
            "loss_gap" + suffix: abs(window["losses"][0] - ref_loss)
            / abs(ref_loss),
            "grad_gap" + suffix: check.norm_gap(
                _cpu(window["grads"]), _cpu(want["grads"]),
                list(want["grads"])),
            "change_gap" + suffix: check.norm_gap(
                _cpu(window["change"]), _cpu(want["change"]),
                check.moving_leaves(want["grads"])),
            "fid_mismatch" + suffix: check.fid_mismatch(fid, ref_fid),
            "image_gap" + suffix: check.agreeing_gap(
                window["image"].cpu(), want["image"].cpu(), fid, ref_fid),
        })
    return numbers


def check_run(cell, collected, device):
    """(numbers, covered pixels of the reference's first step)."""
    ref = reference_readings(cell, collected, device)
    numbers = compare(collected["windows"], ref)
    numbers["failed_steps"] = collected["failed"]
    return numbers, int((ref[0]["fid"] >= 0).sum())


def control(cell, collected, device):
    """The control's numbers: the reference in TF32 in the program's
    place, against the reference."""
    ref = reference_readings(cell, collected, device)
    low = reference_readings(cell, collected, device, "tf32")
    for window, got in zip(low, collected["windows"]):
        window["first"] = got["first"]
    return compare(low, ref)
