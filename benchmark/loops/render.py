"""Frames: forward-only renders of the scene from a cycle of poses.

A step is one ``GraphedStep`` replay of the pipeline's forward under
``torch.no_grad()``, at the next of ``poses`` poses drawn from the seed
within ``pose_spread`` radians of the configuration's pose per axis; the
host then reads the overflow flag back.

Mix keys: ``poses``, ``pose_spread``, ``fixed`` (optional rules,
``benchmark/inputs.py``, for the parameters other than the pose),
``sampled_frames`` (how many frames
the check compares), ``sample_within`` (they are drawn from the seed among
the first this many frames of the window), ``faults``
(``benchmark/faults.py``) and ``trace_steps``.

``correct``: the sampled frames' outputs are copied to the host as the
window produces them, and compared after it with the reference's frames
at the same poses: face ids, the image and the raster's output (the
G-buffer) where the ids agree, and the overflow flag of every frame.
"""

from __future__ import annotations

import torch

from benchmark import check
from benchmark.clock import Phases
from benchmark.reference.steps import frame
from benchmark.scenes import poses_near, scene_arrays, seed_sequence


class RenderLoop:
    def __init__(self, cell, seed, device, trace):
        from benchmark import inputs
        from dirt_tpu_torch.utils.graphstep import GraphedStep

        config, mix, pipe = cell.config, cell.mix, cell.pipeline
        self.config, self.pipe = config, pipe
        self.phases = Phases(device)
        self.scene = pipe.scene(config, scene_arrays(config), device)
        self.phases.mark("scene")
        poses = poses_near(seed, "poses", config["pose"], mix["pose_spread"],
                           mix["poses"])
        self.poses = torch.as_tensor(poses, device=device)
        self.fixed = inputs.make_params(mix.get("fixed", {}), pipe, config,
                                        self.scene, seed, "fixed")
        # Caps over a grid that holds every pose, the same for every seed.
        centre = torch.tensor(config["pose"], device=self.poses.device)
        self.raster = inputs.suggested_caps(
            pipe, config, self.scene,
            [{**self.fixed, "pose": pose} for pose in
             inputs.pose_grid(centre, mix["pose_spread"])])
        self.phases.mark("caps")
        self.graphed = GraphedStep(self._frame, (self.poses[0],))
        self.phases.mark("capture")
        rng = seed_sequence(seed, "samples")
        self.samples = sorted(int(i) for i in rng.choice(
            mix["sample_within"], mix["sampled_frames"], replace=False))
        # Host buffers for the sampled frames, made in set-up from one
        # frame's outputs (pinned, so that the copies run asynchronously).
        outs = self.graphed(self.poses[0])
        self.kept = {i: [torch.empty(o.shape, dtype=o.dtype, device="cpu",
                                     pin_memory=o.is_cuda) for o in outs]
                     for i in self.samples}
        self.frame, self.failed, self.done = 0, 0, set()
        self.phases.mark("first_frame")

    def _frame(self, pose):
        with torch.no_grad():
            out = self.pipe.render(self.config, self.scene, self.raster,
                                   {**self.fixed, "pose": pose})
        return (out["image"], out["fid"], out["overflow"],
                *(out["gbuffer"] or ()))

    def step(self):
        """One frame; True unless its overflow flag was set."""
        index = self.frame
        outs = self.graphed(self.poses[index % len(self.poses)])
        if index in self.kept:
            for host, out in zip(self.kept[index], outs):
                host.copy_(out, non_blocking=True)
            self.done.add(index)
        ok = not bool(outs[2])
        self.frame += 1
        self.failed += not ok
        return ok

    def forward_ms(self, replays):
        return None

    def close(self):
        """Free the program's state; returns what the check needs."""
        collected = {"frames": {i: self.kept[i] for i in self.done},
                     "failed": self.failed,
                     "poses": self.poses.cpu(), "samples": self.samples,
                     "fixed": {k: v.cpu() for k, v in self.fixed.items()}}
        self.graphed = self.scene = self.poses = self.fixed = None
        return collected


def build(cell, seed, device, trace):
    return RenderLoop(cell, seed, device, trace)


def _gbuffer(outs):
    """The raster's output of a kept frame: the G-buffer's channels side
    by side, or the image where the pipeline has no G-buffer."""
    return torch.cat(outs[3:], -1) if len(outs) > 3 else outs[0]


def reference_frames(cell, collected, device, prec="float64"):
    """{frame: (image, raster output, fid)} of the reference at the
    sampled frames' poses."""
    arrays = scene_arrays(cell.config)
    data = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
    poses = collected["poses"]
    fixed = {k: v.to(device) for k, v in collected["fixed"].items()}
    return {i: frame(cell.reference, cell.config, data,
                     {**fixed, "pose": poses[i % len(poses)].to(device)},
                     prec)
            for i in collected["samples"]}


def compare(frames, ref):
    """Worst over the sampled frames; a frame the window never produced
    reads as infinitely far off."""
    numbers = {"fid_mismatch": 0.0, "image_gap": 0.0, "gbuffer_gap": 0.0}
    for index, (image, pixels, fid) in ref.items():
        if index not in frames:
            return {name: float("inf") for name in numbers}
        outs = frames[index]
        got_fid, fid = outs[1].cpu(), fid.cpu()
        got = {"fid_mismatch": check.fid_mismatch(got_fid, fid),
               "image_gap": check.agreeing_gap(outs[0].cpu(), image.cpu(),
                                               got_fid, fid),
               "gbuffer_gap": check.agreeing_gap(_gbuffer(outs).cpu(),
                                                 pixels.cpu(), got_fid, fid)}
        numbers = {k: max(v, got[k]) for k, v in numbers.items()}
    return numbers


def check_run(cell, collected, device):
    """(numbers, covered pixels of the first sampled reference frame)."""
    ref = reference_frames(cell, collected, device)
    numbers = compare(collected["frames"], ref)
    numbers["failed_steps"] = collected["failed"]
    first = ref[collected["samples"][0]][2]
    return numbers, int((first >= 0).sum())


def control(cell, collected, device):
    """The control's numbers: the reference in TF32 in the program's
    place, against the reference."""
    ref = reference_frames(cell, collected, device)
    low = reference_frames(cell, collected, device, "tf32")
    frames = {i: [image, fid, torch.zeros((), dtype=torch.bool), pixels]
              for i, (image, pixels, fid) in low.items()}
    return compare(frames, ref)
