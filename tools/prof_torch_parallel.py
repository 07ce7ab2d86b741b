#!/usr/bin/env python3
"""Single-card cost of dirt_tpu_torch's parallel paths.

    python3 tools/prof_torch_parallel.py [size] [--samples S]

Counterpart of ``tools/prof_parallel.py``. Each parallel renderer over a
group of one member runs its whole code path (halo rows, sums and
all-gathers over one member, the bins kept for the backward, the band
backward) without any communication, so its time beside the plain
gradient step is the tax the path adds on one card. On the bench sphere
(``card_common.bench_scene(size)``, 1024 by default) under the honest
caps of ``card_common.honest`` (the packed engine), ``clip=False``, loss
``sum(pixels * w)`` back to vertices, colors and background:

  plain             dirt_tpu_torch.rasterise_with_aux (the bench step)
  sharded n=1       rasterise_sharded over LocalGroup(1)
  overlap chunks=k  rasterise_sharded(overlap_chunks=k), k = 1, 2, 4
  face n=1          rasterise_face_sharded over LocalGroup(1)

For each: min and median ms of event-timed synchronised steps
(``utils.benchtime.device_time_stats``), the tax (median minus the plain
step's) and, from a profiler window, device kernels and device busy ms a
step. Each variant's fid must equal the plain step's and its gradients lie
within 1e-4 of max |gradient| of the plain step's
(``card_common.TOL_ENGINES``); ``run`` raises otherwise. Prints the
card's name and power limit beside the numbers; exits non-zero without a
CUDA device.
"""

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import card_common  # noqa: E402
import dirt_tpu_torch  # noqa: E402
from card_common import (  # noqa: E402
    PROFILE_STEPS,
    SAMPLES,
    TOL_ENGINES,
    rel_err,
    render_grads,
    scene_and_config,
)
from dirt_tpu_torch.parallel.face_sharding import rasterise_face_sharded  # noqa: E402
from dirt_tpu_torch.parallel.group import LocalGroup  # noqa: E402
from dirt_tpu_torch.parallel.sharding import rasterise_sharded  # noqa: E402
from dirt_tpu_torch.utils.benchtime import device_time_stats  # noqa: E402


def variants():
    """[(label, render)] of the plain path and the parallel paths, each
    ``render(background, vertices, colors, faces, config=, clip=)`` as
    ``card_common.render_grads`` calls it, giving (pixels, fid, zbuf,
    overflow)."""
    def sharded(chunks=None):
        return lambda bg, v, c, f, config, clip: rasterise_sharded(
            bg, v, c, f, LocalGroup(1), config=config,
            overlap_chunks=chunks, with_aux=True)

    return [("plain", dirt_tpu_torch.rasterise_with_aux),
            ("sharded n=1", sharded()),
            *((f"overlap chunks={k}", sharded(k)) for k in (1, 2, 4)),
            ("face n=1", lambda bg, v, c, f, config, clip:
             rasterise_face_sharded(bg, v, c, f, LocalGroup(1),
                                    config=config, with_aux=True))]


def run(device, size=1024, n_lat=72, samples=SAMPLES, config=None,
        profile=PROFILE_STEPS, card=""):
    """Times the plain step and every parallel path; returns {"faces",
    "size", "config", "variants": [record]}, each record with the label,
    min and median ms, the tax in ms, the gradients' largest relative
    difference from the plain step's and, when ``profile``, the calls of
    one profiler window, is not 0 (on a card only), device kernels and busy
    ms a step. Raises if a variant's fid
    differs from the plain step's, its overflow flag is set, or its
    gradients differ by more than TOL_ENGINES."""
    device = torch.device(device)
    scene, config = scene_and_config(device, size, n_lat, config)
    _, clip, colors, faces, background, weights = scene
    tag = f"parallel {faces.shape[0]} faces {size}^2"
    print(f"[{tag}] caps {config}, {samples} samples a variant ({card})")
    args = (background, clip, colors)
    records, plain = [], None
    for label, render in variants():
        def step(bg, v, c, render=render):
            return render_grads(render, bg, v, c, faces, weights, config,
                                False)

        (_, fid, _, overflow), grads = step(*args)
        if plain is None:
            plain = fid, grads
        errs = [rel_err(g, w) for g, w in zip(grads, plain[1])]
        if (bool(overflow) or not torch.equal(fid, plain[0])
                or not all(e <= TOL_ENGINES for e in errs)):
            raise RuntimeError(
                f"[{tag}] {label}: overflow {bool(overflow)}, "
                f"{int((fid != plain[0]).sum())} fids differ from the plain "
                f"step's, max |grad diff| / max |grad| {errs} (limit "
                f"{TOL_ENGINES:g})")
        t_min, t_med = device_time_stats(step, args, samples=samples)
        rec = dict(variant=label, min_ms=t_min * 1e3, median_ms=t_med * 1e3,
                   grad_err=max(errs))
        rec["tax_ms"] = rec["median_ms"] - (records[0]["median_ms"]
                                            if records else rec["median_ms"])
        line = (f"[{tag}] {label}: min {rec['min_ms']:.4f} ms, median "
                f"{rec['median_ms']:.4f} ms, tax {rec['tax_ms']:+.4f} ms; fid "
                f"equal, max |grad diff| / max |grad| {rec['grad_err']:.3g}")
        if profile:
            prof = card_common.profile(label, lambda: step(*args), card,
                                       steps=profile, echo=False)
            rec.update(kernels=prof["kernels"], busy_ms=prof["busy_ms"])
            line += (f"; {rec['kernels']:.1f} device kernels, device busy "
                     f"{rec['busy_ms']:.4f} ms a step")
        print(line + f" ({card})")
        records.append(rec)
    return dict(faces=faces.shape[0], size=size, config=config,
                variants=records)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("size", type=int, nargs="?", default=1024)
    parser.add_argument("--samples", type=int, default=SAMPLES)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("prof_torch_parallel: torch.cuda.is_available() is False")
    from dirt_tpu_torch.ops import _build
    from dirt_tpu_torch.utils.benchtime import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(_build.KERNELS)
    card = card_line()
    print(card)
    run("cuda", args.size, samples=args.samples, card=card)


if __name__ == "__main__":
    main()
