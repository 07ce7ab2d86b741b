#!/usr/bin/env python3
"""Stage profiler of dirt_tpu_torch's packed engine on one CUDA card.

    python3 tools/prof_torch_stages.py [size] [--n-lat N] [--samples S]

Counterpart of ``tools/prof_stages.py``. Times each stage of a gradient
step of the bench sphere (``card_common.bench_scene(size)``: the camera,
colors and upstream gradient of ``bench.py``, ``mesh.uv_sphere(n_lat,
n_lat)``; 72 gives 10,224 faces, ``--n-lat 708`` the 1,001,112-face sphere
of the ``sphere1m_1024`` cell) at ``size`` x ``size`` (1024 by default)
under the packed engine's honest caps (``card_common.honest``),
``clip=False``. The stages, each a function of tensors on the
card:

  setup             screen_from_clip + face gather + setup_faces (the
                    planes, boxes and edge columns: one kernel)
  setup+binning     the above + bin_faces_packed
  forward kernel    pack_face_table_v2 + raster_forward_packed (K1) on
                    fixed bins
  forward total     rasterise(..., clip=False)
  fwd+bwd total     the same with loss = sum(pixels * w), loss.backward()
  backward core     backward_packed on fixed forward results
  prologue (K3)     padded_prologue
  entry rows (K2)   packed_entry_rows
  pool reduce       pool_reduce_rows
  chain             raster.chain_through_setup on the backward core's
                    cotangents and the forward's planes, as the raster
                    op's backward calls it: the setup VJP and its checks
  setup vjp         triangle_setup.setup_planes_vjp alone (its kernel)

and the glue: fwd+bwd total minus setup+binning, the forward kernel, the
backward core and the chain. For each stage: min and median ms of event-timed
synchronised calls (``utils.benchtime.device_time_stats``, what a caller
pays, host included) and, from one profiler window
(``card_common.profile``), device kernels and device busy ms per
call and the hand-written kernels' share of the busy time; a stage is
device-bound when its busy time is at least half its median, else
host-bound. Prints the card's name and power limit beside the numbers;
exits non-zero without a CUDA device. ``run`` returns the records, and
``staged_forward`` / ``staged_backward`` give the staged path's outputs,
which the card tests hold bit for bit to the API's.
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
    SAMPLES_LARGE,
    Geometry,
    bin_faces,
    render_grads,
    scene_and_config,
    setup,
)
from dirt_tpu_torch.ops import packed_bwd, raster, raster_fwd  # noqa: E402
from dirt_tpu_torch.ops import triangle_setup  # noqa: E402
from dirt_tpu_torch.ops.raster_bwd import assemble_face_gradients  # noqa: E402
from dirt_tpu_torch.ops.triangle_setup import screen_from_clip  # noqa: E402
from dirt_tpu_torch.utils.benchtime import device_time_stats  # noqa: E402

# Busy share of the median above which a stage counts as device-bound.
DEVICE_BOUND = 0.5


def forward_kernel(geo, att, bins, bg_chw, geom):
    """(table2, pixels [C, Hp, Wp], fid, zbuf [Hp, Wp]): the face table
    and K1, which reads it through the entries, as ``prepare_packed`` and
    ``_forward_impl`` run them."""
    table2 = raster_fwd.pack_face_table_v2(geo, att)
    col_one = raster_fwd.COL_ATT + att.shape[1]
    if col_one < table2.shape[1]:
        table2[:, col_one].fill_(1.0)
    pixels, fid, zbuf = raster_fwd.raster_forward_packed(
        table2, bins, bg_chw, tile_h=geom.tile_h, tile_w=geom.tile_w)
    return table2, pixels, fid, zbuf


def staged_forward(scene, config):
    """The packed forward stage by stage: (pixels [H, W, C], fid, zbuf
    [H, W], geo, att, bins with the face table attached, the
    :class:`Geometry`)."""
    _, clip, colors, faces, background, _ = scene
    size = background.shape[0]
    geom = Geometry(config, faces.shape[0], size)
    geo, att, bbox, edges = setup(clip, colors, faces, size)
    bins = bin_faces(bbox, edges, geom)
    bg_chw = raster._padded_background(background, geom.tile_h, geom.tile_w)
    table2, pixels, fid, zbuf = forward_kernel(geo, att, bins, bg_chw, geom)
    return (pixels.permute(1, 2, 0)[:size, :size], fid[:size, :size],
            zbuf[:size, :size], geo, att, bins._replace(table=table2), geom)


def _prepared(prologue, bins, geo, att, geom):
    """The packed backward's prepared inputs from the prologue's five
    outputs, as ``prepare_backward_packed`` builds them."""
    channels = att.shape[1] // 3
    return packed_bwd._PackedBwdPrep(*prologue, bins, geo, att, channels,
                                     12 + 3 * channels, geom.tile_h,
                                     geom.tile_w)


def staged_backward(geo, att, fid, zbuf, pixels, grad_pixels, bins, geom):
    """(d_geo, d_att) of the packed backward piece by piece: the prologue
    (K3), K2 on the prepared fields, the pool reduce and the face
    gradients, as ``backward_packed`` chains them."""
    prep = _prepared(packed_bwd.padded_prologue(
        fid, zbuf, pixels, grad_pixels, geom.tile_h, geom.tile_w),
        bins, geo, att, geom)
    entry_rows = packed_bwd.packed_entry_rows(prep)
    face_rows = packed_bwd.pool_reduce_rows(
        entry_rows, bins.pair_rows, bins.pool_offs, geo.shape[0], geom.bmax)
    return assemble_face_gradients(geo, att, face_rows, prep.channels)


def backward_core(geo, att, fid, zbuf, pixels, grad_pixels, bins, geom):
    """``backward_packed`` as the raster op's backward calls it."""
    return packed_bwd.backward_packed(
        geo, att, fid, zbuf, pixels, grad_pixels, bins, geo.shape[0],
        geom.tile_h, geom.tile_w, bmax=geom.bmax)


def stages(scene, config):
    """[(name, fn, args)] of the stages, on fixed intermediates of one
    staged forward (the backward's on its outputs and ``w``)."""
    _, clip, colors, faces, background, weights = scene
    size = background.shape[0]
    pixels, fid, zbuf, geo, att, bins, geom = staged_forward(scene, config)
    bg_chw = raster._padded_background(background, geom.tile_h, geom.tile_w)
    prologue = packed_bwd.padded_prologue(fid, zbuf, pixels, weights,
                                          geom.tile_h, geom.tile_w)
    prep = _prepared(prologue, bins, geo, att, geom)
    entry_rows = packed_bwd.packed_entry_rows(prep)
    fv = screen_from_clip(clip, size, size)[faces]
    fa = colors[faces]
    d_geo, d_att, _ = backward_core(geo, att, fid, zbuf, pixels, weights,
                                    bins, geom)
    return [
        ("setup", lambda c, co: setup(c, co, faces, size), (clip, colors)),
        ("setup+binning",
         lambda c, co: bin_faces(*setup(c, co, faces, size)[2:], geom),
         (clip, colors)),
        ("forward kernel",
         lambda g, a, b: forward_kernel(g, a, bins, b, geom),
         (geo, att, bg_chw)),
        ("forward total",
         lambda b, c, co: dirt_tpu_torch.rasterise(
             b, c, co, faces, config=config, clip=False),
         (background, clip, colors)),
        ("fwd+bwd total",
         lambda b, c, co: render_grads(dirt_tpu_torch.rasterise_with_aux, b,
                                       c, co, faces, weights, config, False),
         (background, clip, colors)),
        ("backward core",
         lambda g, a, *f: backward_core(g, a, *f, bins, geom),
         (geo, att, fid, zbuf, pixels, weights)),
        ("prologue (K3)",
         lambda *f: packed_bwd.padded_prologue(*f, geom.tile_h, geom.tile_w),
         (fid, zbuf, pixels, weights)),
        ("entry rows (K2)",
         lambda g: packed_bwd.packed_entry_rows(prep), (geo,)),
        ("pool reduce",
         lambda r: packed_bwd.pool_reduce_rows(
             r, bins.pair_rows, bins.pool_offs, geo.shape[0], geom.bmax),
         (entry_rows,)),
        ("chain",
         lambda v, a, dg, da: raster.chain_through_setup(
             v, a, True, True, lambda *_: (dg, da, None), planes=(geo, att)),
         (fv, fa, d_geo, d_att)),
        ("setup vjp", triangle_setup.setup_planes_vjp,
         (fv, fa, d_geo, d_att)),
    ]


def run(device, size=1024, n_lat=72, samples=None, config=None,
        profile=PROFILE_STEPS, card=""):
    """Times every stage of the scene; returns {"faces", "size", "config",
    "stages": [record], "glue_ms"}. A record holds the stage's name, min
    and median ms and, when ``profile`` (the calls of one profiler window;
    0 for none, as on the CPU) is set, kernels and busy ms per call, the
    hand-written kernels' share of the busy time and ``bound`` ("device"
    or "host"). Prints one line a stage."""
    device = torch.device(device)
    scene, config = scene_and_config(device, size, n_lat, config)
    num_faces = scene[3].shape[0]
    if samples is None:
        samples = SAMPLES_LARGE if num_faces > 100_000 else SAMPLES
    tag = f"stages {num_faces} faces {size}^2"
    print(f"[{tag}] packed, clip=False, caps {config}, {samples} samples a "
          f"stage ({card})")
    records = []
    for name, fn, args in stages(scene, config):
        t_min, t_med = device_time_stats(fn, args, samples=samples)
        rec = dict(stage=name, min_ms=t_min * 1e3, median_ms=t_med * 1e3)
        line = (f"[{tag}] {name}: min {rec['min_ms']:.4f} ms, median "
                f"{rec['median_ms']:.4f} ms")
        if profile:
            prof = card_common.profile(name, lambda: fn(*args), card,
                                       steps=profile, echo=False)
            ours = sum(ms for ms, _ in prof["ours"].values())
            rec.update(kernels=prof["kernels"], busy_ms=prof["busy_ms"],
                       ours_share=ours / prof["busy_ms"],
                       bound=("device" if prof["busy_ms"]
                              >= DEVICE_BOUND * rec["median_ms"]
                              else "host"))
            line += (f"; {rec['kernels']:.1f} device kernels, device busy "
                     f"{rec['busy_ms']:.4f} ms a call, hand-written kernels "
                     f"{100 * rec['ours_share']:.1f}% of it: "
                     f"{rec['bound']}-bound")
        print(line + f" ({card})")
        records.append(rec)
    med = {r["stage"]: r["median_ms"] for r in records}
    glue = (med["fwd+bwd total"] - med["setup+binning"]
            - med["forward kernel"] - med["backward core"] - med["chain"])
    print(f"[{tag}] glue (fwd+bwd total - setup+binning - forward kernel - "
          f"backward core - chain, medians): {glue:.4f} ms; binning ~"
          f"{med['setup+binning'] - med['setup']:.4f} ms ({card})")
    return dict(faces=num_faces, size=size, config=config, stages=records,
                glue_ms=glue)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("size", type=int, nargs="?", default=1024)
    parser.add_argument("--n-lat", type=int, default=72)
    parser.add_argument("--samples", type=int)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("prof_torch_stages: torch.cuda.is_available() is False")
    from dirt_tpu_torch.ops import _build
    from dirt_tpu_torch.utils.benchtime import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(_build.KERNELS)
    card = card_line()
    print(card)
    run("cuda", args.size, args.n_lat, args.samples, card=card)


if __name__ == "__main__":
    main()
