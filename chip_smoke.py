#!/usr/bin/env python3
"""Smoke run of dirt_tpu_torch on one CUDA card (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's main path at full size, the way a user calls it: the
10,224-face bench sphere (``mesh.uv_sphere(72, 72)``, the camera of
``bench.py``) rendered at 1024x1024 with 3 channels through
``suggest_raster_config`` + ``rasterise_with_aux``, forward and backward,
with ``clip=False`` and ``clip=True``. Phases, one line each (any failure
raises and exits non-zero; nothing is caught):

1. torch / CUDA versions and the card's name and power limit;
2. build of every CUDA kernel of the path from ``dirt_tpu_torch/csrc``
   (one nvcc each, in parallel), with ptxas registers and spills;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (the bench scene's real bins, rows and outputs, and the
   bench's upstream gradient ``RandomState(1).rand(1024, 1024, 3)``):
   raster_fwd_packed's fid, zbuf and pixels equal bit for bit;
   packed_prologue (``padded_prologue``, on what the packed backward hands
   it: the forward's cropped fid and depth, its pixels as the permuted view
   of its [C, Hp, Wp] output, the upstream gradient) its five outputs
   (padded fid, bits, sval, padded pixels and gradient) equal bit for bit;
   packed_bwd entry rows allclose(rtol=1e-5, atol=1e-6),
   and the values whose bits differ from the plain version's;
4. the main path: forward checks (overflow flag clear, equal nonzero
   covered pixels with and without clipping), then ``loss = sum(pixels *
   w)`` and ``loss.backward()`` to vertices, colors and background:
   finite, nonzero vertex and color gradients, d_background equal to w
   on background and 0 on covered pixels, launch counts > 0 for all three
   kernels, one prologue launch per backward, two packed forwards and
   their binnings' ten max_scan launches, the kernel path's
   gradients against the same path with every kernel replaced by its
   plain version (max |diff| <= 1e-5 max |grad|), and the times (median
   of 10, CUDA events) of the forward, the fwd+bwd step, the backward
   alone and fwd+bwd Mpix/s;
5. a few training steps: Adam on the L2 loss to a target render, from a
   perturbed pose and perturbed colors; the loss must fall;
6. the three packed kernels against their plain versions at 9 channels
   (the deferred G-buffer's count) on the bench sphere;
7. the dense engine's kernels, raster_fwd_dense and fused_bwd, against
   their plain versions at three shapes: config 4 of ``bench_configs.py``
   (2,208-face sphere, 512x512, 3 channels), the bench sphere at 1024x1024
   with ``engine="dense"``, and the flagship step's G-buffer (2,208 faces,
   256x256, 9 channels); config 4's and the flagship's faces are the ones
   the path's own render hands the raster op (after the near-plane clip),
   captured from one run of it: raster_fwd_dense (which culls each tile's
   list by boxes it works out from the face table, as raster_fwd_csr does)
   against the plain walk that tests every listed face at every pixel, on
   the whole padded arrays: fid and zbuf equal, pixels allclose(rtol=1e-6,
   atol=1e-6), and its boxes equal to their plain version; its line gives
   the faces tested per pixel without the cull and with it; the prologue
   on what the backward hands it, its five outputs bit for bit against its
   plain version; fused_bwd on those fields and boxes: cotangent rows
   within 1e-5 of the column's largest magnitude + 1e-6 (the kernel sums
   float32 in a fixed order, the plain
   version float64), and equal on a second run; each line carries a
   SHA-256 prefix of the kernel's inputs (the backward's also of the
   upstream gradient alone) and the backward's of its rows, so two trees
   and two runs can be compared bit for bit from their logs;
8. the deferred pipeline at full width, forward and ``loss.backward()`` to
   vertices and pose: config 5 of ``bench_configs.py`` (10,224 faces,
   1024x1024, 9-channel G-buffer, packed engine, texture + Phong) and the
   flagship step ``dirt_tpu_torch.entry.entry()`` (2,208 faces, 256x256,
   dense engine); overflow clear, gradients finite and within 1e-4 of max
   |gradient| of the same path with every kernel replaced by its plain
   version, launch counts > 0 and one prologue launch per backward (also
   in phases 9 and 11); then 10 Adam steps on the flagship loss
   over (vertices, pose), which must fall;
9. configs 1-4 of ``bench_configs_torch.py`` (the port's sheet of
   ``bench_configs.py``'s scenes, which phases 7 and 8 take too), once
   each: forward and a gradient step on the auto (dense) engine under
   honest caps, overflow clear, times;
10. the streaming (CSR) engine's kernels, raster_fwd_csr and fused_bwd_csr,
    against their plain versions at three shapes: the 99,904-face sphere
    (``mesh.uv_sphere(224, 224)``, the camera and colors above) at 1024x1024
    with 3 and with 9 channels, on the faces the default API's own render
    hands the raster op, and the 10,224-face bench sphere under
    ``RasterConfig(streaming=True)``; same checks and tolerances as phase 7,
    raster_fwd_csr against the plain walk on the whole padded arrays, and
    its boxes against their plain version; its line gives the faces tested
    per pixel without the cull and with it; fused_bwd_csr's line gives the
    device time of each of its two launches (a profiler window);
11. the default API on the 99,904-face sphere, as a user calls it:
    ``suggest_raster_config(verts, faces, 1024, 1024)`` (which must choose
    the csr engine), ``rasterise_with_aux`` and ``loss.backward()`` to
    vertices, colors and background: overflow clear, the streaming kernels
    launched and no other engine's, gradients finite, nonzero and within
    1e-5 of max |gradient| of the plain path's, d_background equal to w off
    the mesh and 0 on it; against the packed engine on the same scene:
    differing fid pixels at most 1e-4 of the covered ones, gradients within
    1e-4 of max |gradient|; times of both engines; and a two-triangle quad
    over a 64x256 image under ``RasterConfig(streaming=True)``;
12. the scatter kernels, scatter_faces and scatter_faces_csr, against their
    plain versions on what the row-sharded path's own backward hands them
    (captured from one run of it: the cotangents, owners, bins and boxes of
    ``rasterise_sharded`` with one slab): the bench sphere at 1024x1024
    under ``RasterConfig(engine="dense")`` with 3 channels (21 cotangent
    columns), 9 (39) and 16 (60), the same under ``streaming=True``, and the
    99,904-face sphere on its CSR bins: rows within 1e-5 of the column's
    largest magnitude + 1e-6 and, value by value, within 1e-5 of the sum of
    the magnitudes that value adds up (so one dropped pixel of any face
    shows), equal on a second run; beside the kernel's and the plain
    version's time that of one float32 ``index_add_`` of the owned pixels'
    rows, gathered contiguous outside the timing (PyTorch's own scatter,
    which sums with atomics; it is timed here and used nowhere in the
    package), and beside these single-call times the device time alone of
    the kernel's two passes and of ``index_add_`` (a ``torch.profiler``
    window) and the host's time to queue the wrapper's call; the packed
    backward at 16 channels (60 columns, two launches'
    worth) against its plain version; and the layout swap, subtile_swap,
    on the five per-pixel fields the packed slab's halo backward hands it
    (12 planes at 3 channels): equal to its plain version bit for bit, its
    own inverse, with the time of one strided ``contiguous()`` copy of the
    stacked planes beside it, as single calls and as device time alone (a
    profiler window), and the packed backward on the swapped fields
    bit-equal to the same kernel on image-layout fields, both timed;
13. the row-sharded renderer at full width, all slabs on the one card
    (``parallel.group.LocalGroup``), with 1 and with 4 slabs:
    ``rasterise_sharded`` of the bench sphere under the dense, the streaming
    and the packed engine and of the 99,904-face sphere under the streaming
    engine, each under ``suggest_raster_config``'s caps: overflow clear, fid
    equal to the single-device ``rasterise_with_aux``'s and pixels within
    3e-5 (slabs evaluate the planes at slab-local rows); ``loss = sum(pixels
    * w)`` backward to vertices, colors and background: finite, nonzero,
    within 1e-4 of max |gradient| of the single-device gradients and, with 4
    slabs, within 1e-5 of the same path with every kernel replaced by its
    plain version; launch counts: the engine's forward kernel once per slab,
    and scatter_faces / scatter_faces_csr / subtile_swap + packed_bwd once
    per slab, no other engine's; times of forward and fwd+bwd. Then
    ``entry.dryrun_multichip(4)`` (five Adam steps of the data x tiles
    training step, whose loss must fall, the two-level render, and the
    overlapped and face-sharded renders of the same scene, whose losses
    must be 2128.7512 +- 1e-3), and one step through a ``torch.distributed``
    group of one rank (NCCL, a ``file://`` store in a temporary directory),
    which must equal the one-slab local step; in the same group one step
    each of phase 15's two paths, which must equal their ``LocalGroup(1)``
    steps within 1e-5 of max |gradient|; and the three steps again as
    CUDA-graph replays (the capture takes the one-rank group's NCCL
    collectives), held to the same local steps;
14. the bench, the config store and the OBJ loader: ``bench_torch.py``'s
    tracked step (``bench_torch.measure``: the bench sphere at 1024x1024,
    ``clip=False``, the caps of phase 4) for three samples through
    ``utils.benchtime``, whose times must be finite and positive, with the
    packed kernels launched (one prologue per backward); a RasterConfig
    through ``utils.configstore`` in a temporary file (equal after the
    round trip, kept by ``cached_config`` after one overflow-checked
    render on the card, and a stale entry replaced by caps that do not
    overflow); and a 1,472-face UV sphere written as OBJ, loaded by the
    native parser (``io.objloader``, built with g++ on first use; equal
    to the Python parser's), rendered at 1024x1024 by the packed engine
    on the card: fid and zbuf equal to the plain path's, pixels within
    1e-6;
15. the overlapped and the face-sharded renderers at full width (run
    after phase 13, before 14). ``rasterise_sharded(overlap_chunks=k)`` of
    the bench sphere, packed, under the caps of phase 4, with 1 and 4 local
    slabs at k = 1, 2, 4: raster_fwd_packed and subtile_swap launched once
    per slab and packed_bwd once per slab and chunk, and no other kernel;
    every packed_bwd launch on a chunk slice bit-equal to its plain
    version on the same slice, and each slab's slices concatenated equal
    to one launch over its whole budget; image and fid equal to the
    non-overlapped sharded render's; gradients within 1e-5 of max
    |gradient| of the single-device step and of the non-overlapped
    sharded step. ``rasterise_face_sharded`` over four local
    members on the bench sphere under the dense engine's caps (each member
    runs raster_fwd_dense) and on the 99,904-face sphere under the packed
    engine's (raster_fwd_packed): the forward kernel once per member and no
    other kernel, fid equal to the single-device render's, pixels within
    3e-5, gradients within 1e-4. Times (medians of 10, fwd+bwd) of the bench
    sphere under phase 4's caps: single device, sharded with 1 and 4 slabs,
    overlapped with 1 and 4 slabs at k = 1, 2, 4, face-sharded with 1 and 4
    members;
16. the port's demos, each through its ``main`` (``demos/torch_demo*.py``)
    writing into a temporary directory: demos 1 (square, 64x64) and 2
    (cube, 256x256): fid and image equal to the same render with every
    kernel replaced by its plain version; demos 3 (texture
    recovery, 512x512, 60 steps), 4 (light and pose, 512x512, 80 steps)
    and 5 (deferred inverse rendering, 10,224 faces, 1024x1024, 9-channel
    G-buffer, packed engine, 80 Adam steps): the first step's gradients
    within 1e-4 of max |gradient| of the plain path's, the loss fallen by
    the demo's own ratio (0.3, 0.25, 0.5 of the first), each kernel of the
    path (demo 3, which trains the texture alone, so that no gradient
    reaches the raster op: raster_fwd_dense; demo 4: raster_fwd_dense,
    packed_prologue, fused_bwd; demo 5: raster_fwd_packed, packed_prologue,
    packed_bwd) launched and no other kernel (the loops' steps are
    CUDA-graph replays: each kernel launched in the demo's ``trainer``, by
    the capture's warm-up calls and the captured call, and none in the
    loop), ms/step of each loop (CUDA events), and demo 5's checkpoint
    loaded back equal;
17. the 1,001,112-face sphere (``mesh.uv_sphere(708, 708)``, the bench
    camera and colors, 1024x1024, ``clip=False``), one fwd+bwd under the
    packed engine (what ``suggest_raster_config`` picks) and one under the
    streaming engine, each under its honest caps: overflow clear, only the
    engine's kernels launched, gradients finite and nonzero, fids equal
    between the engines, pixels within 3e-5 and gradients within 1e-4 of
    max |gradient|; the caps, their set-up time, the peak memory of each
    step, its time (first call, then the median of 3) and its device time
    from a profiler window with the four largest device items (no
    plain-version comparison at this size: the plain walk alone takes
    seconds on 99,904 faces);
18. the port's profilers, ``tools/prof_torch_stages.py``,
    ``prof_torch_binning.py`` and ``prof_torch_parallel.py``, through their
    ``run`` (2 samples a line; profiler windows of 2 calls, none in the
    binning tool) on the bench sphere under phase 4's caps and
    on the 1,001,112-face sphere under ``suggest_raster_config``'s (the
    parallel tool on the bench sphere only), each line beside the card's
    name and power limit, with the checks that they time the work the API
    does: the staged forward (setup, binning, raster_fwd_packed) gives
    pixels, fid and zbuf equal bit for bit to ``rasterise_with_aux``'s, and
    packed_prologue -> packed_bwd -> the pool reduce the output of
    ``backward_packed`` bit for bit, on both scenes; ``bin_faces_packed(...,
    _stage=0)`` equal field by field to the call without ``_stage``; on the
    bench sphere the ten ``_stage`` checksums on the card equal to the
    CPU's from the same inputs; the binning tool's five scans
    (``binning._cummax``, the max_scan kernel) each on the input it gets,
    beside ``torch.cummax``, the two equal; the parallel tool's variants
    (sharded, overlapped with 1, 2, 4 chunks, face-sharded, one member
    each) with the plain step's fid and gradients within 1e-4 of max
    |gradient|;
    raster_fwd_packed, packed_prologue, packed_bwd and max_scan launched;
    then max_scan (the packed binning's running maxima, a kernel that
    stands for XLA's ``lax.cummax``) against its plain version,
    ``torch.cummax``, which is also its library yardstick, at 4,993,724
    and 99,392 elements of runs: equal bit for bit, single calls, device
    time alone, the bound of 16 B an element; and, on both scenes of the
    tools at C = 3, and on the bench sphere at C = 9 too (the G-buffer's
    channels, another register instance), setup_vjp (the setup's
    vector-Jacobian product, which stands for XLA's fused autodiff of the
    triangle setup) against its plain version with random cotangents
    (``d_att`` a view of [F, 12 + 3C] rows): equal bit for bit, one
    launch a call, its time over calls queued back to back (CUDA events)
    beside its bound (164 + 36C B a face), the plain version's and
    autograd through ``setup_planes``, the chain it replaced (its library
    yardstick);
19. the compiled steps: each path eager and as CUDA-graph replays
    (``dirt_tpu_torch.utils.graphstep.GraphedStep``, the counterpart of the
    reference's ``jax.jit`` and ``lax.scan``): the bench sphere at
    1024x1024 under the packed (phase 4's caps), dense and csr engines with
    ``clip`` off and on, the flagship step (``entry.entry_step``'s value
    and gradient), demo 5's 80 Adam steps (``trainer`` and ``run``) and the
    1,001,112-face sphere, packed. Each eager step runs once under
    ``torch.cuda.set_sync_debug_mode("error")``; the capture must launch
    each of the eager step's kernels once per warm-up call and once in the
    captured call (a replay launches nothing through a wrapper); the first
    replay against the eager call: pixels, fid and overflow equal bit for
    bit, gradients within 1e-5 of max |gradient| (the deferred paths
    1e-4: torch's atomics), demo 5's losses and final pose and bump within
    1e-4, and two eager loops of demo 5 equal bit for bit (since the
    vertex normals sum in a sorted order); medians (3 for the 1M-face
    step, 10 otherwise; demo 5: ms a step of each loop), device kernels a
    call and the busy share of a profiler window, peak memory with the
    graph's pool;
20. the compiled steps of the paths the reference also compiles
    (``__graft_entry__``'s jitted train step and gradients, demos 3-4's
    jitted ``lax.scan``, the sheet's jitted loop), each eager and as
    CUDA-graph replays with phase 19's checks (one eager step under
    ``set_sync_debug_mode("error")``, the capture launching each of the
    eager step's kernels ``WARMUP + 1`` times, the first replay against
    eager) and a second replay on other inputs against eager:
    ``rasterise_sharded`` with four local slabs on the bench sphere under
    the dense, csr and packed engines and on the 99,904-face sphere under
    csr; the overlapped step (packed, four slabs, k = 2 and 4);
    ``rasterise_face_sharded`` over four members, dense on the bench
    sphere and packed on the 99,904-face sphere (pixels, fid and overflow
    bit for bit, gradients within 1e-5 of max |gradient|); the dry run's
    training loss (1e-4: torch's atomics in the vertex normals), then
    ``dryrun_multichip(4)`` graphed: five Adam steps as replays whose loss
    falls and stays within 1e-4 of the eager dry run's, variants at
    2128.7512 +- 1e-3 with their largest vertex gradients within 1e-5 of
    the eager ones, each kernel launched ``WARMUP + 1`` times of the eager
    one-step dry run's; demos 3 and 4's loops (60 and 80 steps) as
    demo 5's in phase 19, their losses falling below 0.3 and 0.25 of the
    first; the sheet's five configs' gradient steps (configs 3-5 within
    1e-4). Medians of 10, kernels a call, busy share, peak memory and pool.

Phase 9 runs each config once, phases 13 and 15 take medians of 5 and
phases 12, 19 and 20 of 10, to keep the whole run under four minutes (the
``[total]`` line gives each phase's seconds). The line before the last is
the kernels' JSON record (``library_ms`` where phase 12 times one PyTorch
call of the same function: ``index_add_`` for the scatters, a strided copy
for the swap; phase 18 ``torch.cummax`` for the max-scan and autograd
through ``setup_planes`` for the setup VJP), the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.

Every launch count above counts max_scan too: the packed binning scans
five times a call, and the port bins packed only in the packed forward,
ahead of its one raster_fwd_packed launch, so each path must launch
max_scan five times for each raster_fwd_packed launch (none on the dense
and CSR paths, none on a plain path); phase 18's tools, which also bin
without the forward, stop at ``_stage`` hooks and time single scans, at
least five times for each raster_fwd_packed launch. They count setup_vjp
too: one launch a backward, so as many as the prologue's on a
single-device path (none on a forward alone), one per slab of the
row-sharded paths, per slab and chunk of the overlapped one and per member
of the face-sharded one, none on a plain path.
"""

import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

import bench_configs_torch
# The bench's scene and camera, and the roofline's peaks and operation
# counts (one place for both scripts).
from bench_torch import (
    TEST_FLOPS,
    attr_flops as _attr_flops,
    bench_scene,
    bound as _bound,
    camera_clip as _clip_verts,
    card_line,
    core_flops as _core_flops,
)

SIZE = 1024
CHANNELS = 3
RUNS = 10
TOL = dict(rtol=1e-6, atol=1e-6)
# packed_bwd against its plain version: the same expressions, and every
# row summed over its pixels in the same order, both built to round each
# step (-fmad=false, IEEE division); the margin allows for a CUDA
# elementwise kernel of torch rounding one step otherwise.
TOL_BWD = dict(rtol=1e-5, atol=1e-6)
# Gradients of the kernel path against the plain path, as max |diff| over
# max |gradient|: the same entry rows (up to TOL_BWD), then identical
# torch ops whose scatter-adds (autograd's index backward) may sum in
# another order.
TOL_GRAD = 1e-5
# fused_bwd against its plain version, per column: |diff| <= TOL_ROWS *
# max |column| + 1e-6. The kernel sums float32 in its own fixed order; the
# plain version sums float64 and rounds once.
TOL_ROWS = 1e-5
# The deferred pipeline's gradients, kernel path against plain path, as max
# |diff| over max |gradient|: besides the kernels' rows, torch's own
# scatter-adds (vertex normals, texture and vertex gathers) sum with atomics.
TOL_DEFERRED = 1e-4
KERNELS = ("raster_fwd_packed", "packed_prologue", "packed_bwd",
           "raster_fwd_dense", "fused_bwd", "raster_fwd_csr", "fused_bwd_csr",
           "scatter_faces", "scatter_faces_csr", "subtile_swap")
CSR_PATH = ("raster_fwd_csr", "packed_prologue", "fused_bwd_csr")
# The port's kernel that stands for no Pallas kernel: the packed binning's
# running maxima (XLA's lax.cummax in the reference), five launches a call.
SCAN = "max_scan"
SCAN_REPLACES = ("none: XLA's lax.cummax, dirt_tpu/ops/binning.py:514, "
                 ":515, :626, :701, :702")
# max_scan launches a bin_faces_packed call: its five running maxima.
SCANS_PER_BINNING = 5
# The port's kernel that pulls the plane cotangents back through the
# triangle setup, one launch a backward (a slab's, a chunk's or a member's
# on the parallel paths); phase 18 holds it to its plain version.
SETUP_VJP = "setup_vjp"
SETUP_VJP_REPLACES = ("none: XLA's fused autodiff of "
                      "dirt_tpu/ops/triangle_setup.py")
# Every kernel the launch checks count.
COUNTED = KERNELS + (SCAN, SETUP_VJP)
# Lengths phase 18 times the scan at: the 1,001,112-face sphere's pool
# (sphere1m_1024's pool_cap) and the bench sphere's.
SCAN_SIZES = (4_993_724, 99_392)
REPLACES = {
    "raster_fwd_packed": "dirt_tpu/ops/raster_fwd.py:413",
    "packed_prologue": "dirt_tpu/ops/packed_bwd.py:293",
    "packed_bwd": "dirt_tpu/ops/packed_bwd.py:96",
    "raster_fwd_dense": "dirt_tpu/ops/raster_fwd.py:38",
    "fused_bwd": "dirt_tpu/ops/fused_bwd.py:44",
    "raster_fwd_csr": "dirt_tpu/ops/raster_fwd.py:197",
    "fused_bwd_csr": "dirt_tpu/ops/fused_bwd.py:233",
    "scatter_faces": "dirt_tpu/ops/scatter.py:33",
    "scatter_faces_csr": "dirt_tpu/ops/scatter.py:150",
    "subtile_swap": "dirt_tpu/ops/raster_fwd.py:660",
}
# The kernels one slab of the row-sharded renderer launches, by engine: the
# forward, and the reduction of its halo backward (for the packed engine the
# layout swap of its per-pixel fields before it).
SHARDED_PATH = {
    "dense": ("raster_fwd_dense", "scatter_faces"),
    "csr": ("raster_fwd_csr", "scatter_faces_csr"),
    "packed": ("raster_fwd_packed", "subtile_swap", "packed_bwd"),
}
# The sharded render against the single-device one: slabs evaluate the
# planes at slab-local row offsets (tests/test_sharding.py's tolerance).
TOL_SLAB_PIXELS = 3e-5
# The streaming engine against the packed engine on one scene: gradients as
# max |diff| over max |gradient| (one forward arithmetic, two reductions in
# other orders), and differing face ids as a share of the covered pixels.
TOL_ENGINES = 1e-4
TRAIN_STEPS = 10
# Chunk counts of the overlapped backward in phase 15.
OVERLAP_CHUNKS = (1, 2, 4)
# The loss that variants 2-4 of dryrun_multichip give (one image), as
# __graft_entry__.dryrun_multichip prints it on four CPU devices.
DRYRUN_LOSS = 2128.7512
# setup_vjp launches of the dry run: a training step's four slab backwards
# (data=2 x tiles=2), and its variants' (the two-level group's four slabs,
# two slabs x two chunks overlapped, four face-sharded members).
DRYRUN_STEP_VJPS = 4
DRYRUN_VARIANT_VJPS = 4 + 2 * 2 + 4


def packed_forward_bound(bins, tile_h, channels, fid):
    """raster_fwd_packed's bound, from ``bins`` and the forward's [Hp, Wp]
    face ids: the 14 test columns (0..13) of each live job's row, and the
    denominator, id and 3C attribute columns (14..17, 19..) once for each
    distinct winning row (a face wins at most one row of an 8 x 16
    subtile); the per-tile and per-strip fields; the background where no
    face won; the three outputs written once. One coverage and depth test
    per (pixel, live iteration) and one attribute evaluation per covered
    pixel."""
    hp, wp = fid.shape
    live = _packed_live(bins, tile_h)
    hit = fid >= 0
    covered = int(hit.sum())
    ys, xs = torch.nonzero(hit, as_tuple=True)
    subtile = (ys // 8) * (wp // 16) + xs // 16
    won = int(torch.unique(subtile * (int(fid.max()) + 1)
                           + fid[hit].long()).numel())
    meta_bytes = 4 * (2 * bins.n_iters.numel() + 2 * bins.iter_off.numel())
    return _bound(live * 8 * 14 * 4 + won * (4 + 3 * channels) * 4
                  + meta_bytes + 4 * hp * wp * (channels + 2)
                  + 4 * (hp * wp - covered) * channels,
                  live * 1024 * TEST_FLOPS + covered * _attr_flops(channels))


def prologue_bound(height, width, hp, wp, channels):
    """padded_prologue's bound: fid, depth, pixels and gradient of the
    [H, W] image read once (8 + 8C bytes a pixel); padded fid, bits, four
    sval planes, padded pixels and gradient written once (24 + 8C bytes a
    padded pixel); per padded pixel and direction 3C + 1 operations."""
    return _bound(height * width * (8 + 8 * channels)
                  + hp * wp * (24 + 8 * channels),
                  hp * wp * 4 * (3 * channels + 1))


def _prologue_check(tag, args, card, runs=0, plain_runs=0):
    """packed_prologue (``padded_prologue``) against its plain version on
    ``args`` (fid, zbuf, pixels, grad_pixels, tile_h, tile_w), its five
    outputs bit for bit; with ``runs`` its times and bound too. Returns
    (the kernel's outputs, {max_abs_err, and with ``runs`` ms, plain_ms,
    bound_ms, bound_by}); raises on a mismatch."""
    from dirt_tpu_torch.ops import packed_bwd

    got = packed_bwd.padded_prologue(*args)
    want = packed_bwd.padded_prologue_plain(*args)
    _sync()
    names = ("fid_p", "bits", "sval", "pix_cf", "grad_cf")
    bad = {n: int((g.view(torch.int32) != w.view(torch.int32)).sum())
           for n, g, w in zip(names, got, want)}
    err = float((got[2] - want[2]).abs().max())
    record = dict(max_abs_err=err)
    timing = ""
    if runs:
        height, width, channels = args[2].shape
        _, hp, wp = got[3].shape
        record.update(
            ms=_median_ms(lambda: packed_bwd.padded_prologue(*args), runs),
            plain_ms=_median_ms(
                lambda: packed_bwd.padded_prologue_plain(*args), plain_runs),
            **prologue_bound(height, width, hp, wp, channels))
        timing = (f"; kernel {record['ms']:.4f} ms, plain "
                  f"{record['plain_ms']:.4f} ms, bound "
                  f"{record['bound_ms']:.4f} ms by {record['bound_by']} "
                  f"(medians of {runs} and {plain_runs})")
    print(f"[{tag}] packed_prologue fid {tuple(args[0].shape)} strides "
          f"{args[0].stride()}, pixels {tuple(args[2].shape)} strides "
          f"{args[2].stride()}, grad strides {args[3].stride()} -> padded "
          f"{tuple(got[3].shape)}: values whose bits differ from the plain "
          f"version's {bad} (bits nonzero {int((want[1] != 0).sum())}), max "
          f"|sval diff| {err:.3g}{timing} ({card})")
    if any(bad.values()):
        raise RuntimeError(f"[{tag}] packed_prologue disagrees with its "
                           "plain version")
    return got, record


def _sync():
    torch.cuda.synchronize()


class _Laps:
    """Seconds each phase of :func:`main` took, in the order run."""

    ORDER = ("1-2", *map(str, range(3, 14)), "15", "14",
             *map(str, range(16, 21)))

    def __init__(self):
        self.seconds, self.start = [], time.perf_counter()

    def lap(self):
        """Close the phase that began at the last lap."""
        now = time.perf_counter()
        self.seconds.append(now - self.start)
        self.start = now

    def __str__(self):
        return ", ".join(f"{phase}: {s:.1f}"
                         for phase, s in zip(self.ORDER, self.seconds))


def _median_ms(fn, runs=RUNS, warmup=2):
    """Median of ``runs`` single-call times (CUDA events), in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, runs=20, warmup=3):
    """{device kernel name: ms per call} of ``fn`` from a ``torch.profiler``
    window of ``runs`` calls: the card's own time, without the host's. A
    window that comes back without device records (the tracer now and then
    drops one) is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(3):
        _sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            _sync()
        by_name = {}
        for event in prof.events():
            if event.device_type == torch.autograd.DeviceType.CUDA:
                by_name[event.name] = (by_name.get(event.name, 0.0)
                                       + event.device_time / 1e3 / runs)
        if by_name:
            return by_name
    raise RuntimeError("the profiler recorded no device activity")


def _queued_ms(fn, runs=RUNS, warmup=3):
    """(ms per call of ``runs`` calls queued back to back with no
    synchronise between them, the host's ms to queue one of them)."""
    for _ in range(warmup):
        fn()
    _sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / runs
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs, host


def _bench_scene(device):
    """``bench_torch.bench_scene`` at SIZE (CHANNELS = 3 channels):
    (object-space vertices, clip-space vertices, colors, faces, background,
    weights)."""
    return bench_scene(SIZE, device)


def _rel_err(got, want):
    """max |got - want| / max |want| (0 when both are 0)."""
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    return diff / scale if scale else diff


def _grads(rasterise, background, clip, colors, faces, weights, config, c):
    """loss.backward() of sum(pixels * w); returns (outputs, grads)."""
    bg = background.clone().requires_grad_()
    verts = clip.clone().requires_grad_()
    cols = colors.clone().requires_grad_()
    out = rasterise(bg, verts, cols, faces, config=config, clip=c)
    (out[0] * weights).sum().backward()
    return out, (verts.grad, cols.grad, bg.grad)


def _launch_counts_of(kernel):
    """Launches of ``kernel`` so far, from the registry's counters."""
    from dirt_tpu_torch.utils import trace

    return trace.counters().get(f"launch.{kernel}", 0)


def _launch_counts():
    """{kernel: launches so far} from the registry's launch counters."""
    from dirt_tpu_torch.utils import trace

    counts = trace.counters()
    return {kernel: counts.get(f"launch.{kernel}", 0) for kernel in COUNTED}


def _want_launches(want, vjps=None):
    """``want`` ({kernel: launches} of KERNELS) with max_scan's (one packed
    binning, five scans, ahead of each raster_fwd_packed launch) and
    setup_vjp's: ``vjps``, or on a single-device path (None) one a
    backward, as many as the prologue's."""
    return {**want, SCAN: SCANS_PER_BINNING * want["raster_fwd_packed"],
            SETUP_VJP: want["packed_prologue"] if vjps is None else vjps}


def _reset_launch_counts():
    from dirt_tpu_torch.utils import trace

    trace.reset()


def _need_launches(path, counts, kernels, backwards=1, vjps=None):
    """Every kernel of ``kernels`` launched; the prologue, where it is one
    of them, once per backward (it pads the fields itself: no copy before
    it); max_scan five times for each raster_fwd_packed launch; setup_vjp
    ``vjps`` times, or on a single-device path (None) once per backward,
    as often as the prologue (none on a forward alone)."""
    missed = [k for k in kernels if counts[k] < 1]
    if missed:
        raise RuntimeError(f"{path} missed a kernel: {missed} of {counts}")
    if counts[SCAN] != SCANS_PER_BINNING * counts["raster_fwd_packed"]:
        raise RuntimeError(f"{path}: want {SCANS_PER_BINNING} {SCAN} "
                           f"launches (one packed binning) for each "
                           f"raster_fwd_packed launch, got {counts}")
    if ("packed_prologue" in kernels
            and counts["packed_prologue"] != backwards):
        raise RuntimeError(f"{path}: want {backwards} prologue launch(es), "
                           f"one per backward, got {counts}")
    want_vjps = counts["packed_prologue"] if vjps is None else vjps
    if counts[SETUP_VJP] != want_vjps:
        raise RuntimeError(f"{path}: want {want_vjps} {SETUP_VJP} "
                           f"launch(es), one per backward, got {counts}")


def _plain_patches():
    """Patches that put each kernel wrapper's plain version in its place
    (``start()`` / ``stop()`` them): the same path with no kernel."""
    from dirt_tpu_torch.ops import (
        fused_bwd,
        packed_bwd,
        raster_fwd,
        scan,
        scatter,
        triangle_setup,
    )

    def plain_scatter(cot_cf, fid, bins, counts, num_rows, *, tile_h, tile_w,
                      bbox=None, cull=None):
        return scatter.scatter_to_faces_plain(cot_cf, fid, num_rows)

    def plain_scatter_csr(cot_cf, fid, entry_face, start_block, counts,
                          num_faces, *, tile_h, tile_w, bbox=None, cull=None):
        return scatter.scatter_to_faces_csr_plain(cot_cf, fid, num_faces)

    def plain_dense(table, bins, counts, background_chw, *, tile_h, tile_w):
        return (*raster_fwd.raster_forward_plain(
            table, bins, counts, background_chw, tile_h=tile_h,
            tile_w=tile_w), raster_fwd.csr_cull_boxes_plain(
                table, *background_chw.shape[1:]))

    def plain_csr(table, entry_face, start_block, counts, background_chw, *,
                  tile_h, tile_w):
        return (*raster_fwd.raster_forward_csr_plain(
            table, entry_face, start_block, counts, background_chw,
            tile_h=tile_h, tile_w=tile_w), raster_fwd.csr_cull_boxes_plain(
                table, *background_chw.shape[1:]))

    def plain_forward(table2, bins, background_chw, *, tile_h, tile_w,
                      rows=None):
        return raster_fwd.raster_forward_packed_plain(
            rows, bins, background_chw, tile_h=tile_h, tile_w=tile_w)

    def plain_rows(prep, c_lo=0, c_hi=None):
        return packed_bwd.packed_entry_rows_plain(
            prep, packed_bwd._entry_table_rows(prep), c_lo,
            prep.budget_chunks if c_hi is None else c_hi)

    def plain_fused(geo, bins, counts, fid, bits, sval, pix_cf, grad_cf,
                    num_rows, *, tile_h, tile_w, bbox=None, cull=None):
        return fused_bwd.fused_backward_rows_plain(
            geo, fid, bits, sval, pix_cf, grad_cf, num_rows)

    def plain_fused_csr(geo, entry_face, start_block, counts, fid, bits,
                        sval, pix_cf, grad_cf, num_faces, *, tile_h, tile_w,
                        bbox=None, cull=None):
        return fused_bwd.fused_backward_rows_csr_plain(
            geo, fid, bits, sval, pix_cf, grad_cf, num_faces)

    return (
        mock.patch.object(scatter, "scatter_to_faces", plain_scatter),
        mock.patch.object(scatter, "scatter_to_faces_csr", plain_scatter_csr),
        mock.patch.object(raster_fwd, "raster_forward_csr", plain_csr),
        mock.patch.object(fused_bwd, "fused_backward_rows_csr",
                          plain_fused_csr),
        mock.patch.object(raster_fwd, "raster_forward_packed", plain_forward),
        mock.patch.object(packed_bwd, "padded_prologue",
                          packed_bwd.padded_prologue_plain),
        mock.patch.object(packed_bwd, "packed_entry_rows", plain_rows),
        mock.patch.object(raster_fwd, "raster_forward", plain_dense),
        mock.patch.object(fused_bwd, "fused_backward_rows", plain_fused),
        mock.patch.object(
            raster_fwd, "flat_subtile_swap",
            lambda arrays: [raster_fwd.flat_subtile_swap_plain(a)
                            for a in arrays]),
        mock.patch.object(scan, "max_scan", scan.max_scan_plain),
        mock.patch.object(triangle_setup, "setup_planes_vjp",
                          triangle_setup.setup_planes_vjp_plain),
    )


def _packed_live(bins, tile_h):
    """Iterations the packed kernels run: per (tile, strip), the strip's run
    clamped to its tile's n_iters, summed."""
    strips = tile_h // 8
    lo = bins.iter_off.long().reshape(-1, strips)
    hi = torch.minimum(lo + bins.strip_iters.long().reshape(-1, strips),
                       bins.n_iters.long()[:, None])
    return int(torch.clamp(hi - lo, min=0).sum())


def _check_packed_kernels(tag, face_verts, face_attrs, background, weights,
                          config, card, runs=RUNS, plain_runs=RUNS):
    """raster_fwd_packed, packed_prologue and packed_bwd against their plain
    versions on one scene's real bins, rows and outputs; ``weights`` is the
    upstream gradient. Returns {kernel: max_abs_err, ms, plain_ms, bound_ms,
    bound_by}; raises on a mismatch."""
    from dirt_tpu_torch.ops import packed_bwd, raster, raster_fwd
    from dirt_tpu_torch.ops.triangle_setup import setup_planes

    table2, bins, bg_chw, cfg = raster.prepare_packed(
        face_verts, face_attrs, background, config
    )
    if bool(bins.overflow):
        raise RuntimeError(f"[{tag}] binning overflowed under caps {config}")
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    channels, hp, wp = bg_chw.shape
    plane = hp * wp
    record = {}

    def kernel():
        return raster_fwd.raster_forward_packed(
            table2, bins, bg_chw, rows=bins.rows, **geom)

    def plain():
        return raster_fwd.raster_forward_packed_plain(
            bins.rows, bins, bg_chw, **geom)

    pix_k, fid_k, z_k = kernel()
    pix_p, fid_p, z_p = plain()
    _sync()

    def differ(a, b):
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())

    fid_bad, z_bad, pix_bad = (differ(fid_k, fid_p), differ(z_k, z_p),
                               differ(pix_k, pix_p))
    err = float((pix_k - pix_p).abs().max())
    live = _packed_live(bins, cfg.tile_h)
    covered = int((fid_k >= 0).sum())
    width = bins.rows.shape[1]
    row_bytes = live * 8 * width * 4        # the rows the live iterations read
    meta_bytes = 4 * (2 * bins.n_iters.numel() + 2 * bins.iter_off.numel())
    record["raster_fwd_packed"] = dict(
        max_abs_err=err, ms=_median_ms(kernel, runs),
        plain_ms=_median_ms(plain, plain_runs),
        **packed_forward_bound(bins, cfg.tile_h, channels, fid_k))
    print(f"[{tag}] raster_fwd_packed rows "
          f"{tuple(bins.rows.shape)} bg {tuple(bg_chw.shape)}: values whose "
          f"bits differ from the plain version's: fid {fid_bad}, zbuf "
          f"{z_bad}, pixels {pix_bad}, max |pix diff| {err:.3g}; kernel "
          f"{record['raster_fwd_packed']['ms']:.4f} ms, plain "
          f"{record['raster_fwd_packed']['plain_ms']:.4f} ms, bound "
          f"{record['raster_fwd_packed']['bound_ms']:.4f} ms by "
          f"{record['raster_fwd_packed']['bound_by']} (medians of "
          f"{runs} and {plain_runs}, {card})")
    if fid_bad or z_bad or pix_bad:
        raise RuntimeError(f"[{tag}] raster_fwd_packed disagrees with its "
                           "plain version")

    # What the packed backward hands the prologue: the forward's outputs as
    # the op keeps them (fid and depth cropped to the image, the pixels a
    # permuted view of the [C, Hp, Wp] output) and the upstream gradient.
    height, width = background.shape[:2]
    _, record["packed_prologue"] = _prologue_check(
        tag, (fid_k[:height, :width], z_k[:height, :width],
              pix_k.permute(1, 2, 0)[:height, :width], weights, cfg.tile_h,
              cfg.tile_w), card, runs, plain_runs)

    geo, att, _ = setup_planes(face_verts, face_attrs)
    prep = packed_bwd.prepare_backward_packed(
        geo, att, fid_k, z_k, pix_k.permute(1, 2, 0), weights, bins,
        cfg.tile_h, cfg.tile_w)
    rows_k = packed_bwd.packed_entry_rows(prep)
    rows_p = packed_bwd.packed_entry_rows_plain(
        prep, bins.rows, 0, prep.budget_chunks)
    _sync()
    rows_bad = int((~torch.isclose(rows_k, rows_p, **TOL_BWD)).sum())
    err = float((rows_k - rows_p).abs().max())
    # Bit for bit: the same sums in the same order; on the card the plain
    # version's index_add_ (atomicAdd) flushes subnormal sums to zero, so
    # differences below the smallest normal float are counted apart.
    bits_differ = rows_k.view(torch.int32) != rows_p.view(torch.int32)
    below = bits_differ & ((rows_k - rows_p).abs()
                           < torch.finfo(torch.float32).tiny)
    same = torch.equal(rows_k, packed_bwd.packed_entry_rows(prep))
    record["packed_bwd"] = dict(
        max_abs_err=err,
        ms=_median_ms(lambda: packed_bwd.packed_entry_rows(prep), runs),
        plain_ms=_median_ms(lambda: packed_bwd.packed_entry_rows_plain(
            prep, bins.rows, 0, prep.budget_chunks), plain_runs),
        **_bound(row_bytes + meta_bytes + 4 * plane * (6 + 2 * channels)
                 + 4 * rows_k.numel(), covered * _core_flops(channels)))
    print(f"[{tag}] packed_bwd entry rows "
          f"{tuple(rows_k.shape)}: values outside allclose(rtol=1e-5, "
          f"atol=1e-6) {rows_bad}, max |diff| {err:.3g}, values whose bits "
          f"differ from the plain version's {int((bits_differ & ~below).sum())}"
          f" (besides {int(below.sum())} below the smallest normal float), "
          f"max |row| {float(rows_p.abs().max()):.4g}, nonzero rows "
          f"{int((rows_p != 0).any(1).sum())}, second run equal {same}; "
          f"kernel {record['packed_bwd']['ms']:.4f} ms, plain "
          f"{record['packed_bwd']['plain_ms']:.4f} ms, bound "
          f"{record['packed_bwd']['bound_ms']:.4f} ms by "
          f"{record['packed_bwd']['bound_by']} (medians of {runs} "
          f"and {plain_runs}, {card})")
    if rows_bad or not same:
        raise RuntimeError(f"[{tag}] packed_bwd disagrees with its plain "
                           "version or with itself")
    _sync()
    return record


def listed_pairs(bins):
    """(tile, face) int64 of every live list entry of DenseBins or
    StreamBins, in list order."""
    from dirt_tpu_torch.ops.binning import CHUNK

    counts = bins.counts.long()
    tiles = torch.arange(counts.numel(), device=counts.device)
    tile = torch.repeat_interleave(tiles, counts)
    slot = (torch.arange(tile.numel(), device=tile.device)
            - (torch.cumsum(counts, 0) - counts)[tile])
    if hasattr(bins, "entry_face"):
        face = bins.entry_face.long()[bins.start_block.long()[tile] * CHUNK
                                      + slot]
    else:
        face = bins.bins.long()[tile, slot]
    return tile, face


def tests_per_pixel(bins, boxes, tile_h, tile_w, hp, wp, warp=(4, 8)):
    """(faces tested per pixel by the walk without the cull, by the culled
    walk of raster_tile.cuh) on DenseBins or StreamBins over a padded
    hp x wp image. The culled walk tests a listed face on the 32 pixels of
    each warp whose span meets the face's cull box (``boxes``, from
    ``raster_fwd.csr_cull_boxes``); a warp's span is ``warp`` (rows,
    columns) of the tile, aligned (4 x 8 for tiles a multiple of 8 wide;
    1 x 32 is the row-order walk on tiles a multiple of 32 wide)."""
    tile, face = listed_pairs(bins)
    box = boxes.long()[face]
    x0 = (tile % (wp // tile_w)) * tile_w
    y0 = (tile // (wp // tile_w)) * tile_h

    def spans(lo, hi, step):
        return torch.where(hi >= lo, hi // step - lo // step + 1, 0)

    rows = spans(torch.maximum(y0, box[:, 2]) - y0,
                 torch.minimum(y0 + tile_h - 1, box[:, 3]) - y0, warp[0])
    cols = spans(torch.maximum(x0, box[:, 0]) - x0,
                 torch.minimum(x0 + tile_w - 1, box[:, 1]) - x0, warp[1])
    plane = hp * wp
    return (float(tile.numel()) * tile_h * tile_w / plane,
            float((32 * rows * cols).sum()) / plane)


def _kernel_label(name):
    """A device kernel's bare name, from the profiler's signature."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("<")[0].split("::")[-1]


def _digest(*tensors):
    """SHA-256 prefix of the tensors' bytes, in order."""
    sha = hashlib.sha256()
    for tensor in tensors:
        sha.update(tensor.detach().contiguous().cpu().numpy().tobytes())
    return sha.hexdigest()[:16]


def _check_tile_kernels(tag, engine, face_verts, face_attrs, size, config,
                        weights, card, runs=RUNS, plain_runs=3):
    """The whole-tile engines' kernels against their plain versions on one
    scene at ``size`` x ``size`` (a multiple of the tile, so nothing is
    padded): raster_fwd_dense and fused_bwd for ``engine`` "dense",
    raster_fwd_csr and fused_bwd_csr for "csr". ``weights`` [size, size, C]
    is the upstream gradient. Returns {kernel: max_abs_err, ms, plain_ms,
    bound_ms, bound_by}; raises on a mismatch."""
    from dirt_tpu_torch.ops import fused_bwd, raster, raster_fwd
    from dirt_tpu_torch.ops.triangle_setup import setup_planes

    channels = face_attrs.shape[-1]
    background = torch.zeros((size, size, channels), device=face_verts.device)
    num_faces = face_verts.shape[0]
    if engine == "csr":
        fwd_name, bwd_name = "raster_fwd_csr", "fused_bwd_csr"
        table, bins, bg_chw, cfg = raster.prepare_csr(
            face_verts, face_attrs, background, config)
        lists = (bins.entry_face, bins.start_block, bins.counts)
        forward = raster_fwd.raster_forward_csr
        forward_plain = raster_fwd.raster_forward_csr_plain
        rows_fn = fused_bwd.fused_backward_rows_csr
        rows_plain_fn = fused_bwd.fused_backward_rows_csr_plain
        n_rows = num_faces
    else:
        fwd_name, bwd_name = "raster_fwd_dense", "fused_bwd"
        table, bins, bg_chw, cfg = raster.prepare_dense(
            face_verts, face_attrs, background, config)
        lists = (bins.bins, bins.counts)
        forward = raster_fwd.raster_forward
        forward_plain = raster_fwd.raster_forward_plain
        rows_fn = fused_bwd.fused_backward_rows
        rows_plain_fn = fused_bwd.fused_backward_rows_plain
        n_rows = num_faces + 1
    if bool(bins.overflow.any()):
        raise RuntimeError(f"[{tag}] {engine} binning overflowed under {cfg}")
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    _, hp, wp = bg_chw.shape
    plane = hp * wp
    record = {}

    def kernel():
        return forward(table, *lists, bg_chw, **geom)

    def plain():
        return forward_plain(table, *lists, bg_chw, **geom)

    pix_k, fid_k, z_k, cull = kernel()
    pix_p, fid_p, z_p = plain()
    _sync()
    fid_bad = int((fid_k != fid_p).sum())
    z_bad = int((z_k != z_p).sum())
    pix_bad = int((~torch.isclose(pix_k, pix_p, **TOL)).sum())
    err = float((pix_k - pix_p).abs().max())
    listed = int(bins.counts.sum())
    covered = int((fid_k >= 0).sum())
    list_bytes = 4 * (listed + (len(lists) - 1) * bins.counts.numel())
    # The tests rasterising needs: one per pixel of each face's box (clipped
    # to the image), not one per pixel of every tile the face is listed in.
    box = bins.bbox.long()
    box_px = int((torch.clamp(box[:, 1] - box[:, 0] + 1, min=0)
                  * torch.clamp(box[:, 3] - box[:, 2] + 1, min=0)).sum())
    # The boxes the kernel culls by and hands the backward, from its own
    # code and from plain PyTorch.
    boxes_bad = not torch.equal(
        cull, raster_fwd.csr_cull_boxes_plain(table, hp, wp))
    before, after = tests_per_pixel(bins, cull, cfg.tile_h, cfg.tile_w, hp,
                                    wp)
    in_digest = _digest(table, *lists, bg_chw)
    record[fwd_name] = dict(
        max_abs_err=err, ms=_median_ms(kernel, runs),
        plain_ms=_median_ms(plain, plain_runs, warmup=1),
        **_bound(4 * table.numel() + list_bytes + 16 * table.shape[0]
                 + 4 * plane * (2 * channels + 2),
                 box_px * TEST_FLOPS + covered * _attr_flops(channels)))
    print(f"[{tag}] {fwd_name} table {tuple(table.shape)} lists "
          f"{tuple(lists[0].shape)} (listed {listed}, largest tile "
          f"{int(bins.counts.max())}, box pixels {box_px}) tiles "
          f"{cfg.tile_h}x{cfg.tile_w} bg {tuple(bg_chw.shape)}: fid "
          f"mismatches {fid_bad}, zbuf mismatches {z_bad}, pixels outside "
          f"allclose(rtol=1e-6, atol=1e-6) {pix_bad}, max |pix diff| "
          f"{err:.3g}, covered {covered} px; cull boxes equal to their plain "
          f"version {not boxes_bad}; faces tested per pixel: without the "
          f"cull {before:.2f}, culled {after:.2f}; sha256 of the inputs "
          f"{in_digest}; kernel {record[fwd_name]['ms']:.4f} ms, plain "
          f"{record[fwd_name]['plain_ms']:.4f} ms, bound "
          f"{record[fwd_name]['bound_ms']:.4f} ms by "
          f"{record[fwd_name]['bound_by']} (medians of "
          f"{runs} and {plain_runs}, {card})")
    if fid_bad or z_bad or pix_bad or boxes_bad or not covered:
        raise RuntimeError(f"[{tag}] {fwd_name} disagrees with its plain "
                           "version")

    # The prologue on what the backward hands it (the image is a whole
    # number of tiles here, so nothing is cropped): its padded fields, bits
    # and sval are what the fused kernel reads.
    (fid_p, bits, sval, pix_cf, grad_cf), _ = _prologue_check(
        tag, (fid_k, z_k, pix_k.permute(1, 2, 0), weights, cfg.tile_h,
              cfg.tile_w), card)
    geo, _, _ = setup_planes(face_verts, face_attrs)
    geo = geo.contiguous()
    fields = (fid_p, bits, sval, pix_cf, grad_cf, n_rows)
    boxes = dict(bbox=bins.bbox, cull=cull)

    def fused():
        return rows_fn(geo, *lists, *fields, **boxes, **geom)

    def fused_plain():
        return rows_plain_fn(geo, *fields)

    rows_k = fused()
    rows_p = fused_plain()
    _sync()
    scale = rows_p.abs().amax(dim=0, keepdim=True)
    rows_bad = int(((rows_k - rows_p).abs() > TOL_ROWS * scale + 1e-6).sum())
    err = float((rows_k - rows_p).abs().max())
    same = torch.equal(rows_k, fused())
    digest = _digest(rows_k)
    # What the kernel reads: the geometry, the lists and both boxes, the
    # forward's outputs, the prologue's planes and the upstream gradient.
    in_digest = _digest(geo, *lists, bins.bbox, cull, *fields[:5])
    grad_digest = _digest(grad_cf)
    # The bound counts no box: the function needs none (the plain version
    # and dirt_tpu's whole-tile kernels read none).
    record[bwd_name] = dict(
        max_abs_err=err, ms=_median_ms(fused, runs),
        plain_ms=_median_ms(fused_plain, plain_runs, warmup=1),
        **_bound(4 * 17 * num_faces + list_bytes
                 + 4 * plane * (6 + 2 * channels) + 4 * rows_k.numel(),
                 covered * _core_flops(channels)))
    # The card's time apart from the host's, pass by pass (a profiler
    # window).
    passes = "; ".join(
        f"{_kernel_label(name)} {ms:.4f}"
        for name, ms in sorted(_device_ms(fused, runs).items())
        if "fused_bwd" in name)
    print(f"[{tag}] {bwd_name} rows {tuple(rows_k.shape)}: values outside "
          f"{TOL_ROWS:g} * max |column| + 1e-6: {rows_bad}, max |diff| "
          f"{err:.3g}, max |row| {float(rows_p.abs().max()):.4g}, nonzero "
          f"rows {int((rows_p != 0).any(1).sum())}, second run equal {same}, "
          f"sha256 of the rows {digest}, of the inputs {in_digest} (of the "
          f"upstream gradient alone {grad_digest}); "
          f"kernel {record[bwd_name]['ms']:.4f} ms, plain "
          f"{record[bwd_name]['plain_ms']:.4f} ms, bound "
          f"{record[bwd_name]['bound_ms']:.4f} ms by "
          f"{record[bwd_name]['bound_by']} (medians of {runs} and "
          f"{plain_runs}); device time alone per pass: {passes} ms "
          f"(profiler window of {runs} calls) ({card})")
    if rows_bad or not same or not bool((rows_k != 0).any()):
        raise RuntimeError(f"[{tag}] {bwd_name} disagrees with its plain "
                           "version or with itself")
    _sync()
    return record


def _rand(seed, *shape, device):
    return torch.as_tensor(
        np.random.RandomState(seed).rand(*shape).astype(np.float32),
        device=device)


def _scatter_call(fn, name):
    """Run ``fn()`` and return what its one call of ``ops.scatter.<name>``
    was handed: (args, kwargs). These are the cotangent planes, owners, bins
    and boxes the row-sharded backward gives the scatter kernel."""
    from dirt_tpu_torch.ops import scatter

    seen = []
    inner = getattr(scatter, name)

    def record(*args, **kwargs):
        seen.append((args, kwargs))
        return inner(*args, **kwargs)

    with mock.patch.object(scatter, name, record):
        fn()
    (call,) = seen
    return call


def _check_scatter_kernel(tag, name, sharded_step, card, runs=10):
    """scatter_faces or scatter_faces_csr (``name``) against its plain
    version and against one float32 ``index_add_``, on the inputs one run of
    ``sharded_step()`` hands it. Returns {name: max_abs_err, ms, plain_ms,
    library_ms, bound_ms, bound_by}; raises on a mismatch."""
    from dirt_tpu_torch.ops import scatter

    wrapper = {"scatter_faces": "scatter_to_faces",
               "scatter_faces_csr": "scatter_to_faces_csr"}[name]
    args, kwargs = _scatter_call(sharded_step, wrapper)
    cot, fid_p, *lists, n_out = args
    kernel_fn = getattr(scatter, wrapper)
    plain_fn = getattr(scatter, wrapper + "_plain")
    k_cols = cot.shape[0]

    def kernel():
        return kernel_fn(*args, **kwargs)

    def plain():
        return plain_fn(cot, fid_p, n_out)

    rows_k = kernel()
    rows_p = plain()
    # PyTorch's own scatter, in float32, of the owned pixels' rows: the
    # owners and the contiguous [owned, K] rows are gathered here, outside
    # the timing, as the plain version gathers them inside its own.
    own_px = (fid_p.reshape(-1) >= 0).nonzero().squeeze(1)
    owner = fid_p.reshape(-1)[own_px].long()
    pixel_rows = cot.reshape(k_cols, -1).T[own_px].contiguous()

    def library():
        return torch.zeros(rows_p.shape, device=cot.device
                           ).index_add_(0, owner, pixel_rows)

    rows_l = library()
    # What each value adds up, as magnitudes: a float32 sum in any order
    # stays within a few ulps of this, and one dropped pixel does not.
    mass = plain_fn(cot.abs(), fid_p, n_out)
    _sync()
    scale = rows_p.abs().amax(dim=0, keepdim=True)
    diff = (rows_k - rows_p).abs()
    rows_bad = int((diff > TOL_ROWS * scale + 1e-6).sum())
    value_bad = int((diff > TOL_ROWS * mass + 1e-9).sum())
    worst = float((diff / mass.clamp(min=1e-30)).max())
    err = float(diff.max())
    lib_err = float((rows_l - rows_p).abs().max())
    same = torch.equal(rows_k, kernel())
    counts = lists[-1]
    listed = int(counts.sum())
    owned = int(own_px.numel())
    # The function needs the cotangents of owned pixels only (the kernel
    # reads no other), every owner and the lists, and writes the rows. It
    # needs no box: the plain version and dirt_tpu's kernels read none.
    nbytes = (4 * owned * k_cols + 4 * fid_p.numel() + 4 * rows_k.numel()
              + 4 * (listed + (len(lists) - 1) * counts.numel()))
    record = dict(max_abs_err=err, ms=_median_ms(kernel, runs),
                  plain_ms=_median_ms(plain, runs, warmup=1),
                  library_ms=_median_ms(library, runs, warmup=1),
                  **_bound(nbytes, owned * k_cols))
    # The card's time apart from the host's: the device kernels of one call
    # (both passes; the library call's fill and scatter), and what the host
    # takes to queue a call of the wrapper.
    by_name = _device_ms(lambda: (kernel(), library()), runs)
    device_k = sum(ms for n, ms in by_name.items() if "scatter_faces" in n)
    device_l = sum(ms for n, ms in by_name.items()
                   if "scatter_faces" not in n)
    host_k = _queued_ms(kernel, runs)[1]
    print(f"[{tag}] {name} cot {tuple(cot.shape)} lists "
          f"{tuple(lists[0].shape)} (listed {listed}) owned {owned} px -> rows "
          f"{tuple(rows_k.shape)}: values outside {TOL_ROWS:g} * max |column| "
          f"+ 1e-6: {rows_bad}, outside {TOL_ROWS:g} * sum of the value's "
          f"|terms| + 1e-9: {value_bad} (largest |diff| / sum |terms| "
          f"{worst:.3g}), max |diff| {err:.3g}, max |row| "
          f"{float(rows_p.abs().max()):.4g}, nonzero rows "
          f"{int((rows_p != 0).any(1).sum())}, second run equal {same}; "
          f"float32 index_add_ of the {owned} owned rows max |diff| from "
          f"plain {lib_err:.3g}; kernel "
          f"{record['ms']:.4f} ms, plain {record['plain_ms']:.4f} ms, "
          f"index_add_ {record['library_ms']:.4f} ms (single calls, medians "
          f"of {runs}); device time alone: kernel {device_k:.4f} ms, "
          f"index_add_ {device_l:.4f} ms (profiler window of {runs} calls), "
          f"host {host_k:.4f} ms to queue the kernel's call; bound "
          f"{record['bound_ms']:.4f} ms by {record['bound_by']} ({card})")
    if rows_bad or value_bad or not same or not bool((rows_k != 0).any()):
        raise RuntimeError(f"[{tag}] {name} disagrees with its plain version "
                           "or with itself")
    return {name: record}


def _check_swap_kernel(tag, sharded_step, card, runs=10):
    """subtile_swap against its plain version on the arrays one run of
    ``sharded_step()`` (a packed slab's halo backward) hands it, and the
    packed backward on those flat-subtile fields against the same kernel on
    image-layout fields. Returns {"subtile_swap": max_abs_err, ms, plain_ms,
    library_ms, bound_ms, bound_by}; raises on a mismatch."""
    from dirt_tpu_torch.ops import packed_bwd, raster_fwd

    seen = []
    swap = raster_fwd.flat_subtile_swap
    rows_fn = packed_bwd.packed_entry_rows

    def record_swap(arrays):
        seen.append(list(arrays))
        return swap(arrays)

    def record_rows(prep, *args):
        seen.append(prep)
        return rows_fn(prep, *args)

    with mock.patch.object(raster_fwd, "flat_subtile_swap", record_swap), \
            mock.patch.object(packed_bwd, "packed_entry_rows", record_rows):
        sharded_step()
    arrays, prep = seen

    def bits(x):
        return x.view(torch.int32)

    def kernel():
        return swap(arrays)

    def plain():
        return [raster_fwd.flat_subtile_swap_plain(a).contiguous()
                for a in arrays]

    # One PyTorch call of the same function: a strided copy of the planes,
    # stacked beforehand, with the row and group axes exchanged.
    hp, wp = arrays[0].shape[-2:]
    stacked = torch.cat([bits(a).reshape(-1, hp, wp) for a in arrays])
    view = stacked.reshape(-1, hp // 8, 8, wp // 128, 8, 16).transpose(-4, -2)

    def library():
        return view.contiguous()

    got, want = kernel(), plain()
    back = swap(got)
    _sync()
    planes = stacked.shape[0]
    bad = sum(int((bits(g) != bits(w)).sum()) for g, w in zip(got, want))
    moved = sum(int((bits(g) != bits(a)).sum()) for g, a in zip(got, arrays))
    undone = all(torch.equal(bits(b), bits(a)) for b, a in zip(back, arrays))
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    record = dict(max_abs_err=err, ms=_median_ms(kernel, runs),
                  plain_ms=_median_ms(plain, runs, warmup=1),
                  library_ms=_median_ms(library, runs, warmup=1),
                  **_bound(2 * 4 * stacked.numel(), 0))
    # The card's time apart from the host's (a profiler window).
    by_name = _device_ms(lambda: (kernel(), library()), runs)
    device_k = sum(ms for n, ms in by_name.items() if "subtile_swap" in n)
    device_l = sum(ms for n, ms in by_name.items() if "subtile_swap" not in n)

    # The packed backward on these fields (as the halo path runs it)
    # against the same kernel on the fields in image layout.
    if not (prep.flat and torch.equal(prep.fid_p, got[0])):
        raise RuntimeError(f"[{tag}] the halo path did not hand the backward "
                           "kernel the swapped fields")
    image = packed_bwd._PackedBwdPrep(
        arrays[0], arrays[1], arrays[4], arrays[2], arrays[3], prep.bins,
        prep.geo, prep.att, prep.channels, prep.k_cols, prep.tile_h,
        prep.tile_w)
    rows_flat = rows_fn(prep)
    rows_image = rows_fn(image)
    _sync()
    rows_same = torch.equal(rows_flat, rows_image)
    flat_ms = _median_ms(lambda: rows_fn(prep), runs)
    image_ms = _median_ms(lambda: rows_fn(image), runs)
    print(f"[{tag}] subtile_swap {len(arrays)} arrays, {planes} planes of "
          f"{hp}x{wp}: words differing from the plain version {bad} (of "
          f"{stacked.numel()}, {moved} moved), swapped twice equal {undone}; "
          f"kernel {record['ms']:.4f} ms, plain {record['plain_ms']:.4f} ms, "
          f"one strided copy {record['library_ms']:.4f} ms (single calls); "
          f"device time alone: kernel {device_k:.4f} ms, strided copy "
          f"{device_l:.4f} ms (profiler window of {runs} calls); bound "
          f"{record['bound_ms']:.4f} ms by {record['bound_by']}; packed_bwd "
          f"on the flat fields equal to itself on image fields {rows_same} "
          f"(nonzero rows {int((rows_flat != 0).any(1).sum())}), flat "
          f"{flat_ms:.4f} ms, image {image_ms:.4f} ms (medians of {runs}, "
          f"{card})")
    if bad or not moved or not undone or not rows_same \
            or not bool((rows_flat != 0).any()):
        raise RuntimeError(f"[{tag}] subtile_swap disagrees with its plain "
                           "version, or packed_bwd with itself")
    return {"subtile_swap": record}


def _sharded_check(tag, engine, scene, config, weights, card, runs=5):
    """``rasterise_sharded`` with 1 and 4 local slabs against the
    single-device render, and with 4 against its plain path; launch counts
    and times. ``scene`` is (background, clip vertices, colors, faces).
    Returns the launch counts of the 4-slab step."""
    import dirt_tpu_torch
    from dirt_tpu_torch.parallel.group import LocalGroup
    from dirt_tpu_torch.parallel.sharding import rasterise_sharded

    background, clip, colors, faces = scene

    def single(bg, verts, cols, faces, config, clip):
        return dirt_tpu_torch.rasterise_with_aux(bg, verts, cols, faces,
                                                 config=config, clip=False)

    def sharded(n):
        def render(bg, verts, cols, faces, config, clip):
            return rasterise_sharded(bg, verts, cols, faces, LocalGroup(n),
                                     config=config, with_aux=True)
        return render

    def step(render):
        return _grads(render, background, clip, colors, faces, weights,
                      config, False)

    (pix_1, fid_1, _, ovf_1), grads_1 = step(single)
    if bool(ovf_1) or not bool((fid_1 >= 0).any()):
        raise RuntimeError(f"[{tag}] bad single-device render under {config}")
    times = {"single": (_median_ms(lambda: single(*scene, config, False),
                                   runs),
                        _median_ms(lambda: step(single), runs))}
    errs = {}
    for n in (1, 4):
        _reset_launch_counts()
        (pix_n, fid_n, _, ovf_n), grads_n = step(sharded(n))
        _sync()
        counts = _launch_counts()
        want = _want_launches({k: (n if k in SHARDED_PATH[engine] else 0)
                               for k in KERNELS}, vjps=n)
        if counts != want:
            raise RuntimeError(f"[{tag}] {n} slabs: want launches {want} "
                               f"({n} of {SHARDED_PATH[engine]} and "
                               f"{SETUP_VJP}, the packed slabs' binnings) "
                               f"and no other, got {counts}")
        pix_err = float((pix_n - pix_1).detach().abs().max())
        if (bool(ovf_n) or not torch.equal(fid_n, fid_1)
                or pix_err > TOL_SLAB_PIXELS):
            raise RuntimeError(f"[{tag}] {n} slabs: overflow {bool(ovf_n)}, "
                               f"{int((fid_n != fid_1).sum())} fids differ, "
                               f"max |pixel diff| {pix_err:.3g}")
        for g in grads_n:
            if g is None or not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"[{tag}] {n} slabs: gradient missing or "
                                   "not finite")
        if not all(bool(g.abs().sum() > 0) for g in grads_n[:2]):
            raise RuntimeError(f"[{tag}] {n} slabs: zero gradient")
        errs[n] = [_rel_err(g_n, g_1) for g_n, g_1 in zip(grads_n, grads_1)]
        if not all(e <= TOL_ENGINES for e in errs[n]):
            raise RuntimeError(f"[{tag}] {n} slabs: gradients differ from the "
                               f"single-device ones: {errs[n]}")
        with torch.no_grad():
            fwd_ms = _median_ms(lambda: sharded(n)(*scene, config, False),
                                runs)
        times[n] = (fwd_ms, _median_ms(lambda: step(sharded(n)), runs))
    # The 4-slab step again with every kernel replaced by its plain version.
    patches = _plain_patches()
    for patch in patches:
        patch.start()
    before = _launch_counts()
    start = time.perf_counter()
    (pix_p, fid_p, _, _), grads_p = step(sharded(4))
    _sync()
    plain_s = time.perf_counter() - start
    if before != _launch_counts():
        raise RuntimeError(f"[{tag}] plain path launched a kernel")
    for patch in patches:
        patch.stop()
    err_plain = [_rel_err(g_n, g_p) for g_n, g_p in zip(grads_n, grads_p)]
    if (not torch.equal(fid_p, fid_n) or not torch.allclose(pix_p, pix_n,
                                                             **TOL)
            or not all(e <= TOL_GRAD for e in err_plain)):
        raise RuntimeError(f"[{tag}] kernel and plain path disagree: "
                           f"gradients {err_plain}")
    print(f"[{tag}] {faces.shape[0]} faces, caps tile_h={config.tile_h} "
          f"bin_cap={config.bin_cap} expand_cap={config.expand_cap} "
          f"budget={config.budget}: overflow False, fid equal to the "
          f"single-device render with 1 and 4 slabs; max |grad diff| / max "
          f"|grad| (vertices colors background) vs single device: 1 slab "
          f"{' '.join(f'{e:.3g}' for e in errs[1])}, 4 slabs "
          f"{' '.join(f'{e:.3g}' for e in errs[4])} (limit {TOL_ENGINES:g}); "
          f"4 slabs vs plain path {' '.join(f'{e:.3g}' for e in err_plain)} "
          f"(limit {TOL_GRAD:g}; plain fwd+bwd {plain_s:.2f} s, one run); "
          f"launches with 4 slabs {counts}")
    print(f"[{tag}] forward / fwd+bwd: single device "
          f"{times['single'][0]:.4f} / {times['single'][1]:.4f} ms, 1 slab "
          f"{times[1][0]:.4f} / {times[1][1]:.4f} ms, 4 slabs "
          f"{times[4][0]:.4f} / {times[4][1]:.4f} ms (medians of {runs}) "
          f"({card})")
    return counts


def _capture_entry_rows():
    """(patch, calls): a patch of ``packed_bwd.packed_entry_rows`` (to
    ``start()``) that launches the kernel as the path asks and keeps every
    call's (prep, c_lo, c_hi, rows) in ``calls``."""
    from dirt_tpu_torch.ops import packed_bwd

    calls = []
    kernel = packed_bwd.packed_entry_rows

    def capture(prep, c_lo=0, c_hi=None):
        rows = kernel(prep, c_lo, c_hi)
        calls.append((prep, c_lo,
                      prep.budget_chunks if c_hi is None else c_hi, rows))
        return rows

    return mock.patch.object(packed_bwd, "packed_entry_rows", capture), calls


def _check_chunk_slices(tag, calls):
    """Every packed_bwd launch on a chunk slice against the plain version on
    the same slice, bit for bit (values below the smallest normal float
    apart: the plain version's ``index_add_`` flushes those on the card),
    and each slab's slices, in order, tiling its budget and concatenated
    bit-equal to one launch over the whole budget. Returns (slices, chunk
    bounds of the first slab, max |kernel - plain|)."""
    from dirt_tpu_torch.ops import packed_bwd

    by_prep = {}
    for prep, c_lo, c_hi, rows in calls:
        by_prep.setdefault(id(prep), (prep, []))[1].append((c_lo, c_hi, rows))
    differ_bits, worst, first = 0, 0.0, None
    for prep, slices in by_prep.values():
        table_rows = packed_bwd._entry_table_rows(prep)
        for c_lo, c_hi, rows in slices:
            plain = packed_bwd.packed_entry_rows_plain(prep, table_rows, c_lo,
                                                       c_hi)
            differ = rows.view(torch.int32) != plain.view(torch.int32)
            below = differ & ((rows - plain).abs()
                              < torch.finfo(torch.float32).tiny)
            differ_bits += int((differ & ~below).sum())
            worst = max(worst, float((rows - plain).abs().max()))
        bounds = [c for c_lo, c_hi, _ in slices for c in (c_lo, c_hi)]
        first = first or bounds
        tiled = (bounds[0] == 0 and bounds[-1] == prep.budget_chunks
                 and bounds[1:-1:2] == bounds[2::2])
        whole = packed_bwd.packed_entry_rows(prep)
        if not tiled or not torch.equal(
                torch.cat([rows for *_, rows in slices]), whole):
            raise RuntimeError(f"[{tag}] chunk slices {bounds} do not tile "
                               f"the budget's {prep.budget_chunks} chunks or "
                               "differ from one launch over all of them")
    if differ_bits:
        raise RuntimeError(f"[{tag}] {differ_bits} values of the chunk "
                           "slices' rows differ from the plain version's")
    return len(calls), first[::2] + first[-1:], worst


def _check_grads(tag, grads, references):
    """Gradients finite and nonzero (vertices, colors), and within each
    limit of its reference: ``references`` maps a label to (gradients,
    limit). Returns {label: [max |diff| / max |reference| per gradient]}."""
    for g in grads:
        if g is None or not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"[{tag}] gradient missing or not finite")
    if not all(bool(g.abs().sum() > 0) for g in grads[:2]):
        raise RuntimeError(f"[{tag}] zero gradient")
    errs = {}
    for label, (want, limit) in references.items():
        errs[label] = [_rel_err(g, w) for g, w in zip(grads, want)]
        if not all(e <= limit for e in errs[label]):
            raise RuntimeError(f"[{tag}] gradients differ from the {label} "
                               f"ones: {errs[label]} (limit {limit:g})")
    return errs


def _overlap_check(tag, scene, config, weights, card, runs=5):
    """``rasterise_sharded(overlap_chunks=k)`` with 1 and 4 local slabs at
    k = 1, 2, 4: launch counts (raster_fwd_packed and subtile_swap once per
    slab, packed_bwd and setup_vjp once per slab and chunk, no other
    kernel), every
    chunk slice of packed_bwd against its plain version, the image and fid
    equal to the non-overlapped sharded render's, gradients against the
    single-device step and the non-overlapped sharded one (TOL_GRAD);
    fwd+bwd times. Returns (launch counts summed over the runs,
    {label: ms})."""
    import dirt_tpu_torch
    from dirt_tpu_torch.parallel.group import LocalGroup
    from dirt_tpu_torch.parallel.sharding import rasterise_sharded

    background, clip, colors, faces = scene

    def single(bg, verts, cols, faces, config, clip):
        return dirt_tpu_torch.rasterise_with_aux(bg, verts, cols, faces,
                                                 config=config, clip=False)

    def sharded(n, chunks=None):
        def render(bg, verts, cols, faces, config, clip):
            return rasterise_sharded(bg, verts, cols, faces, LocalGroup(n),
                                     config=config, overlap_chunks=chunks,
                                     with_aux=True)
        return render

    def step(render):
        return _grads(render, background, clip, colors, faces, weights,
                      config, False)

    grads_1 = step(single)[1]
    times = {"single device": _median_ms(lambda: step(single), runs)}
    launches = dict.fromkeys(COUNTED, 0)
    for n in (1, 4):
        (pix_s, fid_s, _, _), grads_s = step(sharded(n))
        times[f"sharded n={n}"] = _median_ms(lambda: step(sharded(n)), runs)
        for k in OVERLAP_CHUNKS:
            patch, calls = _capture_entry_rows()
            _reset_launch_counts()
            patch.start()
            (pix_o, fid_o, _, ovf_o), grads_o = step(sharded(n, k))
            _sync()
            counts = _launch_counts()
            patch.stop()
            want = _want_launches({name: 0 for name in KERNELS}
                                  | {"raster_fwd_packed": n,
                                     "subtile_swap": n,
                                     "packed_bwd": n * k}, vjps=n * k)
            if counts != want:
                raise RuntimeError(f"[{tag}] {n} slabs x {k} chunks: want "
                                   f"launches {want} and no other, got "
                                   f"{counts}")
            for name, v in counts.items():
                launches[name] += v
            slices, bounds, worst = _check_chunk_slices(
                f"{tag} {n} slabs x {k} chunks", calls)
            if (bool(ovf_o) or not torch.equal(fid_o, fid_s)
                    or not torch.equal(pix_o, pix_s)):
                raise RuntimeError(f"[{tag}] {n} slabs x {k} chunks: the "
                                   "image differs from the sharded render's")
            errs = _check_grads(f"{tag} {n} slabs x {k} chunks", grads_o, {
                "single-device": (grads_1, TOL_GRAD),
                "non-overlapped sharded": (grads_s, TOL_GRAD)})
            print(f"[{tag}] {n} slab(s) x {k} chunk(s): launches "
                  f"{ {name: v for name, v in counts.items() if v} }; "
                  f"{slices} packed_bwd chunk slices (bounds {bounds} of "
                  f"slab 0) bit-equal to the plain version (max |diff| "
                  f"{worst:.3g}), each slab's slices concatenated equal to "
                  f"one launch; image and fid equal to the non-overlapped "
                  f"render's; max |grad diff| / max |grad| (vertices colors "
                  f"background) vs single device "
                  f"{' '.join(f'{e:.3g}' for e in errs['single-device'])} "
                  f"(limit {TOL_GRAD:g}), vs non-overlapped sharded "
                  f"{' '.join(f'{e:.3g}' for e in errs['non-overlapped sharded'])}"
                  f" (limit {TOL_GRAD:g})")
            times[f"overlap n={n} k={k}"] = _median_ms(
                lambda: step(sharded(n, k)), runs)
    return launches, times


def face_sharded_step(scene, config, weights, members):
    """``_grads`` of ``sum(image * w)`` through ``rasterise_face_sharded``
    with ``members`` local members: ((pixels, fid, zbuf, overflow),
    gradients)."""
    from dirt_tpu_torch.parallel.face_sharding import rasterise_face_sharded
    from dirt_tpu_torch.parallel.group import LocalGroup

    background, clip, colors, faces = scene
    return _grads(
        lambda bg, verts, cols, faces, config, clip: rasterise_face_sharded(
            bg, verts, cols, faces, LocalGroup(members), config=config,
            with_aux=True),
        background, clip, colors, faces, weights, config, False)


def _face_sharded_check(tag, scene, config, weights, kernel):
    """``rasterise_face_sharded`` with four local members against the
    single-device render under the same config: overflow clear, fid equal,
    pixels within TOL_SLAB_PIXELS, gradients within TOL_ENGINES, and the
    members' forward kernel ``kernel`` and setup_vjp launched once per
    member and no other kernel. Returns the launch counts."""
    import dirt_tpu_torch

    background, clip, colors, faces = scene
    (pix_1, fid_1, _, ovf_1), grads_1 = _grads(
        dirt_tpu_torch.rasterise_with_aux, background, clip, colors, faces,
        weights, config, False)
    _reset_launch_counts()
    (pix_4, fid_4, _, ovf_4), grads_4 = face_sharded_step(scene, config,
                                                          weights, 4)
    _sync()
    counts = _launch_counts()
    want = _want_launches({name: (4 if name == kernel else 0)
                           for name in KERNELS}, vjps=4)
    if counts != want:
        raise RuntimeError(f"[{tag}] want 4 launches of {kernel} and of "
                           f"{SETUP_VJP} (one per member), the packed "
                           f"members' binnings and no other: {want}, got "
                           f"{counts}")
    pix_err = float((pix_4 - pix_1).detach().abs().max())
    if (bool(ovf_1) or bool(ovf_4) or not torch.equal(fid_4, fid_1)
            or pix_err > TOL_SLAB_PIXELS):
        raise RuntimeError(f"[{tag}] overflow {bool(ovf_1)} {bool(ovf_4)}, "
                           f"{int((fid_4 != fid_1).sum())} fids differ, max "
                           f"|pixel diff| {pix_err:.3g}")
    errs = _check_grads(tag, grads_4,
                        {"single-device": (grads_1, TOL_ENGINES)})
    print(f"[{tag}] {faces.shape[0]} faces over 4 members "
          f"({faces.shape[0] // 4} each): overflow False, fid equal to the "
          f"single-device render, max |pixel diff| {pix_err:.3g} (limit "
          f"{TOL_SLAB_PIXELS:g}); max |grad diff| / max |grad| (vertices "
          f"colors background) {' '.join(f'{e:.3g}' for e in errs['single-device'])}"
          f" (limit {TOL_ENGINES:g}); launches "
          f"{ {name: v for name, v in counts.items() if v} }")
    return counts


def new_paths_grads(group, scene, config, weights):
    """{path: gradients} of ``sum(image * w)`` through the overlapped
    (2 chunks) and the face-sharded renderer over ``group``."""
    from dirt_tpu_torch.parallel.face_sharding import rasterise_face_sharded
    from dirt_tpu_torch.parallel.sharding import rasterise_sharded

    renders = {
        "overlap": lambda bg, v, c, f: rasterise_sharded(
            bg, v, c, f, group, config=config, overlap_chunks=2,
            with_aux=True),
        "face-sharded": lambda bg, v, c, f: rasterise_face_sharded(
            bg, v, c, f, group, config=config, with_aux=True),
    }
    background, clip, colors, faces = scene
    return {
        path: _grads(lambda bg, v, c, f, config, clip: render(bg, v, c, f),
                     background, clip, colors, faces, weights, config,
                     False)[1]
        for path, render in renders.items()}


def sharded_dense_step(device, slabs=4):
    """(loss_fn, leaves) of the row-sharded renderer on the bench sphere at
    1024 x 1024 under ``RasterConfig(engine="dense")`` with
    ``suggest_raster_config``'s caps, ``slabs`` local slabs on the one card;
    ``loss_fn(background, vertices, colors)`` is ``sum(image * w)`` with
    ``w = RandomState(1).rand(1024, 1024, 3)``."""
    import dirt_tpu_torch
    from dirt_tpu_torch.parallel.group import LocalGroup
    from dirt_tpu_torch.parallel.sharding import rasterise_sharded

    _, clip, colors, faces, background, weights = _bench_scene(device)
    config = dirt_tpu_torch.suggest_raster_config(
        clip, faces, SIZE, SIZE,
        config=dirt_tpu_torch.RasterConfig(engine="dense"), clip=False)

    def loss_fn(bg, verts, cols):
        return (rasterise_sharded(bg, verts, cols, faces, LocalGroup(slabs),
                                  config=config) * weights).sum()

    return loss_fn, (background, clip, colors)


def overlap_loss(device, slabs=4, chunks=4):
    """(loss_fn, leaves) of ``rasterise_sharded(overlap_chunks=chunks)`` on
    the bench sphere at 1024 x 1024 under phase 4's caps (the packed
    engine), ``slabs`` local slabs on the one card; ``loss_fn(background,
    vertices, colors)`` is ``sum(image * w)``, ``w`` as above."""
    import dirt_tpu_torch
    from dirt_tpu_torch.parallel.group import LocalGroup
    from dirt_tpu_torch.parallel.sharding import rasterise_sharded

    _, clip, colors, faces, background, weights = _bench_scene(device)
    config = dirt_tpu_torch.suggest_raster_config(clip, faces, SIZE, SIZE,
                                                  clip=False)

    def loss_fn(bg, verts, cols):
        return (rasterise_sharded(bg, verts, cols, faces, LocalGroup(slabs),
                                  config=config, overlap_chunks=chunks)
                * weights).sum()

    return loss_fn, (background, clip, colors)


def face_sharded_loss(device, members=4):
    """(loss_fn, leaves) of ``rasterise_face_sharded`` on the bench sphere
    at 1024 x 1024 under phase 4's caps, ``members`` local members (four:
    2,556 faces each, the dense engine), as :func:`overlap_loss`."""
    import dirt_tpu_torch
    from dirt_tpu_torch.parallel.face_sharding import rasterise_face_sharded
    from dirt_tpu_torch.parallel.group import LocalGroup

    _, clip, colors, faces, background, weights = _bench_scene(device)
    config = dirt_tpu_torch.suggest_raster_config(clip, faces, SIZE, SIZE,
                                                  clip=False)

    def loss_fn(bg, verts, cols):
        return (rasterise_face_sharded(bg, verts, cols, faces,
                                       LocalGroup(members), config=config)
                * weights).sum()

    return loss_fn, (background, clip, colors)


def config5_render(device):
    """(render, leaves) of config 5 of ``bench_configs_torch.py``: the
    10,224-face sphere at 1024 x 1024 through the deferred pipeline (9-channel
    G-buffer, 128 x 128 checkerboard, Phong) under count-then-allocate caps
    (the packed engine). ``render(verts, pose, **kwargs)`` is
    ``entry.deferred_render``; the leaves are (object-space vertices, pose)."""
    config = bench_configs_torch.config5(device)
    return config.forward, config.leaves


def config4_loss(device):
    """(loss_fn, leaves) of config 4 of ``bench_configs_torch.py``: the
    2,208-face sphere at 512 x 512, diffuse + specular vertex shading, the
    dense engine under count-then-allocate caps; ``loss_fn(light, pose)`` is
    ``sum(image * w)`` with ``w = RandomState(1).rand(512, 512, 3)``."""
    config = bench_configs_torch.config4(device)
    return config.loss, config.leaves


def big_sphere_step(device, n=224):
    """(loss_fn, leaves, scene) of the default API on a mesh above the
    streaming threshold: ``mesh.uv_sphere(n, n)`` (2 n (n - 1) faces; 224
    gives 99,904, the sphere of ``bench.py``'s 100k cell) under the bench
    camera at 1024 x 1024,
    colors ``RandomState(0)``, under ``suggest_raster_config``'s caps with the
    default ``clip=True``, which pins ``streaming`` and so picks the csr
    engine. ``loss_fn(background, vertices, colors)`` is ``sum(image * w)``
    with ``w = RandomState(1).rand(1024, 1024, 3)``; ``scene`` is (faces,
    config)."""
    import dirt_tpu_torch
    from dirt_tpu_torch.core import mesh
    from dirt_tpu_torch.ops import raster

    verts_obj, faces, _ = mesh.uv_sphere(n_lat=n, n_lon=n)
    verts_obj = torch.as_tensor(verts_obj, device=device)
    clip = _clip_verts(verts_obj, torch.tensor([0.4, 0.3, 0.0], device=device),
                       device)
    colors = _rand(0, len(verts_obj), 3, device=device)
    faces = torch.as_tensor(faces.astype(np.int64), device=device)
    background = torch.zeros((SIZE, SIZE, CHANNELS), device=device)
    weights = _rand(1, SIZE, SIZE, CHANNELS, device=device)
    config = dirt_tpu_torch.suggest_raster_config(clip, faces, SIZE, SIZE)
    if (config.streaming is not True
            or raster.resolve_engine(config, faces.shape[0]) != "csr"):
        raise RuntimeError(f"the default API did not choose the csr engine "
                           f"for {faces.shape[0]} faces: {config}")

    def loss_fn(bg, verts, cols):
        return (dirt_tpu_torch.rasterise(bg, verts, cols, faces,
                                         config=config) * weights).sum()

    return loss_fn, (background, clip, colors), (faces, config)


def _raster_inputs(fn):
    """Run ``fn()`` and return what its one rasterisation handed the raster
    op: (face_verts_screen, face_attrs, background, config), detached. These
    are the clipped, gathered faces the engine's kernels see on that path."""
    from dirt_tpu_torch.ops import raster

    seen = []
    inner = raster._forward_impl

    def record(face_verts, face_attrs, background, config):
        seen.append((face_verts.detach(), face_attrs.detach(),
                     background.detach(), config))
        return inner(face_verts, face_attrs, background, config)

    with mock.patch.object(raster, "_forward_impl", record):
        fn()
    (inputs,) = seen
    return inputs


def _step_check(tag, loss_fn, leaves, card, runs=10, plain=True):
    """One forward + backward of ``loss_fn(*leaves)`` on the kernel path,
    the same on the plain path (every kernel patched out), and times.
    Gradients must be finite, nonzero and within TOL_DEFERRED of the plain
    path's. Returns (loss, launches of the kernel-path step)."""
    def step():
        fresh = [t.detach().clone().requires_grad_() for t in leaves]
        loss = loss_fn(*fresh)
        loss.backward()
        return loss.detach(), [t.grad for t in fresh]

    _reset_launch_counts()
    loss_k, grads_k = step()
    _sync()
    launches = _launch_counts()
    for g in grads_k:
        if g is None or not bool(torch.isfinite(g).all()) \
                or not bool(g.abs().sum() > 0):
            raise RuntimeError(f"[{tag}] gradient missing, not finite or "
                               "zero")
    errs = []
    plain_ms = float("nan")
    if plain:
        patches = _plain_patches()
        for patch in patches:
            patch.start()
        before = _launch_counts()
        loss_p, grads_p = step()
        _sync()
        plain_ms = _median_ms(step, runs=3, warmup=0)
        if before != _launch_counts():
            raise RuntimeError(f"[{tag}] plain path launched a kernel")
        for patch in patches:
            patch.stop()
        errs = [_rel_err(g_k, g_p) for g_k, g_p in zip(grads_k, grads_p)]
        if not abs(float(loss_k) - float(loss_p)) <= 1e-5 * abs(float(loss_p)):
            raise RuntimeError(f"[{tag}] kernel and plain path losses "
                               f"disagree: {float(loss_k)} {float(loss_p)}")
        if not all(e <= TOL_DEFERRED for e in errs):
            raise RuntimeError(f"[{tag}] kernel and plain path gradients "
                               f"disagree: {errs}")
    with torch.no_grad():
        fwd_ms = _median_ms(lambda: loss_fn(*leaves), runs)
    step_ms = _median_ms(step, runs)
    versus = (f"kernel vs plain path max |grad diff| / max |grad| "
              f"{' '.join(f'{e:.3g}' for e in errs)} (limit "
              f"{TOL_DEFERRED:g}), plain path fwd+bwd {plain_ms:.4f} ms "
              f"(median of 3); " if plain else "")
    print(f"[{tag}] loss {float(loss_k):.6g}; gradients finite; {versus}"
          f"launches {launches}; forward {fwd_ms:.4f} ms, fwd+bwd "
          f"{step_ms:.4f} ms (medians of {runs}) ({card})")
    return float(loss_k), launches


def _obj_text(verts, faces, uvs):
    """A Wavefront OBJ of a mesh: positions, UVs and ``v/vt`` faces."""
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"vt {u:.6f} {v:.6f}" for u, v in uvs]
    lines += [f"f {a}/{a} {b}/{b} {c}/{c}" for a, b, c in faces + 1]
    return "\n".join(lines) + "\n"


def _bench_and_io_check(scene, config, card):
    """Phase 14: the bench's tracked step through ``utils.benchtime``, a
    RasterConfig through ``utils.configstore`` in a temporary file, and a
    mesh written as OBJ, loaded by the native parser and rendered on the
    card by the packed engine against the plain path."""
    import bench_torch
    import dirt_tpu_torch
    from dirt_tpu_torch.core import mesh
    from dirt_tpu_torch.io import objloader
    from dirt_tpu_torch.utils import configstore

    # One forward with aux, then three warm-up and three timed calls of
    # the forward and of the step: six backwards.
    _reset_launch_counts()
    (t_min, t_med), line = bench_torch.measure(
        "14 bench tracked step", scene, config, False, samples=3)
    _sync()
    _need_launches("bench tracked step", _launch_counts(), KERNELS[:3],
                   backwards=6)
    if not (np.isfinite([t_min, t_med]).all() and 0 < t_min <= t_med):
        raise RuntimeError(f"[14] bench step times {t_min!r}, {t_med!r}")
    print(line.replace("# ", "[", 1).replace(":", "]", 1) + f" ({card})")

    _, clip, _, faces, background, _ = scene
    with tempfile.TemporaryDirectory() as tmp:
        store = Path(tmp) / "configs_torch.json"
        configstore.save_config("bench", config, store)
        if configstore.load_config("bench", store) != config:
            raise RuntimeError("[14] configstore round trip changed the "
                               "config")
        kept = configstore.cached_config("bench", clip, faces, SIZE, SIZE,
                                         path=store)
        stale = config._replace(bin_cap=1, expand_cap=1)
        configstore.save_config("bench", stale, store)
        fresh = configstore.cached_config("bench", clip, faces, SIZE, SIZE,
                                          path=store)
        if (kept != config or fresh == stale
                or configstore.load_config("bench", store) != fresh
                or configstore.overflows(clip, faces, SIZE, SIZE, fresh)):
            raise RuntimeError(f"[14] configstore: kept {kept}, replaced the "
                               f"stale entry by {fresh}")
        print(f"[14 configstore] round trip equal; the stored caps kept "
              f"after one overflow-checked render on the card; a stale entry "
              f"(bin_cap 1, expand_cap 1) replaced by {fresh}")

        verts, tris, uvs = mesh.uv_sphere(n_lat=24, n_lon=32)
        path = Path(tmp) / "sphere.obj"
        path.write_text(_obj_text(np.asarray(verts), np.asarray(tris),
                                  np.asarray(uvs)))
        start = time.perf_counter()
        loaded = objloader.load_obj(str(path), native=True)
        load_ms = (time.perf_counter() - start) * 1e3
        start = time.perf_counter()
        objloader.load_obj(str(path), native=True)
        again_ms = (time.perf_counter() - start) * 1e3
        python = objloader.load_obj(str(path), native=False)
    if not (np.array_equal(loaded.faces, python.faces)
            and np.allclose(loaded.vertices, python.vertices, atol=1e-6)
            and loaded.has_uv):
        raise RuntimeError("[14] the native OBJ parser disagrees with the "
                           "Python one")
    device = background.device
    v_obj, uv_obj, _, f_obj = loaded.to_tensors(device)
    obj_clip = _clip_verts(v_obj, torch.tensor([0.4, 0.3, 0.0],
                                               device=device), device)
    obj_colors = torch.cat([uv_obj, 0.5 + 0.5 * v_obj[:, :1]], dim=1)
    obj_config = dirt_tpu_torch.suggest_raster_config(
        obj_clip, f_obj, SIZE, SIZE,
        config=dirt_tpu_torch.RasterConfig(engine="packed"), clip=False)

    def render():
        return dirt_tpu_torch.rasterise_with_aux(
            background, obj_clip, obj_colors, f_obj, config=obj_config,
            clip=False)

    _reset_launch_counts()
    pixels, fid, zbuf, overflow = render()
    _sync()
    _need_launches("OBJ render", _launch_counts(), KERNELS[:1])
    patches = _plain_patches()
    for patch in patches:
        patch.start()
    try:
        pix_pl, fid_pl, z_pl, _ = render()
    finally:
        for patch in patches:
            patch.stop()
    covered = int((fid >= 0).sum())
    if (bool(overflow) or covered == 0 or not torch.equal(fid, fid_pl)
            or not torch.equal(zbuf, z_pl)
            or not torch.allclose(pixels, pix_pl, **TOL)):
        raise RuntimeError("[14] the OBJ render on the card disagrees with "
                           "the plain path, or is empty or overflows")
    print(f"[14 OBJ] {len(loaded.vertices)} vertices, {len(loaded.faces)} "
          f"faces written and loaded by the native parser ({load_ms:.1f} ms "
          f"on first use, {again_ms:.2f} ms again; equal to the Python "
          f"parser), rendered at {SIZE}^2 by the packed "
          f"engine: {covered} covered pixels, fid and zbuf equal to the plain "
          f"path's, pixels within {TOL}")


def _demo(name):
    """The module of ``demos/<name>.py`` (the port's demos are scripts, not a
    package)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "demos" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _check_demo_render(tag, module, device, out):
    """Phase 16, demos 1-2: ``main`` on the card, then the same render with
    every kernel replaced by its plain version: fid and image equal.
    Returns the launches of ``main``'s render."""
    _reset_launch_counts()
    image, fid = module.main(device, out)
    _sync()
    counts = _launch_counts()
    _need_launches(tag, counts, ("raster_fwd_dense",))
    patches = _plain_patches()
    for patch in patches:
        patch.start()
    try:
        image_pl, fid_pl = module.render(device)
    finally:
        for patch in patches:
            patch.stop()
    err = float((image - image_pl).abs().max())
    if not (torch.equal(fid, fid_pl) and torch.equal(image, image_pl)):
        raise RuntimeError(f"[{tag}] the render differs from the plain "
                           f"path's: max |diff| {err}")
    print(f"[{tag}] {tuple(image.shape)}: {int((fid >= 0).sum())} covered "
          f"px; fid and image equal to the plain path's; launches {counts}")
    return counts


def _check_demo_fit(tag, module, kwargs, need, ratio, card, out):
    """Phase 16, demos 3-5: the first step's gradients against the plain
    path's (``_step_check``, TOL_DEFERRED), then the demo's ``main`` on the
    card, its loop counted: its steps are graph replays (``trainer``
    captures, ``run`` replays), so every kernel of ``need`` ``WARMUP + 1``
    times in ``trainer`` (its warm-up calls and the captured one), no
    other, and none in ``run`` (a demo with ``fit`` alone: every kernel of
    ``need`` once per step); the loss fallen by the demo's own ratio.
    Returns (``main``'s result, the launches of the loop and its
    capture)."""
    from dirt_tpu_torch.utils.graphstep import WARMUP

    loss_fn, params = module.problem(
        **{k: v for k, v in kwargs.items() if k != "steps"})[:2]
    _step_check(f"{tag} first step", loss_fn, tuple(params.values()), card,
                runs=5)
    counted = {}

    def counting(name):
        inner = getattr(module, name)

        def wrapper(*args):
            _sync()
            _reset_launch_counts()
            result = inner(*args)
            _sync()
            counted[name] = _launch_counts()
            return result

        return mock.patch.object(module, name, wrapper)

    graphed = hasattr(module, "trainer")
    names = ("trainer", "run") if graphed else ("fit",)
    patches = [counting(name) for name in names]
    for patch in patches:
        patch.start()
    try:
        result = module.main(out=out, **kwargs)
    finally:
        for patch in patches:
            patch.stop()
    steps = result["steps"]
    per_kernel = {"fit": steps, "trainer": WARMUP + 1, "run": 0}
    wrong = {name: counts for name, counts in counted.items()
             if counts != _want_launches({k: (per_kernel[name] if k in need
                                              else 0) for k in KERNELS})}
    if wrong or sorted(counted) != sorted(names):
        raise RuntimeError(f"[{tag}] want {need} launched "
                           f"{[(n, per_kernel[n]) for n in names]} times and "
                           f"no other kernel, got {counted}")
    if not result["l1"] < ratio * result["l0"]:
        raise RuntimeError(f"[{tag}] the loss fell only {result['l0']} -> "
                           f"{result['l1']}")
    loop = counted[names[0]]
    print(f"[{tag}] {steps} steps: loss {result['l0']:.6g} -> "
          f"{result['l1']:.6g} (limit {ratio} of the first); "
          f"{result['ms_per_step']:.4f} ms/step (CUDA events around the "
          f"loop); launches {counted} ({card})")
    return result, loop


def _demos_check(device, card):
    """Phase 16: the port's demos 1-5, each through its ``main`` into a
    temporary directory. Returns the launches of demos 1-2's renders and of
    demos 3-5's loops, summed."""
    from dirt_tpu_torch.utils.checkpoint import load_pytree

    launches = dict.fromkeys(COUNTED, 0)
    dense = ("raster_fwd_dense", "packed_prologue", "fused_bwd")
    demo5 = _demo("torch_demo5_deferred")
    with tempfile.TemporaryDirectory() as out:
        runs = [_check_demo_render(f"16 {name}", _demo(name), device, out)
                for name in ("torch_demo1_square", "torch_demo2_cube")]
        # Demo 3 trains the texture alone: nothing before the raster op
        # needs a gradient, so its loop runs the forward kernel only.
        for tag, name, kwargs, need, ratio in (
                ("16 torch_demo3_textured 512^2", "torch_demo3_textured",
                 dict(size=512, steps=60), ("raster_fwd_dense",), 0.3),
                ("16 torch_demo4_lit 512^2", "torch_demo4_lit",
                 dict(size=512, steps=80), dense, 0.25),
                ("16 torch_demo5_deferred 1024^2 10,224 faces C=9",
                 "torch_demo5_deferred",
                 dict(size=SIZE, steps=80, n_lat=72, n_lon=72), KERNELS[:3],
                 0.5)):
            module = demo5 if name == "torch_demo5_deferred" else _demo(name)
            result, loop = _check_demo_fit(tag, module,
                                           dict(kwargs, device=device), need,
                                           ratio, card, out)
            runs.append(loop)
        restored = load_pytree(result["checkpoint"])
        if not (np.array_equal(restored["params"]["pose"],
                               result["pose"].cpu().numpy())
                and int(restored["step"]) == result["steps"]
                and sorted(restored) == ["m", "params", "step", "v"]):
            raise RuntimeError("[16] demo 5's checkpoint did not load back "
                               "equal")
        print(f"[16 torch_demo5_deferred] checkpoint {sorted(restored)} "
              f"loads back equal; pose {result['pose'].tolist()} (true "
              f"{list(demo5.TRUE_POSE)})")
    for counts in runs:
        for kernel_name in COUNTED:
            launches[kernel_name] += counts[kernel_name]
    return launches


def _huge_sphere_check(device, card, n=708):
    """Phase 17: ``mesh.uv_sphere(n, n)`` (708: 1,001,112 faces) under the
    bench camera at SIZE, ``clip=False``, one fwd+bwd under the packed
    engine (what ``suggest_raster_config`` picks) and under the streaming
    engine, each under its honest caps: overflow clear, gradients finite
    and nonzero, fids equal between the engines, pixels within
    TOL_SLAB_PIXELS, gradients within TOL_ENGINES of max |gradient|. Returns
    the launches of the two steps."""
    import dirt_tpu_torch
    from bench_torch import engine_of

    scene = bench_scene(SIZE, device, n=n)
    _, clip, colors, faces, background, weights = scene
    num_faces = faces.shape[0]
    runs, launches, lines = {}, {}, []
    for engine, fields in (("packed", {}), ("csr", dict(streaming=True))):
        start = time.perf_counter()
        config = dirt_tpu_torch.suggest_raster_config(
            clip, faces, SIZE, SIZE,
            config=dirt_tpu_torch.RasterConfig(**fields), clip=False)
        _sync()
        setup_s = time.perf_counter() - start
        if engine_of(config, num_faces) != engine:
            raise RuntimeError(f"[17] {config} is not the {engine} engine")
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        start = time.perf_counter()
        runs[engine] = _grads(dirt_tpu_torch.rasterise_with_aux, background,
                              clip, colors, faces, weights, config, False)
        _sync()
        step_s = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated()
        counts = _launch_counts()
        path = KERNELS[:3] if engine == "packed" else CSR_PATH
        _need_launches(f"17 {engine}", counts, path)
        if any(counts[k] for k in KERNELS if k not in path):
            raise RuntimeError(f"[17] {engine}: another engine's kernel "
                               f"launched: {counts}")
        for k in path + (SCAN, SETUP_VJP):
            launches[k] = launches.get(k, 0) + counts[k]
        (_, fid, _, overflow), grads = runs[engine]
        if bool(overflow):
            raise RuntimeError(f"[17] {engine}: overflow under {config}")
        if not all(g is not None and bool(torch.isfinite(g).all())
                   for g in grads) or not bool(grads[0].abs().sum() > 0):
            raise RuntimeError(f"[17] {engine}: gradients missing, not "
                               f"finite or zero")
        def step():
            return _grads(dirt_tpu_torch.rasterise_with_aux, background,
                          clip, colors, faces, weights, config, False)

        step_ms = _median_ms(step, runs=3, warmup=0)
        device_items = _device_ms(step, runs=3, warmup=0)
        largest = sorted(device_items.items(), key=lambda kv: -kv[1])[:4]
        lines.append(
            f"[17 {num_faces}-face sphere {SIZE}^2 {engine}] caps {config} "
            f"set up in {setup_s:.2f} s; overflow False; covered "
            f"{int((fid >= 0).sum())} px; fwd+bwd first call "
            f"{step_s * 1e3:.1f} ms (host clock), then {step_ms:.4f} ms "
            f"(median of 3); device busy "
            f"{sum(device_items.values()):.4f} ms a step (profiler), largest: "
            + ", ".join(f"{k[:48]} {v:.4f} ms" for k, v in largest)
            + f"; peak memory {peak / 2**20:.1f} MiB; launches {counts} "
            f"({card})")
    (pix_p, fid_p, _, _), grads_p = runs["packed"]
    (pix_c, fid_c, _, _), grads_c = runs["csr"]
    pix_err = float((pix_p - pix_c).detach().abs().max())
    errs = [_rel_err(g_c, g_p) for g_c, g_p in zip(grads_c, grads_p)]
    if not (torch.equal(fid_p, fid_c) and pix_err <= TOL_SLAB_PIXELS
            and all(e <= TOL_ENGINES for e in errs)):
        raise RuntimeError(f"[17] csr and packed engines disagree: "
                           f"{int((fid_p != fid_c).sum())} fids, pixels "
                           f"{pix_err}, gradients {errs}")
    for line in lines:
        print(line)
    print(f"[17 {num_faces}-face sphere {SIZE}^2] csr vs packed: fid equal, "
          f"pixels max |diff| {pix_err:.3g} (limit {TOL_SLAB_PIXELS:g}), "
          f"max |grad diff| / max |grad| vertices {errs[0]:.3g} colors "
          f"{errs[1]:.3g} background {errs[2]:.3g} (limit "
          f"{TOL_ENGINES:g}); gradients finite")
    return launches


# Samples per line of phase 18's tools (the tools' own defaults are 10 on
# the bench sphere and 3 on the 1,001,112-face sphere) and calls in the
# stage and parallel tools' profiler windows (their own default 5; the
# binning tool runs without one here).
TOOL_SAMPLES = 2
TOOL_PROFILE = 2


def _tools_check(device, card, bench_config):
    """Phase 18: the stage, binning and parallel profilers
    (``tools/prof_torch_stages.py``, ``prof_torch_binning.py``,
    ``prof_torch_parallel.py``) through their ``run`` on the bench sphere
    under ``bench_config`` (phase 4's caps) and on the 1,001,112-face sphere
    under ``suggest_raster_config``'s, with the checks that they time the
    work the API does: on both scenes the staged forward (setup, binning,
    K1) gives fid, zbuf and pixels equal bit for bit to
    ``rasterise_with_aux``'s, the backward pieces (K3, K2, the pool
    reduce) the output of ``backward_packed`` bit for bit, and
    ``_stage=0`` bins equal field by field to a call without it; on the
    bench sphere every ``_stage`` checksum on the card equals the one the
    CPU computes from the same inputs; the binning tool asserts its cummax
    A/B values equal and the parallel tool every variant's fid equal to the
    plain step's and its gradients within TOL_ENGINES; on both scenes the
    setup VJP (:func:`_check_setup_vjp`), on the bench sphere at C = 3 and
    9. Returns (the launch counts of the phase, {SETUP_VJP: the bench
    sphere's record at C = 3, with the big sphere's under ``at`` and the
    C = 9 one under ``c9``})."""
    import dirt_tpu_torch
    from dirt_tpu_torch.ops import binning

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import prof_torch_binning
    import prof_torch_parallel
    import prof_torch_stages

    start = time.perf_counter()
    _reset_launch_counts()
    vjp = {}
    for n_lat in (72, 708):
        scene = bench_scene(SIZE, device, n=n_lat)
        _, clip, colors, faces, background, weights = scene
        config = bench_config if n_lat == 72 else \
            dirt_tpu_torch.suggest_raster_config(clip, faces, SIZE, SIZE,
                                                 clip=False)
        tag = f"18 tools {faces.shape[0]} faces {SIZE}^2"
        pixels, fid, zbuf, geo, att, bins, geom = \
            prof_torch_stages.staged_forward(scene, config)
        want = dirt_tpu_torch.rasterise_with_aux(
            background, clip, colors, faces, config=config, clip=False)
        if bool(want[3]) or not all(
                torch.equal(a, b) for a, b in zip((pixels, fid, zbuf), want)):
            raise RuntimeError(f"[{tag}] the staged forward differs from "
                               f"rasterise_with_aux (overflow "
                               f"{bool(want[3])})")
        got = prof_torch_stages.staged_backward(
            geo, att, fid, zbuf, pixels, weights, bins, geom)
        want = prof_torch_stages.backward_core(
            geo, att, fid, zbuf, pixels, weights, bins, geom)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"[{tag}] prologue -> K2 -> pool reduce "
                               f"differs from backward_packed")
        _, _, bbox, edges = prof_torch_stages.setup(clip, colors, faces, SIZE)
        plain = prof_torch_stages.bin_faces(bbox, edges, geom)
        zero = prof_torch_stages.bin_faces(bbox, edges, geom, _stage=0)
        for field in binning.PackedBins._fields:
            a, b = getattr(plain, field), getattr(zero, field)
            if (a is None) != (b is None) or (
                    a is not None and not torch.equal(a, b)):
                raise RuntimeError(f"[{tag}] _stage=0 changes {field}")
        print(f"[{tag}] staged forward (setup, binning, K1) bit-equal to "
              f"rasterise_with_aux: pixels, fid, zbuf; prologue -> K2 -> "
              f"pool reduce bit-equal to backward_packed; _stage=0 bins "
              f"equal field by field ({card})")
        del pixels, fid, zbuf, geo, att, bins, got, want, plain, zero
        prof_torch_stages.run(device, SIZE, n_lat, TOOL_SAMPLES, config,
                              TOOL_PROFILE, card)
        record = prof_torch_binning.run(device, SIZE, n_lat, TOOL_SAMPLES,
                                        config, 0, card)
        if n_lat == 72:
            on_cpu = prof_torch_binning.stage_checksums(
                tuple(c.cpu() for c in bbox), [c.cpu() for c in edges], geom)
            if on_cpu != record["checksums"]:
                raise RuntimeError(f"[{tag}] _stage checksums on the card "
                                   f"{record['checksums']} differ from the "
                                   f"CPU's {on_cpu}")
            print(f"[{tag}] the ten _stage checksums on the card equal the "
                  f"CPU's from the same inputs")
        vjp[n_lat] = _check_setup_vjp(clip, colors, faces, card)
        if n_lat == 72:
            vjp[9] = _check_setup_vjp(
                clip, _rand(5, clip.shape[0], 9, device=device), faces, card)
        del scene, clip, colors, faces, background, weights, bbox, edges
    prof_torch_parallel.run(device, SIZE, samples=TOOL_SAMPLES,
                            config=bench_config, profile=TOOL_PROFILE,
                            card=card)
    _sync()
    counts = _launch_counts()
    missed = [k for k in KERNELS[:3] + (SCAN,) if counts[k] < 1]
    if missed:
        raise RuntimeError(f"[18 tools] missed a kernel: {missed} of "
                           f"{counts}")
    # Each packed forward bins once; the tools also bin without it, stop a
    # binning at a ``_stage`` hook and time single scans.
    if counts[SCAN] < SCANS_PER_BINNING * counts["raster_fwd_packed"]:
        raise RuntimeError(f"[18 tools] {SCAN} launched {counts[SCAN]} "
                           f"times: fewer than {SCANS_PER_BINNING} for each "
                           f"packed forward, of {counts}")
    print(f"[18 tools] launches {counts}; {time.perf_counter() - start:.1f} s "
          f"({card})")
    return counts, {SETUP_VJP: dict(vjp[72], c9=vjp[9],
                                    at={vjp[708]["faces"]: vjp[708]})}


def _check_max_scan(device, card, runs=10):
    """Phase 18: max_scan against its plain version, ``torch.cummax(x,
    0).values``, which is also the one PyTorch call of the same function
    (``library_ms``; the port no longer calls it), at the lengths of
    SCAN_SIZES, on runs as the binning scans them (-1 between run starts,
    non-decreasing values at them). Returns {SCAN: record of the first
    length, with the others under ``at``}; raises unless the two are equal
    bit for bit."""
    from dirt_tpu_torch.ops import scan

    records = {}
    for n in SCAN_SIZES:
        rng = np.random.RandomState(n)
        x = np.full(n, -1, np.int64)
        starts = np.sort(rng.choice(n, n // 5, replace=False))
        x[starts] = np.sort(rng.randint(0, 4 * n, starts.size))
        x = torch.as_tensor(x, device=device)
        before = _launch_counts()[SCAN]
        got = scan.max_scan(x)
        want = scan.max_scan_plain(x)
        _sync()
        if _launch_counts()[SCAN] != before + 1 or not torch.equal(got, want):
            raise RuntimeError(f"[18 max_scan] {n} elements: the kernel "
                               f"differs from torch.cummax or did not run")

        def device_alone(fn):
            by_name = _device_ms(fn, runs)
            return sum(by_name.values()), sum(
                ms for name, ms in by_name.items() if SCAN in name)

        call_ms, kernel_ms = device_alone(lambda: scan.max_scan(x))
        library_device_ms, _ = device_alone(lambda: scan.max_scan_plain(x))
        rec = dict(elements=n, max_abs_err=0.0,
                   ms=_median_ms(lambda: scan.max_scan(x), runs),
                   plain_ms=_median_ms(lambda: scan.max_scan_plain(x), runs),
                   device_ms=call_ms, kernel_device_ms=kernel_ms,
                   library_device_ms=library_device_ms,
                   **_bound(16 * n, 0))
        rec["library_ms"] = rec["plain_ms"]
        records[n] = rec
        print(f"[18 max_scan] {n} elements: equal bit for bit to "
              f"torch.cummax; kernel {rec['ms']:.4f} ms, plain version = "
              f"torch.cummax {rec['plain_ms']:.4f} ms (single calls, medians "
              f"of {runs}); device alone: the call {call_ms:.4f} ms (the "
              f"scan {kernel_ms:.4f} + zeroing its status words), "
              f"torch.cummax {library_device_ms:.4f} ms; bound "
              f"{rec['bound_ms']:.4f} ms by bytes (16 B an element) ({card})")
        del x, got, want
    first, *rest = SCAN_SIZES
    return {SCAN: dict(records[first], at={n: records[n] for n in rest})}


def setup_vjp_bound(num_faces, channels):
    """The setup VJP's least time: bytes, 164 + 36C a face (corners,
    attributes, d_geo's 17 used columns, d_att in; the two cotangents
    out), against ~130 + 50C float operations."""
    return _bound((164 + 36 * channels) * num_faces,
                  (130 + 50 * channels) * num_faces)


def _check_setup_vjp(clip, colors, faces, card, runs=20):
    """Phase 18: the setup VJP kernel against its plain version, bit for
    bit, on the faces of one of the tools' scenes (the bench sphere, the
    1,001,112-face sphere) with ``colors``' C channels (3, or 9 on the
    bench sphere: the G-buffer's, another register instance) and random
    cotangents (``d_att`` a view of [F, 12 + 3C] rows, as the engines hand
    it). Times, ms a call of
    ``runs`` calls queued back to back (CUDA events: the card's time where
    the card is the limit, as for the kernel on the big sphere; the host's
    launch rate where the host is): the kernel beside its bound, the plain
    version and autograd through ``setup_planes``, the chain it replaced
    (its library yardstick; the port no longer runs it). A profiler window
    read the kernel below its bound at 1M (it loses records), so none is
    taken. Returns the scene's record."""
    from dirt_tpu_torch.ops import triangle_setup

    fv = triangle_setup.screen_from_clip(clip, SIZE, SIZE)[faces]
    fa = colors[faces]
    num_faces, channels = fv.shape[0], fa.shape[-1]
    gen = torch.Generator(device=fv.device).manual_seed(num_faces)
    d_geo = torch.randn(num_faces, 24, device=fv.device, generator=gen)
    rows = torch.randn(num_faces, 12 + 3 * channels, device=fv.device,
                       generator=gen)
    args = (fv, fa, d_geo, rows[:, 12:])
    tag = f"18 setup_vjp {num_faces} faces C={channels}"
    before = _launch_counts_of(SETUP_VJP)
    got = triangle_setup.setup_planes_vjp(*args)
    want = triangle_setup.setup_planes_vjp_plain(*args)
    _sync()
    if _launch_counts_of(SETUP_VJP) != before + 1 or not all(
            torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError(f"[{tag}] the kernel differs from its plain "
                           f"version or did not run")

    def autograd_chain():
        with torch.enable_grad():
            x = fv.detach().requires_grad_()
            y = fa.detach().requires_grad_()
            geo, att, _ = triangle_setup.setup_planes(x, y)
            return torch.autograd.grad([geo, att], [x, y], [d_geo, args[3]])

    queued_ms, host_ms = _queued_ms(
        lambda: triangle_setup.setup_planes_vjp(*args), runs)
    plain_ms, _ = _queued_ms(
        lambda: triangle_setup.setup_planes_vjp_plain(*args), runs)
    library_ms, _ = _queued_ms(autograd_chain, runs)
    rec = dict(faces=num_faces, channels=channels, max_abs_err=0.0,
               ms=_median_ms(lambda: triangle_setup.setup_planes_vjp(*args),
                             10),
               queued_ms=queued_ms, host_ms=host_ms,
               plain_queued_ms=plain_ms, library_ms=library_ms,
               **setup_vjp_bound(num_faces, channels))
    print(f"[{tag}] equal bit for bit to its plain version; "
          f"{runs} calls queued back to back (CUDA events), ms a call: the "
          f"kernel {queued_ms:.4f} (the host {host_ms:.4f} ms to queue one), "
          f"bound {rec['bound_ms']:.4f} by {rec['bound_by']}; the plain "
          f"version {plain_ms:.4f}, autograd through setup_planes (the chain "
          f"it replaced) {library_ms:.4f}; one call {rec['ms']:.4f} ms "
          f"({card})")
    return rec


# Timed calls per median of phases 19 and 20 (the 1,001,112-face step: 3),
# and steps in their profiler windows (a window of the card's activity
# alone; a step of four slabs holds up to ~10,600 kernels).
GRAPH_RUNS = 10
GRAPH_PROFILE = 1
# Demo 5's training loop in phase 19, as its main runs it.
DEMO5_STEPS = 80


def render_step(render, weights):
    """``step(background, vertices, colors) -> (pixels, fid, overflow,
    d_vertices, d_colors, d_background)`` of ``loss = sum(pixels * w)``,
    ``render(background, vertices, colors) -> (pixels, fid, zbuf,
    overflow)``, as a function of its leaves."""
    def step(bg, verts, cols):
        bg, verts, cols = (t.detach().requires_grad_()
                           for t in (bg, verts, cols))
        pixels, fid, _, overflow = render(bg, verts, cols)
        grads = torch.autograd.grad((pixels * weights).sum(),
                                    (verts, cols, bg))
        return (pixels.detach(), fid, overflow, *grads)

    return step


def api_step(scene, config, clip_flag):
    """:func:`render_step` of the bench step of ``scene`` under ``config``
    through ``rasterise_with_aux``."""
    import dirt_tpu_torch

    _, _, _, faces, _, weights = scene
    return render_step(
        lambda bg, verts, cols: dirt_tpu_torch.rasterise_with_aux(
            bg, verts, cols, faces, config=config, clip=clip_flag), weights)


def _card_profile(tag, fn, card, steps=GRAPH_PROFILE):
    """(device kernels a call, device busy ms a call, busy share, the three
    largest device items and the hand-written kernels, each as "name ms
    xcount" a call) of ``fn`` from a
    profiler window of ``steps`` calls of the card's activity alone (no
    host operators recorded: the window costs less, and its span holds less
    of the profiler's own host time than ``tools/prof_torch_steps.py``'s
    windows, so busy shares come out higher than theirs), after one
    warm-up call; a window without device records is taken again with
    twice the calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(6):
        _sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                fn()
            _sync()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
        steps *= 2
    else:
        raise RuntimeError(f"[{tag}] the profiler recorded no device "
                           "activity")
    busy = sum(e.device_time for e in kernels) / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    by_name = {}
    for e in kernels:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.device_time / 1e3, count + 1)
    top = ", ".join(
        f"{name[:40]} {ms / steps:.4f} ms x{count / steps:.0f}"
        for name, (ms, count) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][0])[:3])
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from prof_torch_steps import OURS

    ours = ", ".join(
        f"{name.replace('(anonymous namespace)::', '').split('(')[0]} "
        f"{ms / steps:.4f} ms x{count / steps:.0f}"
        for name, (ms, count) in sorted(by_name.items())
        if any(o in name for o in OURS))
    return len(kernels) / steps, busy / steps, busy / span, top, ours


def _graph_pair(tag, step, args, kernels, card, exact, tol,
                runs=GRAPH_RUNS, moved=None, vjps=None):
    """Phases 19 and 20: ``step(*args)`` eager and as a ``GraphedStep``.

    After a warm call, one eager call under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host read or a blocking
    copy raises), with ``kernels`` launched (the prologue once; setup_vjp
    ``vjps`` times, None: once, as the prologue); then the capture (its
    ``WARMUP`` warm-up calls and the
    captured call), which must launch every kernel of the eager call
    ``WARMUP + 1`` times: the captured call went through the path's
    kernels. The first replay's outputs against the eager call's: the first
    ``exact`` equal bit for bit, the rest within ``tol`` of their largest
    magnitude. Medians of ``runs`` calls of each, kernels a call and the
    busy share of a profiler window (and the graphed call's three largest
    device items), the peak memory of each above what was allocated before
    it and the bytes the graph's private pool holds. With ``moved`` (other
    arguments of the same signature), a further replay on them against
    the eager call on them, held as the first. Returns the launch counts
    of the capture."""
    from dirt_tpu_torch.utils.graphstep import WARMUP, GraphedStep

    t_pair = time.perf_counter()
    step(*args)                 # builds kernels and fills caches
    _sync()
    _reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        want = step(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _sync()
    eager_counts = _launch_counts()
    _need_launches(tag, eager_counts, kernels, vjps=vjps)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eager_ms = _median_ms(lambda: step(*args), runs, warmup=1)
    eager_peak = torch.cuda.max_memory_allocated() - base

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    start = time.perf_counter()
    graphed = GraphedStep(step, args)
    _sync()
    capture_s = time.perf_counter() - start
    counts = _launch_counts()
    if counts != {k: (WARMUP + 1) * n for k, n in eager_counts.items()}:
        raise RuntimeError(f"[{tag}] the capture's launches {counts} are not "
                           f"{WARMUP} warm-up calls and the captured one of "
                           f"{eager_counts}")
    got = graphed(*args)
    _sync()
    same = [torch.equal(g, w) for g, w in zip(got, want)]
    errs = [_rel_err(g, w) for g, w in zip(got[exact:], want[exact:])]
    if not all(same[:exact]) or not all(e <= tol for e in errs):
        raise RuntimeError(f"[{tag}] graphed and eager disagree: bit-equal "
                           f"{same}, max |diff| / max |x| {errs}")
    graphed_ms = _median_ms(lambda: graphed(*args), runs, warmup=1)
    graph_peak = torch.cuda.max_memory_allocated() - base
    pool = graphed.pool_bytes()
    second = ""
    if moved is not None:
        got = graphed(*moved)
        want = step(*moved)
        _sync()
        same2 = [torch.equal(g, w) for g, w in zip(got, want)]
        errs2 = [_rel_err(g, w) for g, w in zip(got[exact:], want[exact:])]
        if not all(same2[:exact]) or not all(e <= tol for e in errs2):
            raise RuntimeError(f"[{tag}] graphed and eager disagree on other "
                               f"inputs: bit-equal {same2}, max |diff| / "
                               f"max |x| {errs2}")
        second = (f"; a replay on other inputs: bit-equal {same2}, max "
                  f"|diff| / max |x| {' '.join(f'{e:.3g}' for e in errs2)}")
    t_prof = time.perf_counter()
    prof = [_card_profile(f"{tag} {kind}", fn, card) for kind, fn in (
        ("eager", lambda: step(*args)), ("graphed", lambda: graphed(*args)))]
    t_prof = time.perf_counter() - t_prof
    print(f"[{tag}] graphed vs eager: outputs bit-equal {same} (the first "
          f"{exact} must be), max |diff| / max |x| "
          f"{' '.join(f'{e:.3g}' for e in errs)} (limit {tol:g}){second}; "
          f"launches in the capture {counts}; capture {capture_s:.3f} s; "
          f"median of "
          f"{runs}: eager {eager_ms:.4f} ms, graphed {graphed_ms:.4f} ms "
          f"({eager_ms / graphed_ms:.2f}x); device kernels a call eager "
          f"{prof[0][0]:.1f}, graphed {prof[1][0]:.1f}; device busy a call "
          f"{prof[0][1]:.4f} / {prof[1][1]:.4f} ms, busy share "
          f"{prof[0][2]:.3f} / {prof[1][2]:.3f}; largest device items "
          f"graphed: {prof[1][3]}; hand-written kernels graphed: "
          f"{prof[1][4]}; peak memory above the "
          f"allocated before: eager {eager_peak / 2**20:.1f} MiB, capture "
          f"and replays {graph_peak / 2**20:.1f} MiB; the graph's pool "
          f"holds {pool / 2**20:.1f} MiB; {time.perf_counter() - t_pair:.1f}"
          f" s, profiles {t_prof:.1f} s ({card})")
    return counts


def _graphed_demo5_check(device, card):
    """Phase 19, demo 5: its 80 Adam steps (``trainer`` and ``run``,
    ``main``'s path) with each step a graph replay, against the same loop
    with ``GraphedStep`` replaced by the eager call, run twice. The two
    eager loops must be equal bit for bit (Adam scales each gradient to
    its own size, so a vertex whose gradient is rounding noise takes full
    steps: before the vertex normals summed in a sorted order, torch's
    atomics there made two eager loops differ by up to 0.54 of the bump),
    and the graphed loop is held to the eager loop within TOL_DEFERRED:
    every loss, the final pose, the final bump, each as max |diff| over
    max |x|. Launches: eager, each kernel of
    the packed path once a step in the loop; graphed, ``WARMUP + 1`` times
    in ``trainer`` (warm-up calls and the captured one) and none in the
    loop. ms a step of each loop (CUDA events around it), kernels a step
    and the busy share of a profiler window of further steps, peak memory
    above the allocated before, the bytes the graph's pool holds. Returns
    the launches of the graphed trainer."""
    from dirt_tpu_torch.utils.benchtime import timed
    from dirt_tpu_torch.utils.graphstep import WARMUP

    demo5 = _demo("torch_demo5_deferred")
    loss_fn, params = demo5.problem(SIZE, 72, 72, device)[:2]
    made = []

    class Recorded(demo5.GraphedStep):
        def __init__(self, fn, example_args):
            super().__init__(fn, example_args)
            made.append(self)

    runs = {}
    for kind in ("eager", "eager again", "graphed"):
        patch = mock.patch.object(
            demo5, "GraphedStep",
            (lambda fn, example_args: fn) if kind.startswith("eager")
            else Recorded)
        with patch:
            _sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _reset_launch_counts()
            (step, _, leaves), setup_s = timed(device, demo5.trainer,
                                               loss_fn, params, DEMO5_STEPS)
            setup_counts = _launch_counts()
            _reset_launch_counts()
            losses, loop_s = timed(device, demo5.run, step, DEMO5_STEPS,
                                   device)
            loop_counts = _launch_counts()
            peak = torch.cuda.max_memory_allocated() - base
            final = [losses] + [t.detach().clone() for t in leaves]
            prof = None if kind == "eager again" else _card_profile(
                f"19 demo5 {kind}", lambda: step(DEMO5_STEPS), card)
        runs[kind] = (final, setup_counts, loop_counts, setup_s, loop_s,
                      prof, peak)
    final_e, setup_e, loop_e, _, loop_s_e, prof_e, peak_e = runs["eager"]
    final_g, setup_g, loop_g, setup_s, loop_s_g, prof_g, peak_g = \
        runs["graphed"]
    path = KERNELS[:3]
    want_g = _want_launches({k: (WARMUP + 1 if k in path else 0)
                             for k in KERNELS})
    want_e = _want_launches({k: (DEMO5_STEPS if k in path else 0)
                             for k in KERNELS})
    if (setup_g != want_g or any(loop_g.values()) or loop_e != want_e
            or any(setup_e.values())):
        raise RuntimeError(f"[19 demo5] launches: graphed trainer {setup_g} "
                           f"(want {want_g}), loop {loop_g} (want none); "
                           f"eager trainer {setup_e}, loop {loop_e} (want "
                           f"{want_e})")
    spread = [_rel_err(a, e) for a, e in zip(runs["eager again"][0],
                                             final_e)]
    errs = [_rel_err(g, e) for g, e in zip(final_g, final_e)]
    limits = [TOL_DEFERRED] * len(errs)
    losses_g = final_g[0]
    if not (all(e <= lim for e, lim in zip(errs, limits))
            and not any(spread)
            and float(losses_g[-1]) < 0.5 * float(losses_g[0])):
        raise RuntimeError(f"[19 demo5] graphed and eager loops disagree "
                           f"(losses, pose, bump: {errs}, limits {limits}), "
                           f"two eager loops differ ({spread}) or the loss "
                           f"did not "
                           f"fall: {float(losses_g[0])} -> "
                           f"{float(losses_g[-1])}")
    print(f"[19 demo5 {SIZE}^2 10,224 faces C=9 packed, {DEMO5_STEPS} Adam "
          f"steps] graphed vs eager: losses, pose, bump max |diff| / max "
          f"|x| {' '.join(f'{e:.3g}' for e in errs)} (limits "
          f"{' '.join(f'{x:.3g}' for x in limits)}; eager vs eager "
          f"{' '.join(f'{x:.3g}' for x in spread)}); loss "
          f"{float(losses_g[0]):.6g} -> {float(losses_g[-1]):.6g}; "
          f"launches: graphed trainer {setup_g}, loop none; eager loop "
          f"{loop_e}; trainer with capture {setup_s:.3f} s; ms a step eager "
          f"{loop_s_e * 1e3 / DEMO5_STEPS:.4f}, graphed "
          f"{loop_s_g * 1e3 / DEMO5_STEPS:.4f} "
          f"({loop_s_e / loop_s_g:.2f}x); device kernels a step eager "
          f"{prof_e[0]:.1f}, graphed {prof_g[0]:.1f}; device busy a step "
          f"{prof_e[1]:.4f} / {prof_g[1]:.4f} ms, busy share "
          f"{prof_e[2]:.3f} / {prof_g[2]:.3f}; largest device items "
          f"graphed: {prof_g[3]}; peak memory above the "
          f"allocated before: eager {peak_e / 2**20:.1f} MiB, graphed "
          f"{peak_g / 2**20:.1f} MiB; the graph's pool holds "
          f"{made[0].pool_bytes() / 2**20:.1f} MiB ({card})")
    return setup_g


def _graphed_check(device, card, scene, configs):
    """Phase 19: the port's compiled steps. Each path eager and as
    CUDA-graph replays (``utils.graphstep.GraphedStep``): the bench sphere
    at SIZE under phase 4's caps, packed (``configs[c]``), dense and csr,
    ``clip`` off and on; the flagship step (``entry.entry_step``); demo 5's
    loop; the 1,001,112-face sphere, packed. Returns the launch counts of
    the phase (eager calls and captures)."""
    import dirt_tpu_torch
    from dirt_tpu_torch import entry
    from dirt_tpu_torch.utils.graphstep import value_and_grad

    start = time.perf_counter()
    launches = dict.fromkeys(COUNTED, 0)

    def add(counts):
        for k in COUNTED:
            launches[k] += counts[k]

    _, clip, colors, faces, background, _ = scene
    args = (background, clip, colors)
    engines = {"packed": (KERNELS[:3], None),
               "dense": (("raster_fwd_dense", "packed_prologue",
                          "fused_bwd"), dict(engine="dense")),
               "csr": (CSR_PATH, dict(streaming=True))}
    for engine, (path, fields) in engines.items():
        for c in (False, True):
            config = configs[c] if fields is None else \
                dirt_tpu_torch.suggest_raster_config(
                    clip, faces, SIZE, SIZE,
                    config=dirt_tpu_torch.RasterConfig(**fields), clip=c)
            add(_graph_pair(f"19 bench sphere {SIZE}^2 {engine} clip={c}",
                            api_step(scene, config, c), args, path, card,
                            exact=3, tol=TOL_GRAD))
    forward_step, flagship_args = entry.entry(device)
    add(_graph_pair("19 flagship 256^2 dense C=9",
                    value_and_grad(forward_step), flagship_args,
                    ("raster_fwd_dense", "packed_prologue", "fused_bwd"),
                    card, exact=0, tol=TOL_DEFERRED))
    add(_graphed_demo5_check(device, card))
    huge = bench_scene(SIZE, device, n=708)
    _, h_clip, h_colors, h_faces, h_background, _ = huge
    h_config = dirt_tpu_torch.suggest_raster_config(h_clip, h_faces, SIZE,
                                                    SIZE, clip=False)
    add(_graph_pair(f"19 {h_faces.shape[0]}-face sphere {SIZE}^2 packed",
                    api_step(huge, h_config, False),
                    (h_background, h_clip, h_colors), KERNELS[:3], card,
                    exact=3, tol=TOL_GRAD, runs=3))
    print(f"[19 compiled steps] launches {launches}; "
          f"{time.perf_counter() - start:.1f} s ({card})")
    return launches


# Demos 3 and 4 in phase 20, as their mains run them: (module, size,
# steps, the kernels of a step, the fall of the loss their main asks for).
DEMO_LOOPS = {
    3: ("torch_demo3_textured", 512, 60, ("raster_fwd_dense",), 0.3),
    4: ("torch_demo4_lit", 512, 80,
        ("raster_fwd_dense", "packed_prologue", "fused_bwd"), 0.25),
}


def _graphed_demo_check(n, device, card):
    """Phase 20, demos 3 and 4: the loop of ``main`` (``trainer`` and
    ``run``) with each step a graph replay, against the same loop with
    ``GraphedStep`` replaced by the eager call, run twice (demo 3's
    texture gather's backward sums with atomics, so its two eager loops
    may differ in the last bits), as phase 19 holds demo 5: every loss and
    the final parameters within TOL_DEFERRED; one eager step under
    ``set_sync_debug_mode("error")``; launches: graphed, each kernel of the
    step ``WARMUP + 1`` times in ``trainer`` and none in the loop; eager,
    once a step in the loop; the loss after the loop below the demo's
    ratio of the first. ms a step of each loop, kernels a step and busy
    share, peak memory, the graph's pool. Returns the launches of the
    graphed trainer."""
    from dirt_tpu_torch.utils.benchtime import timed
    from dirt_tpu_torch.utils.graphstep import WARMUP

    name, size, steps, path, ratio = DEMO_LOOPS[n]
    tag = f"20 demo{n} {size}^2, {steps} steps"
    t_check = time.perf_counter()
    demo = _demo(name)
    loss_fn, params = demo.problem(size, device)[:2]
    made = []

    class Recorded(demo.GraphedStep):
        def __init__(self, fn, example_args):
            super().__init__(fn, example_args)
            made.append(self)

    def eager(fn, example_args):
        return fn

    with mock.patch.object(demo, "GraphedStep", eager):
        step = demo.trainer(loss_fn, params)[0]
        step()
        _sync()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    runs = {}
    for kind in ("eager", "eager again", "graphed"):
        with mock.patch.object(demo, "GraphedStep",
                               Recorded if kind == "graphed" else eager):
            _sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _reset_launch_counts()
            (step, state), setup_s = timed(device, demo.trainer, loss_fn,
                                           params)
            setup_counts = _launch_counts()
            _reset_launch_counts()
            losses, loop_s = timed(device, demo.run, step, steps, device)
            loop_counts = _launch_counts()
            peak = torch.cuda.max_memory_allocated() - base
            final = [losses] + [t.detach().clone() for t in state]
            prof = None if kind == "eager again" else _card_profile(
                f"{tag} {kind}", step, card)
        runs[kind] = (final, setup_counts, loop_counts, setup_s, loop_s,
                      prof, peak)
    final_e, setup_e, loop_e, _, loop_s_e, prof_e, peak_e = runs["eager"]
    final_g, setup_g, loop_g, setup_s, loop_s_g, prof_g, peak_g = \
        runs["graphed"]
    want_g = _want_launches({k: (WARMUP + 1 if k in path else 0)
                             for k in KERNELS})
    want_e = _want_launches({k: (steps if k in path else 0)
                             for k in KERNELS})
    if (setup_g != want_g or any(loop_g.values()) or loop_e != want_e
            or any(setup_e.values())):
        raise RuntimeError(f"[{tag}] launches: graphed trainer {setup_g} "
                           f"(want {want_g}), loop {loop_g} (want none); "
                           f"eager trainer {setup_e}, loop {loop_e} (want "
                           f"{want_e})")
    spread = [_rel_err(a, e) for a, e in zip(runs["eager again"][0],
                                             final_e)]
    errs = [_rel_err(g, e) for g, e in zip(final_g, final_e)]
    limits = [TOL_DEFERRED] * len(errs)
    first = float(final_g[0][0])
    last = float(loss_fn(*final_g[1:]))
    if not (all(e <= lim for e, lim in zip(errs, limits))
            and last < ratio * first):
        raise RuntimeError(f"[{tag}] graphed and eager loops disagree "
                           f"(losses, parameters: {errs}, limits {limits}, "
                           f"eager vs eager {spread}) or the loss did not "
                           f"fall below {ratio} of the first: {first} -> "
                           f"{last}")
    print(f"[{tag}] graphed vs eager: losses, parameters max |diff| / max "
          f"|x| {' '.join(f'{e:.3g}' for e in errs)} (limits "
          f"{' '.join(f'{x:.3g}' for x in limits)}; eager vs eager "
          f"{' '.join(f'{x:.3g}' for x in spread)}); eager step clean under "
          f"set_sync_debug_mode('error'); loss {first:.6g} -> {last:.6g} "
          f"(limit {ratio} of the first); launches: graphed trainer "
          f"{ {k: v for k, v in setup_g.items() if v} }, loop none; eager "
          f"loop { {k: v for k, v in loop_e.items() if v} }; trainer with "
          f"capture {setup_s:.3f} s; ms a step eager "
          f"{loop_s_e * 1e3 / steps:.4f}, graphed "
          f"{loop_s_g * 1e3 / steps:.4f} ({loop_s_e / loop_s_g:.2f}x); "
          f"device kernels a step eager {prof_e[0]:.1f}, graphed "
          f"{prof_g[0]:.1f}; device busy a step {prof_e[1]:.4f} / "
          f"{prof_g[1]:.4f} ms, busy share {prof_e[2]:.3f} / "
          f"{prof_g[2]:.3f}; largest device items graphed: {prof_g[3]}; "
          f"peak memory above the allocated before: eager "
          f"{peak_e / 2**20:.1f} MiB, graphed {peak_g / 2**20:.1f} MiB; the "
          f"graph's pool holds {made[0].pool_bytes() / 2**20:.1f} MiB; "
          f"{time.perf_counter() - t_check:.1f} s ({card})")
    return setup_g


def _graphed_parallel_check(device, card, weights, scenes, configs):
    """Phase 20: the compiled steps of the paths the reference compiles and
    phase 19 leaves out, each eager and as CUDA-graph replays through
    :func:`_graph_pair` (with a replay on other inputs: the vertices
    scaled by 1.02, which moves no pixel of a homogeneous scene, the colors
    reversed; the parameters and leaves of the dry run and the sheet scaled
    by 1.005 to 1.02): ``rasterise_sharded`` with four local slabs on the
    bench sphere (dense, CSR and packed) and on the 99,904-face sphere
    (CSR); the overlapped step, four slabs at k = 2 and 4; face sharding
    over four members, dense on the bench sphere and packed on the
    99,904-face sphere; the dry run's training loss; then
    ``dryrun_multichip(4)`` graphed, whose five Adam steps' loss must fall
    and whose variants give DRYRUN_LOSS +- 1e-3, against the eager dry run
    (losses within TOL_DEFERRED, the variants' largest vertex gradients
    within TOL_GRAD), and whose graphs launch each kernel ``WARMUP + 1``
    times of the eager dry run's one step; demos 3 and 4
    (:func:`_graphed_demo_check`); the sheet's five configs' gradient steps. ``scenes``: "bench" and
    "big", each (background, clip vertices, colors, faces); ``configs``:
    the caps by name. Returns the launch counts of the phase."""
    import functools

    import bench_configs_torch
    from dirt_tpu_torch import entry
    from dirt_tpu_torch.parallel.face_sharding import rasterise_face_sharded
    from dirt_tpu_torch.parallel.group import LocalGroup
    from dirt_tpu_torch.parallel.sharding import rasterise_sharded
    from dirt_tpu_torch.utils.graphstep import WARMUP, value_and_grad

    start = time.perf_counter()
    launches = dict.fromkeys(COUNTED, 0)

    def add(counts):
        for k in COUNTED:
            launches[k] += counts[k]

    def sharded(bg, verts, cols, *, faces, config, kwargs):
        return rasterise_sharded(bg, verts, cols, faces, LocalGroup(4),
                                 config=config, with_aux=True, **kwargs)

    def face_sharded(bg, verts, cols, *, faces, config):
        return rasterise_face_sharded(bg, verts, cols, faces, LocalGroup(4),
                                      config=config, with_aux=True)

    n_big = scenes["big"][3].shape[0]
    cases = [
        (f"sharded bench sphere {SIZE}^2 dense, 4 slabs", "bench",
         functools.partial(sharded, config=configs["dense"], kwargs={}),
         SHARDED_PATH["dense"], 4),
        (f"sharded bench sphere {SIZE}^2 csr, 4 slabs", "bench",
         functools.partial(sharded, config=configs["csr"], kwargs={}),
         SHARDED_PATH["csr"], 4),
        (f"sharded bench sphere {SIZE}^2 packed, 4 slabs", "bench",
         functools.partial(sharded, config=configs["packed"], kwargs={}),
         SHARDED_PATH["packed"], 4),
        (f"sharded {n_big}-face sphere {SIZE}^2 csr, 4 slabs", "big",
         functools.partial(sharded, config=configs["big csr"], kwargs={}),
         SHARDED_PATH["csr"], 4),
        *((f"overlap bench sphere {SIZE}^2 packed, 4 slabs, k={k}", "bench",
           functools.partial(sharded, config=configs["packed"],
                             kwargs=dict(overlap_chunks=k)),
           SHARDED_PATH["packed"], 4 * k) for k in (2, 4)),
        (f"face-sharded bench sphere {SIZE}^2 dense, 4 members", "bench",
         functools.partial(face_sharded, config=configs["dense"]),
         ("raster_fwd_dense",), 4),
        (f"face-sharded {n_big}-face sphere {SIZE}^2 packed, 4 members",
         "big", functools.partial(face_sharded, config=configs["big packed"]),
         ("raster_fwd_packed",), 4),
    ]
    # The last item: setup_vjp's launches a step, one a slab's, a chunk's or
    # a member's backward.
    for tag, which, render, kernels, vjps in cases:
        bg, verts, cols, faces = scenes[which]
        add(_graph_pair(f"20 {tag}",
                        render_step(functools.partial(render, faces=faces),
                                    weights),
                        (bg, verts, cols), kernels, card, exact=3,
                        tol=TOL_GRAD, moved=(bg, verts * 1.02, cols.flip(0)),
                        vjps=vjps))

    train_loss, (params, poses), _ = entry.dryrun_train_loss(4, device)
    add(_graph_pair("20 dryrun_multichip(4) train step, data=2 x tiles=2",
                    value_and_grad(train_loss), (params, poses),
                    SHARDED_PATH["packed"], card, exact=0, tol=TOL_DEFERRED,
                    moved=(params + 0.005, poses), vjps=DRYRUN_STEP_VJPS))
    _reset_launch_counts()
    entry.dryrun_multichip(4, device, steps=1, graphed=False)
    _sync()
    once = _launch_counts()
    dry_e = entry.dryrun_multichip(4, device, steps=5, graphed=False)
    _sync()
    _reset_launch_counts()
    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(4, device, steps=5)
    _sync()
    dry_s = time.perf_counter() - t0
    counts = _launch_counts()
    add(counts)
    loss_errs = [abs(g - e) / abs(e) for g, e in zip(dry["losses"],
                                                     dry_e["losses"])]
    keys = ("loss_two_level", "loss_overlap", "loss_face_sharded")
    grad_errs = [abs(dry[k] - dry_e[k]) / dry_e[k] for k in
                 ("grad_two_level", "grad_overlap", "grad_face_sharded")]
    if (counts != {k: (WARMUP + 1) * n for k, n in once.items()}
            or not dry["losses"][-1] < dry["losses"][0]
            or not all(abs(dry[key] - DRYRUN_LOSS) <= 1e-3 for key in keys)
            or not all(e <= TOL_DEFERRED for e in loss_errs)
            or not all(e <= TOL_GRAD for e in grad_errs)):
        raise RuntimeError(f"[20 dryrun_multichip(4) graphed] launches "
                           f"{counts} (want {WARMUP + 1} x {once}), losses "
                           f"{dry['losses']} (eager {dry_e['losses']}), "
                           f"variants {[dry[k] for k in keys]} (want "
                           f"{DRYRUN_LOSS} +- 1e-3), their largest vertex "
                           f"gradients off the eager ones by {grad_errs}")
    print(f"[20 dryrun_multichip(4) graphed] 5 Adam steps as replays: loss "
          f"{' '.join(f'{v:.6g}' for v in dry['losses'])} (eager "
          f"{' '.join(f'{v:.6g}' for v in dry_e['losses'])}; max |diff| / "
          f"|eager| {max(loss_errs):.3g}, limit {TOL_DEFERRED:g}); variants "
          f"{' '.join(f'{dry[k]:.6g}' for k in keys)} ({DRYRUN_LOSS} +- "
          f"1e-3), their largest vertex gradients off the eager ones by "
          f"{' '.join(f'{e:.3g}' for e in grad_errs)} (limit {TOL_GRAD:g}); "
          f"launches {counts} = {WARMUP + 1} x the eager one-step "
          f"dry run's; {dry_s:.2f} s with the captures ({card})")

    for n in DEMO_LOOPS:
        add(_graphed_demo_check(n, device, card))

    dense = ("raster_fwd_dense", "packed_prologue", "fused_bwd")
    for n, make in enumerate(bench_configs_torch.CONFIGS, 1):
        config = make(device)
        add(_graph_pair(f"20 sheet {config.name}",
                        value_and_grad(config.loss), config.leaves,
                        KERNELS[:3] if n == 5 else dense, card, exact=0,
                        tol=TOL_GRAD if n < 3 else TOL_DEFERRED,
                        moved=tuple(t * 1.01 for t in config.leaves)))
    print(f"[20 compiled parallel steps, dry run, demos 3-4, sheet] launches "
          f"{launches}; {time.perf_counter() - start:.1f} s ({card})")
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import dirt_tpu_torch
    from dirt_tpu_torch.ops import _build, raster
    from dirt_tpu_torch.ops.triangle_setup import screen_from_clip

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    laps = _Laps()
    # --- 1. versions and card -------------------------------------------
    card = card_line()
    print(f"[1 versions] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices "
          f"{torch.cuda.device_count()}")
    print(card)

    # --- 2. build ---------------------------------------------------------
    start = time.perf_counter()
    built = COUNTED
    nvcc_s = _build.build(built)
    for kernel_name in built:
        _build.load(kernel_name)
    build_s = time.perf_counter() - start
    print(f"[2 build] {len(built)} kernels built in parallel + loaded "
          f"in {build_s:.2f} s")
    for kernel_name in built:
        ptxas = [ln.strip() for ln in _build.build_log(kernel_name)
                 .splitlines() if "registers" in ln or "spill" in ln]
        built = (f"nvcc done after {nvcc_s[kernel_name]:.2f} s"
                 if kernel_name in nvcc_s else "already built")
        print(f"[2 build] {kernel_name} "
              f"({_build.library_path(kernel_name).name}): {built}; "
              + " | ".join(ptxas))
    _sync()

    laps.lap()
    # --- 3. kernels vs plain versions at the main path's shapes -----------
    verts_obj, clip, colors, faces, background, weights = _bench_scene(
        device)
    config = dirt_tpu_torch.suggest_raster_config(
        clip, faces, SIZE, SIZE, clip=False
    )
    face_verts = screen_from_clip(clip, SIZE, SIZE)[faces]
    record = _check_packed_kernels("3 kernel vs plain", face_verts,
                                   colors[faces], background, weights,
                                   config, card)

    laps.lap()
    # --- 4. main path: forward and backward -------------------------------
    configs = {
        c: dirt_tpu_torch.suggest_raster_config(
            clip, faces, SIZE, SIZE, clip=c)
        for c in (False, True)
    }
    _reset_launch_counts()
    runs = {
        c: _grads(dirt_tpu_torch.rasterise_with_aux, background, clip,
                  colors, faces, weights, configs[c], c)
        for c in (False, True)
    }
    _sync()
    launches = _launch_counts()
    _need_launches("packed main path", launches, KERNELS[:3], backwards=2)
    if launches["raster_fwd_packed"] != 2:
        raise RuntimeError(f"packed main path: want 2 packed forwards, one "
                           f"a step, and their binnings' "
                           f"{2 * SCANS_PER_BINNING} {SCAN} launches, got "
                           f"{launches}")

    covered = {}
    for c, ((pixels, fid, zbuf, overflow), grads) in runs.items():
        if bool(overflow):
            raise RuntimeError(f"overflow flag set (clip={c}, {configs[c]})")
        if (tuple(pixels.shape) != (SIZE, SIZE, CHANNELS)
                or tuple(fid.shape) != (SIZE, SIZE)
                or tuple(zbuf.shape) != (SIZE, SIZE)):
            raise RuntimeError(f"bad output shapes (clip={c})")
        hit = fid >= 0
        covered[c] = int(hit.sum())
        if not bool(torch.isfinite(pixels).all()):
            raise RuntimeError(f"non-finite pixels (clip={c})")
        if int(fid.max()) >= faces.shape[0]:
            raise RuntimeError(f"face id out of range (clip={c})")
        if not bool(((zbuf[hit] >= -1) & (zbuf[hit] <= 1)).all()):
            raise RuntimeError(f"covered depth outside [-1, 1] (clip={c})")
        if not bool(((pixels >= -1e-5) & (pixels <= 1 + 1e-5)).all()):
            raise RuntimeError(f"colors outside [0, 1] (clip={c})")
        d_v, d_c, d_bg = grads
        for label, g in (("vertices", d_v), ("colors", d_c),
                         ("background", d_bg)):
            if g is None or not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"{label} gradient missing or not finite "
                                   f"(clip={c})")
        if not (bool(d_v.abs().sum() > 0) and bool(d_c.abs().sum() > 0)):
            raise RuntimeError(f"zero vertex or color gradient (clip={c})")
        if not (torch.equal(d_bg[~hit], weights[~hit])
                and bool((d_bg[hit] == 0).all())):
            raise RuntimeError(f"d_background is not w off the mesh and 0 "
                               f"on it (clip={c})")
    if covered[False] == 0 or covered[False] != covered[True]:
        raise RuntimeError(f"covered pixels differ or are zero: {covered}")
    if not torch.equal(runs[False][0][1], runs[True][0][1]):
        raise RuntimeError("fid differs between clip=False and clip=True")

    # The same path with every kernel replaced by its plain version: the
    # same image and gradients within TOL_GRAD, and no kernel launch.
    plain_patches = _plain_patches()

    def fwd(c):
        return dirt_tpu_torch.rasterise_with_aux(
            background, clip, colors, faces, config=configs[c], clip=c)

    def step(c):
        return _grads(dirt_tpu_torch.rasterise_with_aux, background, clip,
                      colors, faces, weights, configs[c], c)

    times = {}
    grad_err = {}
    for patch in plain_patches:
        patch.start()
    counts = _launch_counts()
    for c in (False, True):
        (pix_pl, _, _, _), grads_pl = step(c)
        _sync()
        if not torch.allclose(pix_pl, runs[c][0][0], **TOL):
            raise RuntimeError(f"kernel and plain path images disagree "
                               f"(clip={c})")
        grad_err[c] = []
        for label, g_k, g_p in zip(("vertices", "colors", "background"),
                                   runs[c][1], grads_pl):
            grad_err[c].append(_rel_err(g_k, g_p))
            if not grad_err[c][-1] <= TOL_GRAD:
                raise RuntimeError(f"kernel and plain path {label} gradients "
                                   f"disagree (clip={c}): max |diff| / max "
                                   f"|grad| {grad_err[c][-1]:.3g}")
        times[("plain fwd", c)] = _median_ms(lambda: fwd(c))
        times[("plain step", c)] = _median_ms(lambda: step(c), runs=5,
                                              warmup=1)
    if counts != _launch_counts():
        raise RuntimeError("plain path launched a kernel")
    for patch in plain_patches:
        patch.stop()

    for c in (False, True):
        times[("fwd", c)] = _median_ms(lambda: fwd(c))
        times[("step", c)] = _median_ms(lambda: step(c))
        # The backward alone, on one retained graph; every repeat must give
        # the same gradients (the kernels are deterministic, and the
        # residuals survive retain_graph).
        verts = clip.clone().requires_grad_()
        cols = colors.clone().requires_grad_()
        bg = background.clone().requires_grad_()
        loss = (dirt_tpu_torch.rasterise(
            bg, verts, cols, faces, config=configs[c], clip=c)
            * weights).sum()
        first = torch.autograd.grad(loss, (verts, cols, bg),
                                    retain_graph=True)
        times[("bwd", c)] = _median_ms(lambda: torch.autograd.grad(
            loss, (verts, cols, bg), retain_graph=True))
        again = torch.autograd.grad(loss, (verts, cols, bg),
                                    retain_graph=True)
        if not all(_rel_err(a, b) <= TOL_GRAD for a, b in zip(first, again)):
            raise RuntimeError(f"repeated backward differs (clip={c})")
    prep_ms = _median_ms(lambda: raster.prepare_packed(
        face_verts, colors[faces], background, config))
    _sync()
    for c in (False, True):
        cf = configs[c]
        print(f"[4 main path clip={c}] caps tile_h={cf.tile_h} "
              f"expand_cap={cf.expand_cap} budget={cf.budget} "
              f"pool_cap={cf.pool_cap} work_cap={cf.work_cap} "
              f"clip_cap={cf.clip_cap}; overflow False; covered {covered[c]}"
              f" px; gradients finite, d_background = w off the mesh; "
              f"kernel vs plain path max |grad diff| / max |grad|: vertices "
              f"{grad_err[c][0]:.3g} colors {grad_err[c][1]:.3g} background "
              f"{grad_err[c][2]:.3g} (limit {TOL_GRAD:g})")
        step_ms = times[("step", c)]
        print(f"[4 main path clip={c}] forward {times[('fwd', c)]:.4f} ms, "
              f"fwd+bwd {step_ms:.4f} ms ({SIZE * SIZE / 1e6 / step_ms * 1e3:.2f}"
              f" Mpix/s fwd+bwd), backward alone {times[('bwd', c)]:.4f} ms "
              f"(kernel path, median of {RUNS}); plain path: forward "
              f"{times[('plain fwd', c)]:.4f} ms (median of {RUNS}), fwd+bwd "
              f"{times[('plain step', c)]:.4f} ms (median of 5) ({card})")
    print(f"[4 main path] kernel launches {launches}; clip=False stages: "
          f"setup+binning+table {prep_ms:.4f} ms, raster kernel "
          f"{record['raster_fwd_packed']['ms']:.4f} ms, prologue kernel "
          f"{record['packed_prologue']['ms']:.4f} ms, backward kernel "
          f"{record['packed_bwd']['ms']:.4f} ms ({card})")

    laps.lap()
    # --- 5. a few training steps ------------------------------------------
    target = dirt_tpu_torch.rasterise(
        background, clip, colors, faces, config=configs[False], clip=False)
    rot = torch.tensor([0.4, 0.3, 0.0], device=device)
    d_rot = torch.tensor([0.03, -0.02, 0.02], device=device,
                         requires_grad=True)
    d_col = (0.15 * torch.randn(colors.shape, generator=torch.Generator(
        device).manual_seed(2), device=device)).requires_grad_()
    opt = torch.optim.Adam([d_rot, d_col], lr=0.01)
    losses = []
    start = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        opt.zero_grad()
        image = dirt_tpu_torch.rasterise(
            background, _clip_verts(verts_obj, rot + d_rot, device),
            colors + d_col, faces, config=configs[False], clip=False)
        loss = ((image - target) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    train_s = time.perf_counter() - start
    print(f"[5 train] {TRAIN_STEPS} Adam steps (lr 0.01) on pose + colors at "
          f"{SIZE}^2: L2 loss {losses[0]:.6g} -> {losses[-1]:.6g} "
          f"(all: {', '.join(f'{v:.4g}' for v in losses)}); {train_s:.2f} s "
          f"({card})")
    if not losses[-1] < losses[0] or not np.isfinite(losses).all():
        raise RuntimeError("training loss did not fall")

    laps.lap()
    # --- 6. the packed kernels at the G-buffer's 9 channels ----------------
    colors9 = _rand(3, clip.shape[0], 9, device=device)
    _check_packed_kernels(
        "6 packed kernels C=9", face_verts, colors9[faces],
        torch.zeros((SIZE, SIZE, 9), device=device),
        _rand(4, SIZE, SIZE, 9, device=device), config, card, plain_runs=3)

    laps.lap()
    # --- 7. the dense kernels vs plain versions ------------------------------
    from dirt_tpu_torch import entry
    from dirt_tpu_torch.core import mesh

    # Config 4's and the flagship step's own shapes: the faces each path's
    # render hands the raster op (2,208 faces + the near-plane clip's slots),
    # taken from one run of the path itself.
    c4_loss, c4_leaves = config4_loss(device)
    with torch.no_grad():
        c4_fv, c4_fa, _, c4_cfg = _raster_inputs(lambda: c4_loss(*c4_leaves))
    _check_tile_kernels(
        f"7 dense kernels config4 512^2 ({c4_fv.shape[0]} face slots of the "
        f"path's own render)", "dense", c4_fv, c4_fa, 512, c4_cfg,
        _rand(1, 512, 512, 3, device=device), card)
    dense_big = dirt_tpu_torch.suggest_raster_config(
        clip, faces, SIZE, SIZE,
        config=dirt_tpu_torch.RasterConfig(engine="dense"), clip=False)
    _check_tile_kernels(
        "7 dense kernels bench sphere 1024^2", "dense", face_verts, colors[faces],
        SIZE, dense_big, weights, card)
    step_fn, (e_verts, e_pose) = entry.entry()
    with torch.no_grad():
        e_fv, e_fa, _, e_cfg = _raster_inputs(lambda: step_fn(e_verts, e_pose))
    record.update(_check_tile_kernels(
        f"7 dense kernels flagship G-buffer 256^2 ({e_fv.shape[0]} face "
        f"slots of the step's own render)", "dense", e_fv, e_fa, 256, e_cfg,
        _rand(5, 256, 256, 9, device=device), card))

    laps.lap()
    # --- 8. the deferred pipeline at full width -------------------------------
    pose = torch.tensor([0.4, 0.3, 0.0], device=device)
    e_obj, e_faces, e_uvs, e_tex, e_proj = entry.deferred_scene(device=device)
    c5_render, c5_leaves = config5_render(device)

    for label, render, leaves, size, need in (
        ("8 deferred config5 1024^2 packed", c5_render, c5_leaves, SIZE,
         KERNELS[:3]),
        ("8 deferred flagship 256^2 dense",
         lambda v, p, **kw: entry.deferred_render(
             v, p, e_faces, e_uvs, e_tex, e_proj, 256, None, **kw),
         (e_obj, pose), 256,
         ("raster_fwd_dense", "packed_prologue", "fused_bwd")),
    ):
        with torch.no_grad():
            image, gb = render(*leaves, with_gbuffer=True)
        hit = int((gb["fid"] >= 0).sum())
        if (bool(gb["overflow"]) or tuple(image.shape) != (size, size, 3)
                or not bool(torch.isfinite(image).all()) or not hit
                or not bool((image[gb["fid"] < 0] == 0).all())):
            raise RuntimeError(f"[{label}] bad render: overflow "
                               f"{bool(gb['overflow'])}, covered {hit}")
        w = _rand(1, size, size, 3, device=device)
        _, counts = _step_check(
            label, lambda v, p: (render(v, p) * w).sum(), leaves, card)
        _need_launches(label, counts, need)
        print(f"[{label}] overflow False, covered {hit} px, G-buffer "
              f"channels {sum(gb[k].shape[-1] for k in ('position', 'normal', 'uv', 'mask'))}")
        if "dense" in label:
            launches.update({k: counts[k] for k in ("raster_fwd_dense",
                                                    "fused_bwd")})

    # The flagship entry point itself, and Adam on its loss.
    first, counts = _step_check("8 flagship entry()", step_fn,
                                (e_verts, e_pose), card, plain=False)
    _need_launches("flagship entry()", counts,
                   ("raster_fwd_dense", "packed_prologue", "fused_bwd"))
    e_verts = e_verts.clone().requires_grad_()
    e_pose = e_pose.clone().requires_grad_()
    opt = torch.optim.Adam([e_verts, e_pose], lr=0.01)
    losses = []
    start = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        opt.zero_grad()
        loss = step_fn(e_verts, e_pose)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    train_s = time.perf_counter() - start
    print(f"[8 flagship train] {TRAIN_STEPS} Adam steps (lr 0.01) on "
          f"vertices + pose at 256^2: loss {losses[0]:.6g} -> "
          f"{losses[-1]:.6g} (all: {', '.join(f'{v:.4g}' for v in losses)}); "
          f"{train_s:.2f} s ({card})")
    if (not losses[-1] < losses[0] or not np.isfinite(losses).all()
            or abs(losses[0] - first) > 1e-5 * first):
        raise RuntimeError("flagship loss did not fall, or its first value "
                           "is not the step's")

    laps.lap()
    # --- 9. configs 1-4 of bench_configs_torch.py ---------------------------
    for make in bench_configs_torch.CONFIGS[:4]:
        sheet = make(device)
        label = f"9 {sheet.name}"
        _, counts = _step_check(label, sheet.loss, sheet.leaves, card)
        _need_launches(label, counts,
                       ("raster_fwd_dense", "packed_prologue", "fused_bwd"))

    laps.lap()
    # --- 10. the streaming kernels vs plain versions --------------------------
    big_loss, (big_bg, big_clip, big_colors), (big_faces, big_cfg) = \
        big_sphere_step(device)
    n_big = big_faces.shape[0]
    with torch.no_grad():
        b_fv, b_fa, _, b_cfg = _raster_inputs(
            lambda: big_loss(big_bg, big_clip, big_colors))
    record.update(_check_tile_kernels(
        f"10 csr kernels {n_big}-face sphere 1024^2 C=3 ({b_fv.shape[0]} face "
        f"slots of the default API's own render)", "csr", b_fv, b_fa, SIZE,
        b_cfg, weights, card, plain_runs=1))
    big_colors9 = _rand(3, big_clip.shape[0], 9, device=device)
    with torch.no_grad():
        b9_fv, b9_fa, _, b9_cfg = _raster_inputs(
            lambda: dirt_tpu_torch.rasterise(
                torch.zeros((SIZE, SIZE, 9), device=device), big_clip,
                big_colors9, big_faces, config=big_cfg))
    _check_tile_kernels(
        f"10 csr kernels {n_big}-face sphere 1024^2 C=9", "csr", b9_fv, b9_fa,
        SIZE, b9_cfg, _rand(4, SIZE, SIZE, 9, device=device), card,
        plain_runs=1)
    stream_cfg = dirt_tpu_torch.suggest_raster_config(
        clip, faces, SIZE, SIZE,
        config=dirt_tpu_torch.RasterConfig(streaming=True), clip=False)
    _check_tile_kernels(
        "10 csr kernels bench sphere 1024^2 streaming=True", "csr",
        face_verts, colors[faces], SIZE, stream_cfg, weights, card)
    del b_fv, b_fa, b9_fv, b9_fa

    laps.lap()
    # --- 11. the default API above the streaming threshold ---------------------
    big_leaves = (big_bg, big_clip, big_colors)
    packed_cfg = dirt_tpu_torch.suggest_raster_config(
        big_clip, big_faces, SIZE, SIZE,
        config=dirt_tpu_torch.RasterConfig(engine="packed"))

    def big_render(config):
        return dirt_tpu_torch.rasterise_with_aux(
            big_bg, big_clip, big_colors, big_faces, config=config)

    def big_step(config):
        return _grads(dirt_tpu_torch.rasterise_with_aux, big_bg, big_clip,
                      big_colors, big_faces, weights, config, True)

    _reset_launch_counts()
    (pix_s, fid_s, z_s, ovf_s), grads_s = big_step(big_cfg)
    _sync()
    counts = _launch_counts()
    _need_launches("default API csr path", counts, CSR_PATH)
    others = [k for k in KERNELS if k not in CSR_PATH and counts[k]]
    if others:
        raise RuntimeError(f"the csr path launched other engines' kernels: "
                           f"{others} of {counts}")
    launches.update({k: counts[k] for k in ("raster_fwd_csr",
                                            "fused_bwd_csr")})
    hit = fid_s >= 0
    covered_big = int(hit.sum())
    if (bool(ovf_s) or tuple(pix_s.shape) != (SIZE, SIZE, CHANNELS)
            or not covered_big or int(fid_s.max()) >= n_big
            or not bool(torch.isfinite(pix_s).all())
            or not bool(((z_s[hit] >= -1) & (z_s[hit] <= 1)).all())):
        raise RuntimeError(f"[11] bad render: overflow {bool(ovf_s)}, "
                           f"covered {covered_big}, {big_cfg}")
    d_v, d_c, d_bg = grads_s
    for label, g in (("vertices", d_v), ("colors", d_c), ("background", d_bg)):
        if g is None or not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"[11] {label} gradient missing or not finite")
    if not (bool(d_v.abs().sum() > 0) and bool(d_c.abs().sum() > 0)):
        raise RuntimeError("[11] zero vertex or color gradient")
    if not (torch.equal(d_bg[~hit], weights[~hit])
            and bool((d_bg[hit] == 0).all())):
        raise RuntimeError("[11] d_background is not w off the mesh and 0 on "
                           "it")

    # The same step with every kernel replaced by its plain version.
    plain_patches = _plain_patches()
    for patch in plain_patches:
        patch.start()
    before = _launch_counts()
    start = time.perf_counter()
    (pix_pl, fid_pl, _, _), grads_pl = big_step(big_cfg)
    _sync()
    plain_step_s = time.perf_counter() - start
    if before != _launch_counts():
        raise RuntimeError("[11] plain path launched a kernel")
    for patch in plain_patches:
        patch.stop()
    if not (torch.equal(fid_pl, fid_s)
            and torch.allclose(pix_pl, pix_s, **TOL)):
        raise RuntimeError("[11] kernel and plain path images disagree")
    err_plain = [_rel_err(g_k, g_p) for g_k, g_p in zip(grads_s, grads_pl)]
    if not all(e <= TOL_GRAD for e in err_plain):
        raise RuntimeError(f"[11] kernel and plain path gradients disagree: "
                           f"{err_plain}")
    del pix_pl, fid_pl, grads_pl

    # The packed engine on the same scene, under its own suggested caps.
    (pix_k, fid_k, _, ovf_k), grads_k = big_step(packed_cfg)
    _sync()
    if bool(ovf_k):
        raise RuntimeError(f"[11] packed engine overflowed: {packed_cfg}")
    fid_diff = int((fid_k != fid_s).sum())
    err_packed = [_rel_err(g_s, g_k) for g_s, g_k in zip(grads_s, grads_k)]
    if fid_diff > TOL_ENGINES * covered_big \
            or not all(e <= TOL_ENGINES for e in err_packed):
        raise RuntimeError(f"[11] csr and packed engines disagree: "
                           f"{fid_diff} fids of {covered_big} covered, "
                           f"gradients {err_packed}")

    big_times = {}
    for label, config in (("csr", big_cfg), ("packed", packed_cfg)):
        with torch.no_grad():
            big_times[label, "fwd"] = _median_ms(lambda: big_render(config))
        big_times[label, "step"] = _median_ms(lambda: big_step(config))
        leaves = [t.clone().requires_grad_() for t in big_leaves]
        loss = (dirt_tpu_torch.rasterise(
            leaves[0], leaves[1], leaves[2], big_faces, config=config)
            * weights).sum()
        big_times[label, "bwd"] = _median_ms(lambda: torch.autograd.grad(
            loss, leaves, retain_graph=True))
        del loss, leaves
    with torch.no_grad():
        s_fv, s_fa, s_bg, s_cfg = _raster_inputs(lambda: big_render(big_cfg))
    prep_ms = _median_ms(lambda: raster.prepare_csr(s_fv, s_fa, s_bg, s_cfg))
    print(f"[11 default API {n_big} faces {SIZE}^2] caps tile_h="
          f"{big_cfg.tile_h} bin_cap={big_cfg.bin_cap} expand_cap="
          f"{big_cfg.expand_cap} clip_cap={big_cfg.clip_cap} streaming="
          f"{big_cfg.streaming} -> engine csr; overflow False; covered "
          f"{covered_big} px; gradients finite, d_background = w off the "
          f"mesh; launches {counts}; kernel vs plain path max |grad diff| / "
          f"max |grad|: vertices {err_plain[0]:.3g} colors "
          f"{err_plain[1]:.3g} background {err_plain[2]:.3g} (limit "
          f"{TOL_GRAD:g}; plain path fwd+bwd {plain_step_s:.2f} s, one run); "
          f"csr vs packed engine: {fid_diff} differing fid pixels (limit "
          f"{TOL_ENGINES:g} of covered), max |grad diff| / max |grad| "
          f"vertices {err_packed[0]:.3g} colors {err_packed[1]:.3g} "
          f"background {err_packed[2]:.3g} (limit {TOL_ENGINES:g})")
    for label in ("csr", "packed"):
        step_ms = big_times[label, "step"]
        print(f"[11 default API {n_big} faces {SIZE}^2] {label} engine: "
              f"forward {big_times[label, 'fwd']:.4f} ms, fwd+bwd "
              f"{step_ms:.4f} ms "
              f"({SIZE * SIZE / 1e6 / step_ms * 1e3:.2f} Mpix/s fwd+bwd), "
              f"backward alone {big_times[label, 'bwd']:.4f} ms (medians of "
              f"{RUNS}) ({card})")
    print(f"[11 default API {n_big} faces {SIZE}^2] csr stages: "
          f"setup+binning+table {prep_ms:.4f} ms, raster kernel "
          f"{record['raster_fwd_csr']['ms']:.4f} ms, backward kernel "
          f"{record['fused_bwd_csr']['ms']:.4f} ms ({card})")

    quad_v, quad_f = mesh.unit_quad()
    quad = dirt_tpu_torch.rasterise(
        None, torch.cat([torch.as_tensor(quad_v, device=device) * 2.0,
                         torch.ones((4, 1), device=device)], dim=1),
        torch.ones((4, 1), device=device),
        torch.as_tensor(quad_f.astype(np.int64), device=device),
        height=64, width=256, channels=1,
        config=dirt_tpu_torch.RasterConfig(streaming=True))
    print(f"[11 quad 64x256 streaming=True] two faces over every tile: "
          f"minimum pixel {float(quad.min()):.6f}")
    if not float(quad.min()) > 0.99:
        raise RuntimeError("[11] the all-tiles quad is not fully covered")

    laps.lap()
    # --- 12. the scatter kernels vs plain versions -----------------------------
    from dirt_tpu_torch.parallel.group import DistGroup, LocalGroup
    from dirt_tpu_torch.parallel.sharding import rasterise_sharded

    def one_slab_step(scene, config, w):
        return lambda: _grads(
            lambda bg, v, c, f, config, clip: rasterise_sharded(
                bg, v, c, f, LocalGroup(1), config=config, with_aux=True),
            scene[0], scene[1], scene[2], scene[3], w, config, False)

    bench3 = (background, clip, colors, faces)
    bench9 = (torch.zeros((SIZE, SIZE, 9), device=device), clip, colors9,
              faces)
    weights9 = _rand(4, SIZE, SIZE, 9, device=device)
    big_stream_cfg = dirt_tpu_torch.suggest_raster_config(
        big_clip, big_faces, SIZE, SIZE,
        config=dirt_tpu_torch.RasterConfig(streaming=True), clip=False)
    big3 = (big_bg, big_clip, big_colors, big_faces)
    record.update(_check_scatter_kernel(
        "12 scatter bench sphere 1024^2 dense C=3", "scatter_faces",
        one_slab_step(bench3, dense_big, weights), card))
    _check_scatter_kernel(
        "12 scatter bench sphere 1024^2 dense C=9", "scatter_faces",
        one_slab_step(bench9, dense_big, weights9), card)
    _check_scatter_kernel(
        "12 scatter bench sphere 1024^2 streaming=True C=3",
        "scatter_faces_csr", one_slab_step(bench3, stream_cfg, weights), card)
    _check_scatter_kernel(
        "12 scatter bench sphere 1024^2 streaming=True C=9",
        "scatter_faces_csr", one_slab_step(bench9, stream_cfg, weights9),
        card)
    record.update(_check_scatter_kernel(
        f"12 scatter {n_big}-face sphere 1024^2 csr C=3", "scatter_faces_csr",
        one_slab_step(big3, big_stream_cfg, weights), card))
    colors16 = _rand(5, clip.shape[0], 16, device=device)
    background16 = torch.zeros((SIZE, SIZE, 16), device=device)
    weights16 = _rand(6, SIZE, SIZE, 16, device=device)
    bench16 = (background16, clip, colors16, faces)
    _check_scatter_kernel(
        "12 scatter bench sphere 1024^2 dense C=16", "scatter_faces",
        one_slab_step(bench16, dense_big, weights16), card)
    _check_scatter_kernel(
        "12 scatter bench sphere 1024^2 streaming=True C=16",
        "scatter_faces_csr", one_slab_step(bench16, stream_cfg, weights16),
        card)
    _check_packed_kernels(
        "12 packed kernels C=16", face_verts, colors16[faces], background16,
        weights16, configs[False], card, runs=10, plain_runs=1)
    record.update(_check_swap_kernel(
        "12 layout swap bench sphere 1024^2 packed C=3",
        one_slab_step(bench3, configs[False], weights), card))
    _check_swap_kernel(
        "12 layout swap bench sphere 1024^2 packed C=9",
        one_slab_step(bench9, configs[False], weights9), card)

    laps.lap()
    # --- 13. the row-sharded renderer at full width -----------------------------
    counts = _sharded_check("13 sharded bench sphere dense", "dense", bench3,
                            dense_big, weights, card)
    launches["scatter_faces"] = counts["scatter_faces"]
    _sharded_check("13 sharded bench sphere streaming=True", "csr", bench3,
                   stream_cfg, weights, card)
    counts = _sharded_check("13 sharded bench sphere packed", "packed",
                            bench3, configs[False], weights, card)
    launches["subtile_swap"] = counts["subtile_swap"]
    counts = _sharded_check(f"13 sharded {n_big}-face sphere csr", "csr", big3,
                            big_stream_cfg, weights, card)
    launches["scatter_faces_csr"] = counts["scatter_faces_csr"]

    _reset_launch_counts()
    start = time.perf_counter()
    dry = entry.dryrun_multichip(4, device, steps=5, graphed=False)
    _sync()
    counts = _launch_counts()
    print(f"[13 dryrun_multichip(4)] data=2 x tiles=2 training step, 5 Adam "
          f"steps: loss {' '.join(f'{v:.6g}' for v in dry['losses'])}; "
          f"two-level render loss {dry['loss_two_level']:.6g}, max |d verts| "
          f"{dry['grad_two_level']:.4g}; overlap_chunks=2 loss "
          f"{dry['loss_overlap']:.6g}, max |d verts| "
          f"{dry['grad_overlap']:.4g}; face-sharded loss "
          f"{dry['loss_face_sharded']:.6g}, max |d verts| "
          f"{dry['grad_face_sharded']:.4g} (both {DRYRUN_LOSS} +- 1e-3); "
          f"launches {counts}; {time.perf_counter() - start:.2f} s ({card})")
    if (not dry["losses"][-1] < dry["losses"][0]
            or not np.isfinite(dry["losses"]).all()
            or not dry["grad_two_level"] > 0):
        raise RuntimeError("[13] dryrun_multichip: the loss did not fall")
    if not all(abs(dry[key] - DRYRUN_LOSS) <= 1e-3
               for key in ("loss_overlap", "loss_face_sharded")):
        raise RuntimeError(f"[13] dryrun_multichip: the overlap and "
                           f"face-sharded variants' losses are not "
                           f"{DRYRUN_LOSS}: {dry}")
    _need_launches("dryrun_multichip", counts,
                   ("raster_fwd_packed", "subtile_swap", "packed_bwd",
                    "raster_fwd_dense", "scatter_faces"),
                   vjps=5 * DRYRUN_STEP_VJPS + DRYRUN_VARIANT_VJPS)

    # One step through a torch.distributed group of one rank (NCCL).
    def grads_of(group):
        return _grads(
            lambda bg, v, c, f, config, clip: rasterise_sharded(
                bg, v, c, f, group, config=config, with_aux=True),
            background, clip, colors, faces, weights, dense_big, False)[1]

    want = grads_of(LocalGroup(1))
    # Phase 15's paths through the same group (one NCCL group a process).
    want_new = new_paths_grads(LocalGroup(1), bench3, configs[False],
                               weights)
    from dirt_tpu_torch.parallel.face_sharding import rasterise_face_sharded
    from dirt_tpu_torch.utils.graphstep import GraphedStep

    nccl_renders = {
        "sharded dense": lambda bg, v, c: rasterise_sharded(
            bg, v, c, faces, DistGroup(), config=dense_big, with_aux=True),
        "overlap": lambda bg, v, c: rasterise_sharded(
            bg, v, c, faces, DistGroup(), config=configs[False],
            overlap_chunks=2, with_aux=True),
        "face-sharded": lambda bg, v, c: rasterise_face_sharded(
            bg, v, c, faces, DistGroup(), config=configs[False],
            with_aux=True),
    }
    leaves = (background, clip, colors)
    with tempfile.TemporaryDirectory() as store:
        torch.distributed.init_process_group(
            "nccl", init_method=f"file://{store}/store", rank=0, world_size=1,
            device_id=device)
        got = grads_of(DistGroup())
        got_new = new_paths_grads(DistGroup(), bench3, configs[False],
                                  weights)
        # The same steps as CUDA-graph replays: the capture takes NCCL's
        # collectives of a one-rank group.
        got_graphed = {
            path: [t.clone() for t in GraphedStep(
                render_step(render, weights), leaves)(*leaves)[3:]]
            for path, render in nccl_renders.items()}
        _sync()
        torch.distributed.destroy_process_group()
    nccl_err = [_rel_err(g, w) for g, w in zip(got, want)]
    if not all(e <= TOL_GRAD for e in nccl_err):
        raise RuntimeError(f"[13] the one-rank NCCL group's step differs from "
                           f"the one-slab local step: {nccl_err}")
    print(f"[13 torch.distributed] one rank over NCCL: max |grad diff| / max "
          f"|grad| from the one-slab local step "
          f"{' '.join(f'{e:.3g}' for e in nccl_err)} (limit {TOL_GRAD:g})")
    for path, grads in got_graphed.items():
        err = [_rel_err(g, w) for g, w in zip(
            grads, want if path == "sharded dense" else want_new[path])]
        if not all(e <= TOL_GRAD for e in err):
            raise RuntimeError(f"[13] the one-rank NCCL group's graphed "
                               f"{path} step differs from the local step: "
                               f"{err}")
        print(f"[13 torch.distributed] {path}, one rank over NCCL as a "
              f"CUDA-graph replay: max |grad diff| / max |grad| from the "
              f"local step {' '.join(f'{e:.3g}' for e in err)} (limit "
              f"{TOL_GRAD:g})")
    for path, grads in got_new.items():
        err = [_rel_err(g, w) for g, w in zip(grads, want_new[path])]
        if not all(e <= TOL_GRAD for e in err):
            raise RuntimeError(f"[15] the one-rank NCCL group's {path} step "
                               f"differs from the LocalGroup(1) step: {err}")
        print(f"[15 torch.distributed] {path}, one rank over NCCL (bench "
              f"sphere, packed): max |grad diff| / max |grad| from the "
              f"LocalGroup(1) step {' '.join(f'{e:.3g}' for e in err)} "
              f"(limit {TOL_GRAD:g})")

    laps.lap()
    # --- 15. the overlapped and face-sharded renderers at full width ---------
    counts, times = _overlap_check("15 overlap bench sphere packed", bench3,
                                   configs[False], weights, card)
    counts_dense = _face_sharded_check(
        "15 face-sharded bench sphere dense", bench3, dense_big, weights,
        "raster_fwd_dense")
    big_packed = dirt_tpu_torch.suggest_raster_config(
        big_clip, big_faces, SIZE, SIZE,
        config=dirt_tpu_torch.RasterConfig(engine="packed"), clip=False)
    counts_packed = _face_sharded_check(
        f"15 face-sharded {n_big}-face sphere packed", big3, big_packed,
        weights, "raster_fwd_packed")
    for members in (1, 4):
        if bool(face_sharded_step(bench3, configs[False], weights,
                                  members)[0][3]):
            raise RuntimeError(f"[15] face-sharded bench sphere, {members} "
                               f"members: overflow under {configs[False]}")
        times[f"face-sharded n={members}"] = _median_ms(
            lambda: face_sharded_step(bench3, configs[False], weights,
                                      members), 5)
    for kernel_name in COUNTED:
        launches[kernel_name] += (counts[kernel_name]
                                  + counts_dense[kernel_name]
                                  + counts_packed[kernel_name])
    print(f"[15 times] bench sphere {SIZE}^2 C=3 fwd+bwd under the caps of "
          f"phase 4 (face-sharded n=4: four dense members): "
          + ", ".join(f"{label} {ms:.4f} ms" for label, ms in times.items())
          + f" (medians of 5) ({card})")

    laps.lap()
    # --- 14. the bench, the config store and the OBJ loader ----------------
    _bench_and_io_check(
        (verts_obj, clip, colors, faces, background, weights),
        configs[False], card)

    laps.lap()
    # --- 16. the demos -------------------------------------------------------
    for kernel_name, count in _demos_check(device, card).items():
        launches[kernel_name] += count

    laps.lap()
    # --- 17. the 1,001,112-face sphere -----------------------------------------
    for kernel_name, count in _huge_sphere_check(device, card).items():
        launches[kernel_name] += count

    laps.lap()
    # --- 18. the stage, binning and parallel profilers, the max-scan -------
    counts, vjp_record = _tools_check(device, card, configs[False])
    for kernel_name, count in counts.items():
        launches[kernel_name] += count
    record.update(_check_max_scan(device, card))
    record.update(vjp_record)

    laps.lap()
    # --- 19. the compiled steps: CUDA-graph replays against eager --------
    for kernel_name, count in _graphed_check(
            device, card, (verts_obj, clip, colors, faces, background,
                           weights), configs).items():
        launches[kernel_name] += count

    laps.lap()
    # --- 20. compiled parallel steps, dry run, demos 3-4, the sheet -------
    for kernel_name, count in _graphed_parallel_check(
            device, card, weights, {"bench": bench3, "big": big3},
            {"dense": dense_big, "csr": stream_cfg, "packed": configs[False],
             "big csr": big_stream_cfg, "big packed": big_packed}).items():
        launches[kernel_name] += count

    laps.lap()
    print(f"[total] {time.perf_counter() - t_start:.1f} s; seconds by phase, "
          f"in the order run: {laps}")
    print(json.dumps({"kernels": [{
        "name": k,
        "route": "cuda",
        "source": f"dirt_tpu_torch/csrc/{k}.cu",
        "replaces": REPLACES[k],
        "launches": launches[k],
        **record[k],
        # One PyTorch call of the same function, where phase 12 times one
        # (index_add_ for the scatters, a strided copy for the swap).
        "library_ms": record[k].get("library_ms"),
    } for k in KERNELS] + [{
        "name": SCAN,
        "route": "cuda",
        "source": f"dirt_tpu_torch/csrc/{SCAN}.cu",
        "replaces": SCAN_REPLACES,
        "launches": launches[SCAN],
        **record[SCAN],
    }, {
        "name": SETUP_VJP,
        "route": "cuda",
        "source": f"dirt_tpu_torch/csrc/{SETUP_VJP}.cu",
        "replaces": SETUP_VJP_REPLACES,
        "launches": launches[SETUP_VJP],
        **record[SETUP_VJP],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
