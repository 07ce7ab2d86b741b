"""What the port's card tools and card tests share: scenes and steps,
roofline bounds, timers, profiler windows and tolerances.

The profilers and A/B benches under ``tools/`` import this module and no
other tool's script; so do the card tests. It imports only torch, numpy,
``dirt_tpu_torch`` and ``bench_configs_torch`` (the sheet, whose camera
poses every scene here), and runs nothing when imported.
"""

import ctypes
import hashlib
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import bench_configs_torch  # noqa: E402
import dirt_tpu_torch  # noqa: E402
from dirt_tpu_torch.ops import _build, binning, raster  # noqa: E402
from dirt_tpu_torch.ops import triangle_setup  # noqa: E402
from dirt_tpu_torch.ops.triangle_setup import screen_from_clip  # noqa: E402
from dirt_tpu_torch.utils.benchtime import device_time  # noqa: E402

# The cells' image size: every bench scene is SIZE x SIZE.
SIZE = 1024
# Pixels of a whole-tile forward kernel against its plain version.
TOL = dict(rtol=1e-6, atol=1e-6)
# Fused backward and scatter rows against their plain versions, per
# column: |diff| <= TOL_ROWS * max |column| + 1e-6. The kernels sum
# float32 in their own fixed order; the plain versions sum float64 and
# round once.
TOL_ROWS = 1e-5
# Two engines (or a parallel path and the single device) on one scene:
# gradients as max |diff| over max |gradient| (one forward arithmetic, two
# reductions in other orders), and differing face ids as a share of the
# covered pixels.
TOL_ENGINES = 1e-4

# Published peaks of one H100 SXM: HBM bytes/s and float32 FLOP/s outside
# the tensor cores (the kernels use no tensor core).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12
# Arithmetic of one (pixel, face) coverage and depth test.
TEST_FLOPS = 22

# Samples a stage or variant on the bench sphere and on the
# 1,001,112-face sphere (tools/bench_large.py:61-63 takes three there),
# and calls in one profiler window.
SAMPLES = 10
SAMPLES_LARGE = 3
PROFILE_STEPS = 5
# Profiler windows to try before giving up, each with twice the calls of
# the last. The tracer now and then hands back no device record for a
# short window of few kernels: on an H100, three windows in a row of 2, 4
# and 8 calls of the prologue kernel alone on the 1,001,112-face scene.
WINDOWS = 6


def attr_flops(channels):
    """Arithmetic of one covered pixel's attribute evaluation."""
    return 6 + 5 * channels


def core_flops(channels):
    """Arithmetic of ``cotangent_core.cuh`` for one covered pixel."""
    return 330 + 6 * channels + (12 + 3 * channels)


def bound(nbytes, flops):
    """bound_ms and bound_by: the larger of bytes over the memory rate and
    operations over the float32 peak."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# --- scenes and steps ---------------------------------------------------


def rand(seed, *shape, device):
    """``RandomState(seed).rand(*shape)`` as float32 on ``device``."""
    return torch.as_tensor(
        np.random.RandomState(seed).rand(*shape).astype(np.float32),
        device=device)


def bench_scene(size, device, n=72):
    """The scene of ``bench.py:88-112`` on ``device``: (object-space
    vertices, clip-space vertices, colors ``RandomState(0)``, faces int64,
    zero background [size, size, 3], upstream gradient ``w =
    RandomState(1).rand(size, size, 3)``) of ``mesh.uv_sphere(n, n)``."""
    from dirt_tpu_torch.core import mesh

    verts_obj, faces, _ = mesh.uv_sphere(n_lat=n, n_lon=n)
    verts_obj = torch.as_tensor(verts_obj, device=device)
    clip = bench_configs_torch.posed(verts_obj, device)
    colors = rand(0, len(verts_obj), 3, device=device)
    faces = torch.as_tensor(faces.astype(np.int64), device=device)
    background = torch.zeros((size, size, 3), device=device)
    return verts_obj, clip, colors, faces, background, rand(1, size, size, 3,
                                                            device=device)


def honest(key, scene, clip_flag, **fields):
    """``configstore.cached_config`` for the scene, with ``fields`` fixed:
    caps that one overflow-checked render validated."""
    from dirt_tpu_torch.utils import configstore

    _, clip, _, faces, background, _ = scene
    height, width = background.shape[:2]
    return configstore.cached_config(
        key, clip, faces, height, width,
        config=dirt_tpu_torch.RasterConfig(**fields), clip=clip_flag)


def engine_of(config, num_faces):
    """The engine that renders ``num_faces`` faces under ``config``."""
    if raster.streams(config, num_faces):
        return "csr"
    return raster.resolve_engine(config, num_faces)


def rel_err(got, want):
    """max |got - want| / max |want| (the difference itself where want is
    0, as a background gradient is when the mesh covers the image)."""
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    return diff / scale if scale else diff


def render_grads(rasterise, background, clip, colors, faces, weights, config,
                 c):
    """``loss.backward()`` of ``sum(pixels * w)`` through ``rasterise`` (a
    function of ``rasterise_with_aux``'s arguments); returns (its
    outputs, the gradients of vertices, colors and background)."""
    bg = background.clone().requires_grad_()
    verts = clip.clone().requires_grad_()
    cols = colors.clone().requires_grad_()
    out = rasterise(bg, verts, cols, faces, config=config, clip=c)
    (out[0] * weights).sum().backward()
    return out, (verts.grad, cols.grad, bg.grad)


def sphere_faces(n, clip, device):
    """(faces [F, 3, 4], attributes [F, 3, 3]) of the bench sphere
    ``uv_sphere(n, n)`` at SIZE x SIZE, as the raster op gets them: with
    ``clip`` through the near-plane clip and compaction of the default
    API."""
    from dirt_tpu_torch.ops.clipping import clip_compact_screen
    from dirt_tpu_torch.rasterise_ops import _auto_clip_cap

    _, clip_verts, colors, faces, _, _ = bench_scene(SIZE, device, n=n)
    if clip:
        fv, fa, _, _ = clip_compact_screen(
            clip_verts[faces], colors[faces], _auto_clip_cap(faces.shape[0]),
            SIZE, SIZE)
        return fv, fa
    return screen_from_clip(clip_verts, SIZE, SIZE)[faces], colors[faces]


def big_sphere_step(device, n=224):
    """(loss_fn, leaves, (faces, config)) of the default API on a mesh above
    the streaming threshold: ``mesh.uv_sphere(n, n)`` (2 n (n - 1) faces;
    224 gives 99,904, the sphere of ``bench.py``'s 100k cell) under the
    bench camera at SIZE x SIZE, colors ``RandomState(0)``, under
    ``suggest_raster_config``'s caps with the default ``clip=True``, which
    pins ``streaming`` and so picks the csr engine (raises otherwise).
    ``loss_fn(background, vertices, colors)`` is ``sum(image * w)``."""
    _, clip, colors, faces, background, weights = bench_scene(SIZE, device, n)
    config = dirt_tpu_torch.suggest_raster_config(clip, faces, SIZE, SIZE)
    if (config.streaming is not True
            or raster.resolve_engine(config, faces.shape[0]) != "csr"):
        raise RuntimeError(f"the default API did not choose the csr engine "
                           f"for {faces.shape[0]} faces: {config}")

    def loss_fn(bg, verts, cols):
        return (dirt_tpu_torch.rasterise(bg, verts, cols, faces,
                                         config=config) * weights).sum()

    return loss_fn, (background, clip, colors), (faces, config)


def _bench_loss(device, render, **fields):
    """(loss_fn, leaves) of ``sum(render(...) * w)`` on the bench sphere at
    SIZE x SIZE under ``suggest_raster_config``'s caps with ``fields``:
    ``render(background, vertices, colors, faces, config)``."""
    _, clip, colors, faces, background, weights = bench_scene(SIZE, device)
    config = dirt_tpu_torch.suggest_raster_config(
        clip, faces, SIZE, SIZE,
        config=dirt_tpu_torch.RasterConfig(**fields), clip=False)

    def loss_fn(bg, verts, cols):
        return (render(bg, verts, cols, faces, config) * weights).sum()

    return loss_fn, (background, clip, colors)


def sharded_dense_step(device, slabs=4):
    """(loss_fn, leaves) of the row-sharded renderer on the bench sphere
    under ``RasterConfig(engine="dense")``, ``slabs`` local slabs on one
    card."""
    from dirt_tpu_torch.parallel.group import LocalGroup
    from dirt_tpu_torch.parallel.sharding import rasterise_sharded

    return _bench_loss(device, lambda bg, v, c, f, config: rasterise_sharded(
        bg, v, c, f, LocalGroup(slabs), config=config), engine="dense")


def overlap_loss(device, slabs=4, chunks=4):
    """(loss_fn, leaves) of ``rasterise_sharded(overlap_chunks=chunks)`` on
    the bench sphere under the auto caps (the packed engine), ``slabs``
    local slabs on one card."""
    from dirt_tpu_torch.parallel.group import LocalGroup
    from dirt_tpu_torch.parallel.sharding import rasterise_sharded

    return _bench_loss(device, lambda bg, v, c, f, config: rasterise_sharded(
        bg, v, c, f, LocalGroup(slabs), config=config,
        overlap_chunks=chunks))


def face_sharded_loss(device, members=4):
    """(loss_fn, leaves) of ``rasterise_face_sharded`` on the bench sphere
    under the auto caps, ``members`` local members (four: 2,556 faces each,
    the dense engine)."""
    from dirt_tpu_torch.parallel.face_sharding import rasterise_face_sharded
    from dirt_tpu_torch.parallel.group import LocalGroup

    return _bench_loss(
        device, lambda bg, v, c, f, config: rasterise_face_sharded(
            bg, v, c, f, LocalGroup(members), config=config))


def calls(module, name, run):
    """[(args, kwargs)] of every call of ``module.name`` during ``run()``."""
    seen = []
    inner = getattr(module, name)

    def record(*args, **kwargs):
        seen.append((args, kwargs))
        return inner(*args, **kwargs)

    with mock.patch.object(module, name, record):
        run()
    return seen


def launched(run):
    """(``run()``, {kernel: launches} of the kernels of ``csrc/`` it
    launched), from ``utils.trace``'s ``launch.<kernel>`` counters (the
    tracing markers apart), after a synchronise."""
    from dirt_tpu_torch.utils import trace

    def counts():
        counters = trace.counters()
        return {k: counters.get(f"launch.{k}", 0) for k in _build.KERNELS
                if k != "trace_marks"}

    before = counts()
    out = run()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in counts().items()
                 if n != before[k]}


def raster_inputs(fn):
    """What the one rasterisation of ``fn()`` handed the raster op:
    (face_verts_screen, face_attrs, background, config), detached. These
    are the clipped, gathered faces the engine's kernels see on that
    path."""
    ((args, _),) = calls(raster, "_forward_impl", fn)
    return (*(t.detach() for t in args[:3]), args[3])


# --- the packed binning, stage by stage ------------------------------------


def scene_and_config(device, size=SIZE, n_lat=72, config=None):
    """(``bench_scene(size, device, n_lat)``, its packed config): ``config``
    if given, else the honest caps under the bench's key. Raises unless the
    config runs the packed engine."""
    scene = bench_scene(size, device, n=n_lat)
    if config is None:
        config = honest(f"torch_sphere{n_lat}_{size}_auto", scene, False)
    config = config.concrete(size)
    faces = scene[3]
    if raster.resolve_engine(config, faces.shape[0]) != "packed":
        raise ValueError(f"{config} does not run the packed engine on "
                         f"{faces.shape[0]} faces")
    return scene, config


class Geometry:
    """The packed binning's static arguments for one scene and config."""

    def __init__(self, config, num_faces, size):
        self.size = size
        self.tile_h, self.tile_w = config.tile_h, config.tile_w
        self.hp = -(-size // self.tile_h) * self.tile_h
        self.wp = -(-size // self.tile_w) * self.tile_w
        self.expand, self.budget = raster._packed_caps(
            config, num_faces, self.hp, self.wp)
        self.pool_cap, self.work_cap = config.pool_cap, config.work_cap
        self.bmax = -(-self.expand // binning.POOL_ALIGN)


def setup(clip, colors, faces, size):
    """(geo, att, bbox, edges): screen_from_clip, the face gather and the
    packed engine's ``triangle_setup.setup_faces`` (its kernel on the card),
    as the API runs them with ``clip=False``."""
    fv = screen_from_clip(clip, size, size)[faces]
    out = triangle_setup.setup_faces(fv, colors[faces], size, size, "packed")
    return out.geo, out.att, out.bbox, out.edges


def bin_faces(bbox, edges, geom, _stage=0):
    """``bin_faces_packed`` under ``geom`` (a :class:`Geometry`)."""
    return binning.bin_faces_packed(
        bbox, geom.hp, geom.wp, geom.tile_h, geom.tile_w, geom.budget,
        geom.expand, edges=edges, pool_cap=geom.pool_cap,
        work_cap=geom.work_cap, _stage=_stage)


# --- bounds -----------------------------------------------------------------


def packed_live(bins, tile_h):
    """Iterations the packed kernels run: per (tile, strip), the strip's run
    clamped to its tile's n_iters, summed."""
    strips = tile_h // 8
    lo = bins.iter_off.long().reshape(-1, strips)
    hi = torch.minimum(lo + bins.strip_iters.long().reshape(-1, strips),
                       bins.n_iters.long()[:, None])
    return int(torch.clamp(hi - lo, min=0).sum())


def packed_live_faces(bins, tile_h):
    """The distinct faces of the jobs the packed kernels run (the live
    iterations' entries >> 3, the sentinel included): the face-table rows
    they read, each of which the function needs once."""
    strips = tile_h // 8
    lo = bins.iter_off.long().reshape(-1, strips)
    hi = torch.minimum(lo + bins.strip_iters.long().reshape(-1, strips),
                       bins.n_iters.long()[:, None])
    n = torch.clamp(hi - lo, min=0).reshape(-1)
    ts = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n)
    first = torch.cumsum(n, 0) - n
    it = lo.reshape(-1)[ts] + torch.arange(ts.numel(), device=n.device) \
        - first[ts]
    row0 = bins.start_block.long()[ts // strips] * 64 + it
    rows = row0[:, None] * 8 + torch.arange(8, device=n.device)
    return int(torch.unique(bins.entries.long()[rows] >> 3).numel())


def packed_forward_bound(bins, tile_h, channels, fid):
    """raster_fwd_packed's bound, from ``bins`` and the forward's [Hp, Wp]
    face ids: each live job's entry; the 14 test columns (0..13) of each
    face a live job names, read from the face table by face, once; the
    denominator and 3C attribute columns (14..16, 19..) and the id column
    once for each distinct winning face; the per-tile and per-strip
    fields; the background where no face won; the three outputs written
    once. One coverage and depth test per (pixel, live iteration) and one
    attribute evaluation per covered pixel."""
    hp, wp = fid.shape
    live = packed_live(bins, tile_h)
    hit = fid >= 0
    covered = int(hit.sum())
    won = int(torch.unique(fid[hit]).numel())
    meta_bytes = 4 * (2 * bins.n_iters.numel() + 2 * bins.iter_off.numel())
    return bound(live * 8 * 4 + packed_live_faces(bins, tile_h) * 14 * 4
                 + won * (4 + 3 * channels) * 4
                 + meta_bytes + 4 * hp * wp * (channels + 2)
                 + 4 * (hp * wp - covered) * channels,
                 live * 1024 * TEST_FLOPS + covered * attr_flops(channels))


def packed_backward_bound(bins, tile_h, fid_p, out_values, channels):
    """packed_bwd's bound: each live job's entry; the 17 geometry columns
    of each face that owns a pixel, read from the face table by face, once;
    the per-tile and per-strip fields; the per-pixel planes (fid, bits,
    four sval, C pixel and C gradient planes) once; the ``out_values``
    floats of the rows written once. The cotangent core per covered
    pixel."""
    hp, wp = fid_p.shape
    live = packed_live(bins, tile_h)
    owned = fid_p >= 0
    owners = int(torch.unique(fid_p[owned]).numel())
    meta_bytes = 4 * (2 * bins.n_iters.numel() + 2 * bins.iter_off.numel())
    return bound(live * 8 * 4 + owners * 17 * 4 + meta_bytes
                 + 4 * hp * wp * (6 + 2 * channels) + 4 * out_values,
                 int(owned.sum()) * core_flops(channels))


def prologue_bound(height, width, hp, wp, channels):
    """padded_prologue's bound: fid, depth, pixels and gradient of the
    [H, W] image read once (8 + 8C bytes a pixel); padded fid, bits, four
    sval planes, padded pixels and gradient written once (24 + 8C bytes a
    padded pixel); per padded pixel and direction 3C + 1 operations."""
    return bound(height * width * (8 + 8 * channels)
                 + hp * wp * (24 + 8 * channels),
                 hp * wp * 4 * (3 * channels + 1))


def tests_per_pixel(bins, boxes, tile_h, tile_w, hp, wp, warp=(4, 8)):
    """(faces tested per pixel by the walk without the cull, by the culled
    walk of raster_tile.cuh) on DenseBins or StreamBins over a padded
    hp x wp image. The culled walk tests a listed face on the 32 pixels of
    each warp whose span meets the face's cull box (``boxes``, from
    ``raster_fwd.csr_cull_boxes``); a warp's span is ``warp`` (rows,
    columns) of the tile, aligned (4 x 8 for tiles a multiple of 8 wide;
    1 x 32 is the row-order walk on tiles a multiple of 32 wide)."""
    counts = bins.counts.long()
    tiles = torch.arange(counts.numel(), device=counts.device)
    tile = torch.repeat_interleave(tiles, counts)
    slot = (torch.arange(tile.numel(), device=tile.device)
            - (torch.cumsum(counts, 0) - counts)[tile])
    if hasattr(bins, "entry_face"):
        face = bins.entry_face.long()[bins.start_block.long()[tile]
                                      * binning.CHUNK + slot]
    else:
        face = bins.bins.long()[tile, slot]
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


# --- timers and profiler windows --------------------------------------------


def median_ms(fn, runs=10, warmup=2):
    """Median ms of ``runs`` synchronised single calls of ``fn()`` on the
    card (``utils.benchtime``: CUDA events), after ``warmup`` calls."""
    card = torch.empty(0, device="cuda")
    return 1e3 * device_time(lambda _: fn(), (card,), warmup, runs)


def queued_ms(fn, runs=10, warmup=3):
    """(ms per call of ``runs`` calls queued back to back with no
    synchronise between them, the host's ms to queue one of them)."""
    import time

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def short_name(name):
    """A device kernel's bare name, from the profiler's signature."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("<")[0].split("::")[-1][:40]


def _device_events(fn, count):
    """(device events, calls, profile) of a ``torch.profiler`` window of
    ``count`` calls of ``fn()``; a window without device records is taken
    again with twice the calls, up to WINDOWS windows."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(count):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            return kernels, count, prof
        count *= 2
    raise RuntimeError("the profiler recorded no device activity")


def device_ms(fn, runs=20, warmup=3):
    """{device kernel name: ms per call} of ``fn`` from a ``torch.profiler``
    window of ``runs`` calls: the card's own time, without the host's."""
    for _ in range(warmup):
        fn()
    kernels, runs, _ = _device_events(fn, runs)
    by_name = {}
    for event in kernels:
        by_name[event.name] = (by_name.get(event.name, 0.0)
                               + event.device_time / 1e3 / runs)
    return by_name


def profile(label, step, card, steps=PROFILE_STEPS, echo=True):
    """A ``torch.profiler`` window of ``steps`` calls of ``step`` (after
    three warm-up calls, synchronised inside the window). Prints its lines
    when ``echo`` and returns the record: device kernels per step, device
    busy and span per step (ms), busy share, the package's own kernels
    ({``__global__`` name: (ms per step, launches per step)}), the five
    largest device items and the five largest host operations by their own
    host time, each as (name, ms per step, count per step)."""
    for _ in range(3):
        step()
    kernels, steps, prof = _device_events(step, steps)
    busy = sum(e.device_time for e in kernels) / 1e3          # ms
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    ours_names = _build.global_names()
    by_name, ours = {}, {}
    for e in kernels:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.device_time / 1e3, count + 1)
        for name in ours_names.intersection(re.findall(r"\w+", e.name)):
            total, count = ours.get(name, (0.0, 0))
            ours[name] = (total + e.device_time / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    host = sorted(prof.key_averages(),
                  key=lambda op: -op.self_cpu_time_total)[:5]
    record = dict(
        label=label, kernels=len(kernels) / steps, busy_ms=busy / steps,
        span_ms=span / steps, busy_share=busy / span,
        ours={name: (total / steps, count / steps)
              for name, (total, count) in sorted(ours.items())},
        top=[(name, total / steps, count / steps)
             for name, (total, count) in top],
        host=[(op.key, op.self_cpu_time_total / 1e3 / steps,
               op.count / steps) for op in host])
    if echo:
        print(f"[{label}] device kernels per step {record['kernels']:.1f}, "
              f"device busy per step {record['busy_ms']:.4f} ms, device span "
              f"per step {record['span_ms']:.4f} ms, busy share "
              f"{record['busy_share']:.3f} (window of {steps} steps, {card})")
        for name, (ms, count) in record["ours"].items():
            print(f"[{label}]   kernel {name}: {ms:.4f} ms per step "
                  f"({count:.0f} launches)")
        for name, ms, count in record["top"]:
            print(f"[{label}]   top: {ms:.4f} ms per step x{count:.0f} "
                  f"{name[:70]}")
        for key, ms, count in record["host"]:
            print(f"[{label}]   host: {ms:.4f} ms per step x{count:.0f} "
                  f"{key[:70]}")
    return record


# --- other trees' kernels ---------------------------------------------------


def build_lib(root, name, label, defines=()):
    """Build ``csrc/<name>.cu`` of the tree at ``root`` with this tree's
    compiler flags plus ``-D`` for each of ``defines`` into this tree's
    build directory; print its registers and spills and return the loaded
    library."""
    src = Path(root) / "dirt_tpu_torch" / "csrc" / f"{name}.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"lib{label}_{name}.so"
    done = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
         "-o", str(out), str(src)], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{done.stdout}"
                           f"{done.stderr}")
    for line in (done.stdout + done.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build {label} {name}] {line.strip()}")
    return ctypes.CDLL(str(out))


def digest(*tensors):
    """SHA-256 prefix of the tensors' bytes, in order."""
    sha = hashlib.sha256()
    for tensor in tensors:
        sha.update(tensor.detach().contiguous().cpu().numpy().tobytes())
    return sha.hexdigest()[:16]
