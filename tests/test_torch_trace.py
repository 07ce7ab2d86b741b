"""The port's tracing (``dirt_tpu_torch.utils.trace``) and the benchmark's
readers of it (``benchmark/layers/``).

On the CPU: the registry's count, maximum, snapshot and reset; stage spans
as no-ops on CPU tensors; the span and switch logic, and the raster op's
stage sites on every engine, with the card check and the marker launch
replaced by a recorder (the markers each site would launch, in order, and
the cap fills on the binning's closing marker), the shading calls'
``shade`` span, ``entry.deferred_render``'s markers and a textured fit
step's ``texture`` and ``texture_grad`` pairs; ``GraphedStep``'s
counters untouched on the CPU path; the markers the kernel file instantiates; each
new reader on synthetic profiler windows (``benchmark.trace.Window``):
stages split at their markers with the idle time inside counted, a stage
run twice in a replay summed, and nothing read from an incomplete window
or a replay whose markers do not pair up.

On the card (``cuda`` marker; this file imports no jax, so it runs there
with ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_trace.py``): a profiled replay of a graphed packed fwd+bwd
step shows each marker once, in the stages' order; a replay's host span
encloses its ``cudaGraphLaunch`` on the profiler's clock; the pool fill
equals ``sum(blocks) * POOL_ALIGN / pool_cap`` of an eager call and
outlives the graph that wrote it, the CSR binning's fills and the dense
binning's ``bin`` fill are the host counts; a replay of the lit and the
deferred pipelines' forwards shows their ``shade`` pairs before the raster
op's markers (and the deferred one its ``texture`` pair after them); every
replay of a graphed textured fit step shows the ``texture`` pair in its
forward and the ``texture_grad`` pair once in its backward; a step with
the markers stubbed out gives the same bits; and
after the stage tool's profiler windows, every
whole replay of a three-replay session shows each marker once, and a
session counts as complete only when no replay in it lost a record; last,
a packed fwd+bwd step recorded with its operators' shapes makes no copy of
the face table in budget-row order (no index or gather reads the table,
none writes ``budget_rows`` rows).
"""

import gc
import importlib
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import dirt_tpu_torch
from _torch_port_scene import sphere_scene
from benchmark.trace import Window
from dirt_tpu_torch import convert, entry
from dirt_tpu_torch.core import lighting
from dirt_tpu_torch.core.texture import sample_texture
from dirt_tpu_torch.ops import binning, raster
from dirt_tpu_torch.ops.raster import RasterConfig
from dirt_tpu_torch.utils import trace
from dirt_tpu_torch.utils.graphstep import GraphedStep

# The markers of one fwd+bwd step of the raster op, in order.
STEP_MARKS = [(None, "clip"), ("clip", None), (None, "setup"),
              ("setup", "binning"), ("binning", "raster_fwd"),
              ("raster_fwd", None), (None, "raster_bwd"),
              ("raster_bwd", None)]
# The markers of one shading call (``core/lighting.py``).
SHADE_MARKS = [(None, "shade"), ("shade", None)]
# The markers of one texture lookup and of its gradient's scatter
# (``core/texture.py``).
TEXTURE_MARKS = [(None, "texture"), ("texture", None)]
TEXTURE_GRAD_MARKS = [(None, "texture_grad"), ("texture_grad", None)]
ALL_MARKS = STEP_MARKS + SHADE_MARKS + TEXTURE_MARKS + TEXTURE_GRAD_MARKS
# The raster op's spans.
RASTER_SPANS = ("clip", "setup", "binning", "raster_fwd", "raster_bwd")
ENGINES = {"packed": dict(engine="packed"), "dense": dict(engine="dense"),
           "csr": dict(streaming=True)}


# --- 1. the registry ---------------------------------------------------------


def test_registry_counts_maxima_snapshots_and_resets():
    registry = trace.Registry()
    registry.count("launch.k")
    registry.count("launch.k", 2)
    registry.count("graphstep.capture_s", 0.25)
    registry.maximum("most", 3)
    registry.maximum("most", 1)
    registry.maximum("most", 7)
    registry.replayed(1, 2, 3)
    snap = registry.snapshot()
    assert snap == {"launch.k": 3, "graphstep.capture_s": 0.25, "most": 7}
    registry.count("launch.k")
    assert snap["launch.k"] == 3                  # a snapshot is a copy
    assert registry.host_spans() == [trace.HostSpan(1, 2, 3)]
    registry.reset()
    assert registry.snapshot() == {} and registry.host_spans() == []


def test_module_registry_and_its_ring():
    trace.reset()
    trace.count("launch.raster_fwd_packed")
    for k in range(trace.RING + 5):
        trace.replayed(k, k + 1, k + 2)
    assert trace.counters() == {"launch.raster_fwd_packed": 1}
    spans = trace.host_spans()
    assert len(spans) == trace.RING >= 4096
    assert spans[0].entry == 5 and spans[-1].done == trace.RING + 6
    trace.reset()
    assert trace.counters() == {} and trace.host_spans() == []


def test_counts_from_threads_add_up():
    registry = trace.Registry()

    def work():
        for _ in range(2000):
            registry.count("n")

    threads = [threading.Thread(target=work) for _ in range(8)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=60)
    assert not any(thread.is_alive() for thread in threads)
    assert registry.snapshot() == {"n": 16000}


# --- 2. spans ----------------------------------------------------------------


@pytest.fixture
def marks(monkeypatch):
    """The markers launched, as (closed, opened, {fill: share}), with every
    tensor taken for a card tensor."""
    launched = []

    def record(close, open_, like):
        trace.mark_ids(close, open_)       # a marker the kernel file has
        fills, trace._OPEN.fills = trace._OPEN.fills, None
        shares = {}
        if fills is not None:
            shares = {name: float(fill[0]) / fill[1]
                      for name, fill in zip(trace.FILLS, fills)
                      if fill is not None}
        launched.append((close, open_, shares))

    monkeypatch.setattr(trace, "_mark", record)
    monkeypatch.setattr(trace, "_on_card", lambda tensor: True)
    return launched


def test_span_is_a_no_op_on_cpu_tensors(monkeypatch):
    launched = []
    monkeypatch.setattr(trace, "_mark", lambda *a: launched.append(a))
    x = torch.ones(3)
    with trace.span("setup", x):
        trace.switch("setup", "binning", x)
        trace.fills(pool=(torch.ones((), dtype=torch.int64), 4))
        y = x * 2
    trace.switch("binning", "raster_fwd", x)
    assert launched == [] and torch.equal(y, x * 2)
    assert trace._OPEN.stack == [] and trace._OPEN.fills is None


def test_spans_switch_and_close(marks):
    x = torch.ones(2)
    trace.switch("setup", "binning", x)           # outside a span: nothing
    with trace.span("setup", x):
        trace.switch("binning", "raster_fwd", x)  # not the open span
        trace.switch("setup", "binning", x)
        trace.fills(pool=(torch.tensor(3), 4), work=None,
                    expand=(torch.tensor(2), 8))
        trace.switch("binning", "raster_fwd", x)
    with trace.span("raster_bwd", x):
        pass
    assert [(c, o) for c, o, _ in marks] == [
        (None, "setup"), ("setup", "binning"), ("binning", "raster_fwd"),
        ("raster_fwd", None), (None, "raster_bwd"), ("raster_bwd", None)]
    assert marks[2][2] == {"pool": 0.75, "expand": 0.25}
    assert all(shares == {} for i, (_, _, shares) in enumerate(marks)
               if i != 2)
    assert trace._OPEN.stack == []


def test_a_span_that_raises_launches_no_closing_marker(marks):
    x = torch.ones(2)
    with pytest.raises(ValueError, match="cap"):
        with trace.span("setup", x):
            raise ValueError("cap")
    assert [(c, o) for c, o, _ in marks] == [(None, "setup")]
    assert trace._OPEN.stack == []


def test_the_kernel_file_instantiates_the_markers_of_marks():
    source = (Path(trace.__file__).parents[1] / "csrc"
              / "trace_marks.cu").read_text()
    table = source[source.index("kMarks[] = {"):]
    table = table[:table.index("};")]
    got = [(int(c), int(o)) for c, o, c2, o2 in re.findall(
        r"\{(\d), (\d), launch<(\d), (\d)>\}", table) if (c, o) == (c2, o2)]
    assert tuple(got) == trace.MARKS
    assert [trace.marker(MARK.format(c, o)) for c, o in got] == ALL_MARKS


def test_the_kernel_files_fill_block_is_fills():
    source = (Path(trace.__file__).parents[1] / "csrc"
              / "trace_marks.cu").read_text()
    count, names = re.search(
        r"constexpr int FILLS = (\d+);\s*// trace\.FILLS: ([\w, ]+)",
        source).groups()
    assert int(count) == len(trace.FILLS)
    assert tuple(names.split(", ")) == trace.FILLS


def test_a_marker_outside_marks_raises_before_any_launch():
    assert [trace.mark_ids(c, o) for c, o in ALL_MARKS] == list(trace.MARKS)
    x = torch.ones(2)
    with pytest.raises(ValueError, match="no marker closes setup"):
        trace._mark("setup", "raster_bwd", x)
    with pytest.raises(ValueError, match="no marker closes None"):
        trace._mark(None, "binning", x)


def _scene(engine, clip):
    verts, colors, faces = sphere_scene(12, 16, distance=0.9 if clip
                                        else 3.0)
    bg = np.zeros((64, 128, 3), np.float32)
    bg, verts, colors, faces = convert.scene_from_numpy(bg, verts, colors,
                                                        faces, "cpu")
    config = dirt_tpu_torch.suggest_raster_config(
        verts, faces, 64, 128, config=RasterConfig(**ENGINES[engine]),
        clip=clip)
    return bg, verts, colors, faces, config


def csr_fills(args):
    """{"tile", "expand"} shares of one ``bin_faces_csr`` call, counted on
    the host from its arguments (bbox, height, width, tile_h, tile_w, cap,
    expand_cap): the fullest tile's faces over the cap rounded up to
    CHUNK, the most tiles of one face over the expand cap."""
    bbox, height, width, tile_h, tile_w, cap, expand = args
    tiles_x = -(-width // tile_w)
    per_tile, widest = {}, 0
    for xmin, xmax, ymin, ymax in np.asarray(bbox.cpu()).tolist():
        if xmax < xmin or ymax < ymin:
            continue
        tiles = [(ty, tx) for ty in range(ymin // tile_h, ymax // tile_h + 1)
                 for tx in range(xmin // tile_w, xmax // tile_w + 1)]
        widest = max(widest, len(tiles))
        for ty, tx in tiles:
            per_tile[ty * tiles_x + tx] = per_tile.get(ty * tiles_x + tx,
                                                       0) + 1
    chunked = -(-cap // binning.CHUNK) * binning.CHUNK
    return {"tile": max(per_tile.values()) / chunked,
            "expand": widest / expand}


def dense_fill(args):
    """The ``bin`` share of one ``bin_faces`` call, counted on the host
    from its arguments (bbox, height, width, tile_h, tile_w, cap): the
    fullest tile's faces (every face whose tile span covers it, as the
    binning's overlap matrix has them) over the cap."""
    bbox, height, width, tile_h, tile_w, cap = args
    tiles_y, tiles_x = -(-height // tile_h), -(-width // tile_w)
    per_tile = np.zeros((tiles_y, tiles_x), np.int64)
    for xmin, xmax, ymin, ymax in np.asarray(bbox.cpu()).tolist():
        for ty in range(max(ymin // tile_h, 0), min(ymax // tile_h + 1,
                                                     tiles_y)):
            for tx in range(max(xmin // tile_w, 0), min(xmax // tile_w + 1,
                                                         tiles_x)):
                per_tile[ty, tx] += 1
    return per_tile.max() / cap


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("clip", [True, False])
def test_raster_op_marks_its_stages(marks, monkeypatch, engine, clip):
    """A fwd+bwd step launches the stages' markers in order, eight with
    the clip and six without, and the binning's closing marker carries its
    cap fills: the packed pool's is sum(blocks) * POOL_ALIGN / pool_cap;
    the CSR binning's are its fullest tile and its widest face, and the
    dense binning's its fullest tile, as a host count has them."""
    bg, verts, colors, faces, config = _scene(engine, clip)
    marks.clear()                         # the counting's own clip
    made, made_csr, made_dense = [], [], []
    real, real_csr = binning.bin_faces_packed, binning.bin_faces_csr
    real_dense = binning.bin_faces

    def bin_packed(*args, **kwargs):
        made.append((real(*args, **kwargs), kwargs))
        return made[-1][0]

    def bin_csr(*args):
        made_csr.append(args)
        return real_csr(*args)

    def bin_dense(*args):
        made_dense.append(args)
        return real_dense(*args)

    monkeypatch.setattr(raster.binning, "bin_faces_packed", bin_packed)
    monkeypatch.setattr(raster.binning, "bin_faces_csr", bin_csr)
    monkeypatch.setattr(raster.binning, "bin_faces", bin_dense)
    verts = verts.clone().requires_grad_()
    pixels = dirt_tpu_torch.rasterise(bg, verts, colors, faces,
                                      config=config, clip=clip)
    pixels.sum().backward()
    want = STEP_MARKS if clip else STEP_MARKS[2:]
    assert [(c, o) for c, o, _ in marks] == want
    fills = [shares for _, _, shares in marks if shares]
    if engine == "csr":
        (args,) = made_csr
        assert made == [] and made_dense == []
        assert marks[want.index(("binning", "raster_fwd"))][2] is fills[0]
        assert fills == [pytest.approx(csr_fills(args))]
        assert all(0 < share <= 1 for share in fills[0].values())
        return
    if engine == "dense":
        (args,) = made_dense
        assert made == [] and made_csr == []
        assert marks[want.index(("binning", "raster_fwd"))][2] is fills[0]
        assert fills == [{"bin": pytest.approx(dense_fill(args))}]
        assert 0 < fills[0]["bin"] <= 1
        return
    (bins, kwargs), = made
    assert marks[want.index(("binning", "raster_fwd"))][2] is fills[0]
    cap = -(-kwargs["pool_cap"] // binning.POOL_ALIGN) * binning.POOL_ALIGN
    assert fills[0]["pool"] == pytest.approx(
        float(bins.pool_offs[-1]) * binning.POOL_ALIGN / cap)
    assert made_csr == [] and made_dense == []
    assert set(fills[0]) == ({"pool", "work", "expand", "budget"}
                             if kwargs["work_cap"] is not None
                             else {"pool", "expand", "budget"})
    assert all(0 < share <= 1 for share in fills[0].values())
    assert trace._OPEN.stack == [] and trace._OPEN.fills is None


def test_shading_calls_mark_the_shade_span_where_none_is_open(marks):
    """Each of the three shading calls opens and closes ``shade``; inside
    another span they launch nothing, and that span's markers pair as
    before."""
    verts, _, faces = sphere_scene(4, 6, distance=3.0)
    verts = torch.as_tensor(verts)[:, :3]
    faces = torch.as_tensor(faces)
    colors = torch.full_like(verts, 0.5)
    light = torch.tensor([0.0, 0.6, 0.8])

    def shade():
        normals = lighting.vertex_normals(verts, faces)
        return lighting.diffuse_directional(
            normals, colors, light, torch.ones(3),
        ) + lighting.specular_directional(
            verts, normals, colors, torch.zeros(3), light, torch.ones(3),
            20.0)

    plain = shade()
    assert [(c, o) for c, o, _ in marks] == SHADE_MARKS * 3
    marks.clear()
    with trace.outer_span("raster_bwd", verts):
        inside = shade()
    assert [(c, o) for c, o, _ in marks] == [(None, "raster_bwd"),
                                              ("raster_bwd", None)]
    assert torch.equal(inside, plain)
    assert trace._OPEN.stack == []


def test_deferred_render_marks_its_normals_then_the_raster_op(marks):
    """``entry.deferred_render``'s fwd+bwd step: the normals' ``shade``
    pair, the raster op's forward markers, the texture lookup's pair, then
    the raster op's backward pair; its texture needs no gradient, so no
    ``texture_grad`` pair."""
    small = entry.deferred_scene(6, 8, device="cpu")
    pose = torch.tensor([0.4, 0.3, 0.0], requires_grad=True)
    image = entry.deferred_render(small[0], pose, *small[1:], 64)
    image.sum().backward()
    assert [(c, o) for c, o, _ in marks] == (SHADE_MARKS + STEP_MARKS[:6]
                                             + TEXTURE_MARKS + STEP_MARKS[6:])
    assert trace._OPEN.stack == []


def _textured_step(device, size=64):
    """(step, args): one fit step of the ``textured512.fit`` cell's
    pipeline at ``size``² (its mesh, texture shape and clip flag), the
    texture and the pose trained: ``step(texture, pose) -> (image,
    d_texture, d_pose)``."""
    from benchmark import harness, inputs
    from benchmark.scenes import scene_arrays

    loaded = harness.load_cell("textured512.fit")
    config = dict(loaded.config, size=size)
    pipe = loaded.pipeline
    scene = pipe.scene(config, scene_arrays(config), device)
    pose = pipe.true_value("pose", config, scene)
    caps = inputs.suggested_caps(pipe, config, scene, [{"pose": pose}])
    target = torch.rand(size, size, 3, generator=torch.Generator()
                        .manual_seed(3)).to(device)
    texture = torch.full(tuple(config["texture_shape"]), 0.5, device=device)

    def step(tex, pose):
        tex, pose = (t.detach().requires_grad_() for t in (tex, pose))
        out = pipe.render(config, scene, caps, {"texture": tex, "pose": pose})
        loss = torch.mean((out["image"] - target) ** 2)
        return (out["image"].detach(),
                *torch.autograd.grad(loss, (tex, pose)))

    return step, (texture, pose + 0.02)


def test_a_textured_fit_step_marks_its_lookup_and_scatter(marks):
    """A fit step of the textured pipeline (texture and pose trained): the
    raster op's forward markers, the ``texture`` pair, then in the backward
    the ``texture_grad`` pair once, before the raster op's backward pair.
    With a texture that needs no gradient, no ``texture_grad`` pair."""
    step, args = _textured_step("cpu")
    marks.clear()
    _, d_texture, d_pose = step(*args)
    assert [(c, o) for c, o, _ in marks] == (
        STEP_MARKS[:6] + TEXTURE_MARKS + TEXTURE_GRAD_MARKS + STEP_MARKS[6:])
    assert float(d_texture.abs().sum()) > 0 and float(d_pose.abs().sum()) > 0
    assert trace._OPEN.stack == []
    marks.clear()
    uv = torch.rand(8, 8, 2, generator=torch.Generator().manual_seed(4))
    uv.requires_grad_()
    sample_texture(args[0], uv).sum().backward()
    assert [(c, o) for c, o, _ in marks] == TEXTURE_MARKS
    assert uv.grad is not None and not args[0].requires_grad


def test_graphed_step_counts_nothing_on_the_cpu():
    trace.reset()
    step = GraphedStep(lambda x: x * 2, (torch.ones(3),))
    for _ in range(3):
        step(torch.ones(3))
    assert step.graphs == {}
    assert trace.counters() == {} and trace.host_spans() == []


# --- 3. the readers ----------------------------------------------------------

MARK = "void span_mark<{}, {}>(Fills)"


def _replay(t0, corr, marks=True):
    """One replay's device operations from ``t0`` ns: three shading calls,
    every stage of the raster op between its markers, a texture lookup
    after the forward and its gradient's scatter before the raster op's
    backward, with idle time inside the normals, the clip, the binning and
    the scatter. Stage times: shade 4,500 ns over the three calls, clip
    6,000, binning 6,000, texture 2,000, texture_grad 4,000, raster_bwd
    7,000."""
    ops, t = [], t0

    def op(name, ns):
        nonlocal t
        ops.append((name, t, t + ns, corr))
        t += ns

    def mark(close, open_):
        op(MARK.format(close, open_) if marks else "elementwise", 1000)

    mark(0, 6)                                 # the normals
    op("index_put", 1500)
    t += 500                                   # idle inside the shading
    mark(6, 0)
    mark(0, 6)                                 # the diffuse term
    op("mul", 1000)
    mark(6, 0)
    mark(0, 6)                                 # the specular term
    op("pow", 1500)
    mark(6, 0)
    mark(0, 1)
    op("elementwise", 3000)
    t += 2000                                  # idle inside the clip
    op("DeviceRadixSortOnesweepKernel", 1000)
    mark(1, 0)
    mark(0, 2)
    op("setup", 4000)
    mark(2, 3)
    op("cummax", 5000)
    t += 1000                                  # idle inside the binning
    mark(3, 4)
    op("raster_fwd_packed", 2000)
    mark(4, 0)
    mark(0, 7)                                 # the texture lookup
    op("index_select", 2000)
    mark(7, 0)
    op("loss", 500)
    mark(0, 8)                                 # the texture gradient
    op("index_add", 3000)
    t += 1000                                  # idle inside the scatter
    mark(8, 0)
    mark(0, 5)
    op("packed_bwd", 7000)
    mark(5, 0)
    op("adam", 500)
    return ops


def _window(replays=None, steps=4):
    """Two profiler sessions of two replays each (correlations 1-4)."""
    replays = replays or {}
    sessions = [[op for corr in (1, 2)
                 for op in replays.get(corr, _replay(corr * 100_000, corr))],
                [op for corr in (3, 4)
                 for op in replays.get(corr, _replay(corr * 100_000
                                                     + 10**6, corr))]]
    launches = {corr: "cudaGraphLaunch" for corr in (1, 2, 3, 4)}
    return Window(sessions, launches, steps, 0.01, set())


def _read(metric, window):
    return importlib.import_module(f"benchmark.layers.{metric}").read(
        {"window": window, "forward_ms": None, "covered": None,
         "cell": None})


@pytest.mark.parametrize("metric,ms", [("clip_ms", 0.006),
                                       ("binning_ms", 0.006),
                                       ("raster_bwd_ms", 0.007),
                                       ("shade_ms", 0.0045),
                                       ("texture_ms", 0.002),
                                       ("texture_grad_ms", 0.004)])
def test_stage_readers_split_at_markers(metric, ms):
    window = _window()
    assert window.complete()
    assert _read(metric, window) == pytest.approx(ms)
    stage = metric[:-3]
    assert trace.span_ms(window.ops, window.launches, stage) == \
        pytest.approx(ms)


def _swap(ops, old, new):
    return [(new if name == old else name, *rest) for name, *rest in ops]


@pytest.mark.parametrize("metric,ms", [("clip_ms", 0.006),
                                       ("binning_ms", 0.006),
                                       ("raster_bwd_ms", 0.007),
                                       ("shade_ms", 0.0045),
                                       ("texture_ms", 0.002),
                                       ("texture_grad_ms", 0.004)])
def test_stage_readers_sum_a_stage_run_twice_in_a_replay(metric, ms):
    """A replay that runs the raster op twice (two views, two slabs) opens
    each span twice: the reader sums both per replay."""
    twice = {c: _replay(t, c) + _replay(t + 50_000, c)
             for c, t in ((1, 100_000), (2, 200_000), (3, 1_300_000),
                          (4, 1_400_000))}
    window = _window(twice)
    assert window.complete()
    assert _read(metric, window) == pytest.approx(2 * ms)


@pytest.mark.parametrize("metric", ["clip_ms", "binning_ms",
                                    "raster_bwd_ms", "shade_ms",
                                    "texture_ms", "texture_grad_ms"])
@pytest.mark.parametrize("fault", ["incomplete", "missing", "doubled",
                                   "unclosed", "no markers"])
def test_stage_readers_read_nothing_from_a_faulty_window(metric, fault):
    opening = {"clip_ms": MARK.format(0, 1), "binning_ms": MARK.format(2, 3),
               "raster_bwd_ms": MARK.format(0, 5),
               "shade_ms": MARK.format(0, 6),
               "texture_ms": MARK.format(0, 7),
               "texture_grad_ms": MARK.format(0, 8)}[metric]
    if fault == "incomplete":
        window = _window(steps=5)
        assert not window.complete()
    elif fault == "missing":
        window = _window({2: _swap(_replay(200_000, 2), opening,
                                   "elementwise")})
    elif fault in ("doubled", "unclosed"):
        closing = {"clip_ms": MARK.format(1, 0),
                   "binning_ms": MARK.format(3, 4),
                   "raster_bwd_ms": MARK.format(5, 0),
                   "shade_ms": MARK.format(6, 0),
                   "texture_ms": MARK.format(7, 0),
                   "texture_grad_ms": MARK.format(8, 0)}[metric]
        swapped = ((opening, closing) if fault == "doubled"
                   else (closing, "elementwise"))
        window = _window({3: _swap(_replay(1_300_000, 3), *swapped)})
    else:
        window = _window({c: _replay(c * 100_000 + (c > 2) * 10**6, c,
                                     marks=False) for c in (1, 2, 3, 4)})
    assert window.complete() == (fault != "incomplete")
    assert _read(metric, window) is None


@pytest.mark.parametrize("snapshot,pct", [({"fill.pool": 0.25}, 25.0),
                                          ({"fill.pool": 1.0}, 100.0),
                                          ({"fill.work": 0.5}, None),
                                          ({}, None)])
def test_pool_use_pct_reads_the_pool_fill(monkeypatch, snapshot, pct):
    monkeypatch.setattr(trace, "counters", lambda: dict(snapshot))
    got = _read("pool_use_pct", _window())
    assert got == pct
    assert _read("pool_use_pct", _window(steps=5)) is None


@pytest.mark.parametrize("snapshot,pct", [({"fill.tile": 0.8}, 80.0),
                                          ({"fill.pool": 0.5}, None),
                                          ({}, None)])
def test_tile_cap_use_pct_reads_the_tile_fill(monkeypatch, snapshot, pct):
    monkeypatch.setattr(trace, "counters", lambda: dict(snapshot))
    assert _read("tile_cap_use_pct", _window()) == pct
    assert _read("tile_cap_use_pct", _window(steps=5)) is None


@pytest.mark.parametrize("snapshot,pct", [({"fill.bin": 0.5}, 50.0),
                                          ({"fill.tile": 0.8}, None),
                                          ({}, None)])
def test_bin_cap_use_pct_reads_the_dense_bin_fill(monkeypatch, snapshot,
                                                  pct):
    monkeypatch.setattr(trace, "counters", lambda: dict(snapshot))
    assert _read("bin_cap_use_pct", _window()) == pct
    assert _read("bin_cap_use_pct", _window(steps=5)) is None


def test_registry_readers_read_nothing_without_a_card():
    trace.reset()
    assert _read("pool_use_pct", _window()) is None
    assert _read("tile_cap_use_pct", _window()) is None
    assert _read("bin_cap_use_pct", _window()) is None


def test_readers_read_nothing_from_a_program_without_the_registry(
        monkeypatch):
    monkeypatch.setitem(sys.modules, "dirt_tpu_torch.utils.trace", None)
    monkeypatch.delattr(dirt_tpu_torch.utils, "trace")
    for metric in ("clip_ms", "binning_ms", "raster_bwd_ms", "shade_ms",
                   "texture_ms", "texture_grad_ms", "pool_use_pct",
                   "tile_cap_use_pct", "bin_cap_use_pct"):
        assert _read(metric, _window()) is None


# --- 4. on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_step(device, engine="packed", clip=True):
    """(step, args): a fwd+bwd step of the raster op on the 24 x 32 sphere
    at 128 x 256, ``step(verts, colors) -> (pixels, fid, overflow,
    d_verts, d_colors)``."""
    verts, colors, faces = sphere_scene(24, 32, distance=0.9 if clip
                                        else 3.0)
    bg, verts, colors, faces = convert.scene_from_numpy(
        np.zeros((128, 256, 3), np.float32), verts, colors, faces, device)
    weights = torch.rand(128, 256, 3, generator=torch.Generator()
                         .manual_seed(1)).to(device)
    config = dirt_tpu_torch.suggest_raster_config(
        verts, faces, 128, 256, config=RasterConfig(**ENGINES[engine]),
        clip=clip)

    def step(v, c):
        v, c = (t.detach().requires_grad_() for t in (v, c))
        pixels, fid, _, overflow = dirt_tpu_torch.rasterise_with_aux(
            bg, v, c, faces, config=config, clip=clip)
        grads = torch.autograd.grad((pixels * weights).sum(), (v, c))
        return (pixels.detach(), fid, overflow, *grads)

    return step, (verts, colors)


def _profiled_replay(step, args, cpu=False):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu
                                            else [])
    step(*args)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        step(*args)
        torch.cuda.synchronize()
    return Window.from_profile(prof, 1, 0.0), prof


@pytest.mark.cuda
def test_a_replay_shows_each_marker_once_in_order(cuda):
    step, args = _card_step(cuda)
    graphed = GraphedStep(step, args)
    window, _ = _profiled_replay(graphed, args)
    assert window.complete()
    got = [trace.marker(op[0]) for op in window.ops
           if trace.marker(op[0]) is not None]
    assert got == STEP_MARKS
    for name in RASTER_SPANS:
        assert trace.span_ms(window.ops, window.launches, name) > 0


@pytest.mark.cuda
def test_a_host_span_encloses_its_graph_launch(cuda):
    step, args = _card_step(cuda)
    graphed = GraphedStep(step, args)
    _, prof = _profiled_replay(graphed, args, cpu=True)
    launches = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "cudaGraphLaunch"]
    assert len(launches) == 1
    span = trace.host_spans()[-1]
    event = launches[0]
    assert span.entry <= span.launch <= span.done
    assert span.entry <= event.start_ns() and event.end_ns() <= span.done, (
        span, event.start_ns(), event.end_ns())


@pytest.mark.cuda
def test_pool_fill_is_the_eager_share_and_outlives_its_graph(cuda,
                                                             monkeypatch):
    step, args = _card_step(cuda, clip=False)
    made = []
    real = raster.binning.bin_faces_packed

    def bin_packed(*a, **kw):
        made.append((real(*a, **kw), kw))
        return made[-1][0]

    trace.reset()
    with monkeypatch.context() as patch:
        patch.setattr(raster.binning, "bin_faces_packed", bin_packed)
        step(*args)
    (bins, kwargs), = made
    cap = -(-kwargs["pool_cap"] // binning.POOL_ALIGN) * binning.POOL_ALIGN
    want = float(bins.pool_offs[-1]) * binning.POOL_ALIGN / cap
    fills = trace.counters()
    assert fills["fill.pool"] == pytest.approx(want, rel=1e-6)
    assert 0 < fills["fill.expand"] <= 1 and 0 < fills["fill.budget"] <= 1
    graphed = GraphedStep(step, args)
    counts = trace.counters()
    assert counts["graphstep.captures"] == 1
    assert counts["graphstep.capture_s"] > 0
    trace.reset()
    assert "fill.pool" not in trace.counters()
    graphed(*args)                        # a replay alone writes the fill
    del graphed
    gc.collect()
    torch.cuda.empty_cache()
    counts = trace.counters()
    assert counts["fill.pool"] == pytest.approx(want, rel=1e-6)
    assert counts["graphstep.replays"] == 1
    assert "graphstep.captures" not in counts
    assert "launch.raster_fwd_packed" not in counts   # a replay counts none


@pytest.mark.cuda
def test_csr_fills_are_the_host_counts_and_leave_the_packed_ones(
        cuda, monkeypatch):
    made = []
    real = raster.binning.bin_faces_csr

    def bin_csr(*args):
        made.append(args)
        return real(*args)

    trace.reset()
    step, args = _card_step(cuda, "csr")
    with monkeypatch.context() as patch:
        patch.setattr(raster.binning, "bin_faces_csr", bin_csr)
        step(*args)
    (call,) = made
    want = csr_fills(call)
    counts = trace.counters()
    assert counts["fill.tile"] == pytest.approx(want["tile"], rel=1e-6)
    assert counts["fill.expand"] == pytest.approx(want["expand"], rel=1e-6)
    assert not {"fill.pool", "fill.work", "fill.budget"} & set(counts)
    graphed = GraphedStep(step, args)
    trace.reset()
    graphed(*args)                        # a replay alone writes the fills
    counts = trace.counters()
    assert counts["fill.tile"] == pytest.approx(want["tile"], rel=1e-6)
    # A packed step writes its four slots and leaves the tile's.
    packed, packed_args = _card_step(cuda, clip=False)
    trace.reset()
    packed(*packed_args)
    counts = trace.counters()
    assert "fill.tile" not in counts
    assert 0 < counts["fill.pool"] <= 1 and 0 < counts["fill.expand"] <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("engine", list(ENGINES))
def test_markers_change_no_bits(cuda, monkeypatch, engine):
    step, args = _card_step(cuda, engine)
    marked = [t.clone() for t in GraphedStep(step, args)(*args)]
    monkeypatch.setattr(trace, "_mark", lambda close, open_, like: None)
    bare = GraphedStep(step, args)(*args)
    for got, want in zip(bare, marked):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_a_graphed_dense_step_leaves_the_bin_fill(cuda, monkeypatch):
    """The dense binning's fill is the host count of an eager call's
    arguments, in (0, 1], and a replay alone writes it again; no other
    engine's slot is written."""
    made = []
    real = raster.binning.bin_faces

    def bin_dense(*args):
        made.append(args)
        return real(*args)

    step, args = _card_step(cuda, "dense")
    trace.reset()
    with monkeypatch.context() as patch:
        patch.setattr(raster.binning, "bin_faces", bin_dense)
        step(*args)
    (call,) = made
    want = dense_fill(call)
    counts = trace.counters()
    assert 0 < counts["fill.bin"] <= 1
    assert counts["fill.bin"] == pytest.approx(want, rel=1e-6)
    assert not {"fill.pool", "fill.work", "fill.expand", "fill.budget",
                "fill.tile"} & set(counts)
    graphed = GraphedStep(step, args)
    trace.reset()
    graphed(*args)                        # a replay alone writes the fill
    assert trace.counters()["fill.bin"] == pytest.approx(want, rel=1e-6)


def _shaded_forward(device, cell):
    """(forward, args): the graphable forward of a benchmark cell's
    pipeline at 128 x 128 on ``uv_sphere(24, 48)`` (the dense engine) at
    its true parameters, under caps suggested for them."""
    from benchmark import harness, inputs
    from benchmark.scenes import scene_arrays

    loaded = harness.load_cell(cell)
    config = dict(loaded.config, size=128, faces=2208,
                  mesh={"kind": "uv_sphere", "n_lat": 24, "n_lon": 48})
    pipe = loaded.pipeline
    scene = pipe.scene(config, scene_arrays(config), device)
    names = ("light", "pose") if config["pipeline"] == "lit" else ("pose",)
    params = {name: pipe.true_value(name, config, scene) for name in names}
    caps = inputs.suggested_caps(pipe, config, scene, [params])

    def forward(*values):
        with torch.no_grad():
            return pipe.render(config, scene, caps,
                               dict(zip(names, values)))["image"]

    return forward, tuple(params.values())


@pytest.mark.cuda
@pytest.mark.parametrize("cell,calls", [("lit512.fit", 3),
                                        ("deferred10k.fit", 1)])
def test_a_shaded_forward_carries_paired_shade_markers(cuda, cell, calls):
    """A replay of the lit pipeline's forward shows a ``shade`` pair for
    the normals, the diffuse and the specular calls, the deferred
    pipeline's one for its normals, then the raster op's forward markers,
    and the deferred pipeline's ``texture`` pair after them; ``span_ms``
    reads the shading's time."""
    forward, args = _shaded_forward(cuda, cell)
    graphed = GraphedStep(forward, args)
    window, _ = _profiled_replay(graphed, args)
    assert window.complete()
    got = [trace.marker(op[0]) for op in window.ops
           if trace.marker(op[0]) is not None]
    textured = TEXTURE_MARKS if cell == "deferred10k.fit" else []
    assert got == SHADE_MARKS * calls + STEP_MARKS[:6] + textured
    assert trace.span_ms(window.ops, window.launches, "shade") > 0


@pytest.mark.cuda
def test_a_graphed_textured_step_carries_its_markers_every_replay(cuda):
    """Three replays of a graphed fit step of the textured pipeline at
    128 x 128, profiled in one session: every replay shows the raster op's
    forward markers, the ``texture`` pair, the ``texture_grad`` pair once
    and the raster op's backward pair, and ``span_ms`` reads both texture
    spans above 0; the replay's outputs are the eager step's."""
    from torch.profiler import ProfilerActivity, profile

    step, args = _textured_step(cuda, 128)
    eager = step(*args)
    graphed = GraphedStep(step, args)
    graphed(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            out = graphed(*args)
        torch.cuda.synchronize()
    window = Window.from_profile(prof, 3, 0.0)
    assert window.complete()
    replays = {}
    for op in window.ops:
        if window.launches.get(op[3]) == "cudaGraphLaunch":
            replays.setdefault(op[3], []).append(op)
    assert len(replays) == 3
    want = (STEP_MARKS[:6] + TEXTURE_MARKS + TEXTURE_GRAD_MARKS
            + STEP_MARKS[6:])
    for ops in replays.values():
        ops.sort(key=lambda op: op[1])
        assert [trace.marker(op[0]) for op in ops
                if trace.marker(op[0]) is not None] == want
    for name in ("texture", "texture_grad"):
        assert trace.span_ms(window.ops, window.launches, name) > 0
    torch.testing.assert_close(out[0], eager[0], rtol=0, atol=0)
    for got, ref in zip(out[1:], eager[1:]):
        torch.testing.assert_close(got, ref, rtol=1e-5,
                                   atol=1e-6 * float(ref.abs().max()))


# Last in the file: the profiler windows it takes come after every other
# profile the card tests read.
@pytest.mark.cuda
def test_replays_profiled_after_a_tools_windows_keep_or_flag_markers(cuda):
    """The stage tool's run with its profiler windows (one a stage, host
    and device activity, on the bench sphere at 1024 x 1024), then three
    sessions of three replays each as the benchmark traces them (device
    activity): in each session every replay with the most operations
    shows each marker once, in order, and the window counts as complete
    only when all three show that many. A single-replay profile taken
    after such windows once lost its first marker record, and one replay
    has nothing to be held against; in a session of several, a replay
    that loses a record shows fewer operations, and the benchmark sets
    the session aside."""
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import card_common
    import prof_torch_stages

    _, verts, _, faces, _, _ = card_common.bench_scene(1024, cuda)
    config = dirt_tpu_torch.suggest_raster_config(verts, faces, 1024, 1024,
                                                  clip=False)
    prof_torch_stages.run(cuda, 1024, 72, 1, config,
                          card_common.PROFILE_STEPS)
    step, args = _card_step(cuda)
    graphed = GraphedStep(step, args)
    for _ in range(3):
        graphed(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                graphed(*args)
            torch.cuda.synchronize()
        window = Window.from_profile(prof, 3, 0.0)
        counts = window.replays()
        assert len(counts) == 3
        replays = {}
        for op in window.ops:
            if window.launches.get(op[3]) == "cudaGraphLaunch":
                replays.setdefault(op[3], []).append(op)
        for ops in replays.values():
            if len(ops) == max(counts):
                assert [trace.marker(op[0]) for op in ops
                        if trace.marker(op[0]) is not None] == STEP_MARKS
        assert window.complete() == (min(counts) == max(counts))


# After the windows above: a profile, even of host operators alone, taken
# before a replay's markers are read has cost that read its first record.
@pytest.mark.cuda
def test_packed_step_makes_no_row_gather_on_card(cuda):
    """One packed forward and backward of the bench sphere at 1024 x 1024,
    recorded by ``torch.profiler`` with ``record_shapes=True``: no index or
    gather operator reads the face table ([F + 1, W]), and, from every
    operator's outputs under a dispatch mode (the profiler records no
    output shapes), none makes an array of ``budget_rows`` rows; K1 and K2
    launched once each."""
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import card_common
    from _torch_port_scene import budget_row_gathers
    from dirt_tpu_torch.ops import raster_fwd

    _, verts, colors, faces, background, weights = card_common.bench_scene(
        1024, cuda)
    config = dirt_tpu_torch.suggest_raster_config(verts, faces, 1024, 1024,
                                                  clip=False)

    def step():
        return card_common.render_grads(
            dirt_tpu_torch.rasterise_with_aux, background, verts, colors,
            faces, weights, config, False)

    ((table2, bins, _), _), = card_common.calls(
        raster_fwd, "raster_forward_packed", step)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        _, counts = card_common.launched(step)
    assert counts["raster_fwd_packed"] == counts["packed_bwd"] == 1
    gathers = [e for e in prof.events() if e.name in (
        "aten::index", "aten::index_select", "aten::gather", "aten::take")]
    assert gathers
    assert [e.input_shapes for e in gathers if e.input_shapes
            and list(e.input_shapes[0]) == list(table2.shape)] == []
    assert budget_row_gathers(step, bins.entries.shape[0]) == []
