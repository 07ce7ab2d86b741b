"""The port's tracing (``dirt_tpu_torch.utils.trace``) and the benchmark's
readers of it (``benchmark/layers/``).

On the CPU: the registry's count, maximum, snapshot and reset; stage spans
as no-ops on CPU tensors; the span and switch logic, and the raster op's
stage sites on every engine, with the card check and the marker launch
replaced by a recorder (the markers each site would launch, in order, and
the cap fills on the binning's closing marker); ``GraphedStep``'s counters
untouched on the CPU path; the markers the kernel file instantiates; each
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
outlives the graph that wrote it; and a step with the markers stubbed out
gives the same bits.
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
from dirt_tpu_torch import convert
from dirt_tpu_torch.ops import binning, raster
from dirt_tpu_torch.ops.raster import RasterConfig
from dirt_tpu_torch.utils import trace
from dirt_tpu_torch.utils.graphstep import GraphedStep

# The markers of one fwd+bwd step of the raster op, in order.
STEP_MARKS = [(None, "clip"), ("clip", None), (None, "setup"),
              ("setup", "binning"), ("binning", "raster_fwd"),
              ("raster_fwd", None), (None, "raster_bwd"),
              ("raster_bwd", None)]
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
    assert [trace.marker(MARK.format(c, o)) for c, o in got] == STEP_MARKS


def test_a_marker_outside_marks_raises_before_any_launch():
    assert [trace.mark_ids(c, o) for c, o in STEP_MARKS] == \
        list(trace.MARKS)
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


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("clip", [True, False])
def test_raster_op_marks_its_stages(marks, monkeypatch, engine, clip):
    """A fwd+bwd step launches the stages' markers in order, eight with
    the clip and six without, and the packed binning's closing marker
    carries its cap fills: the pool's is sum(blocks) * POOL_ALIGN /
    pool_cap."""
    bg, verts, colors, faces, config = _scene(engine, clip)
    marks.clear()                         # the counting's own clip
    made = []
    real = binning.bin_faces_packed

    def bin_packed(*args, **kwargs):
        made.append((real(*args, **kwargs), kwargs))
        return made[-1][0]

    monkeypatch.setattr(raster.binning, "bin_faces_packed", bin_packed)
    verts = verts.clone().requires_grad_()
    pixels = dirt_tpu_torch.rasterise(bg, verts, colors, faces,
                                      config=config, clip=clip)
    pixels.sum().backward()
    want = STEP_MARKS if clip else STEP_MARKS[2:]
    assert [(c, o) for c, o, _ in marks] == want
    fills = [shares for _, _, shares in marks if shares]
    if engine != "packed":
        assert fills == [] and made == []
        return
    (bins, kwargs), = made
    assert marks[want.index(("binning", "raster_fwd"))][2] is fills[0]
    cap = -(-kwargs["pool_cap"] // binning.POOL_ALIGN) * binning.POOL_ALIGN
    assert fills[0]["pool"] == pytest.approx(
        float(bins.pool_offs[-1]) * binning.POOL_ALIGN / cap)
    assert set(fills[0]) == ({"pool", "work", "expand", "budget"}
                             if kwargs["work_cap"] is not None
                             else {"pool", "expand", "budget"})
    assert all(0 < share <= 1 for share in fills[0].values())
    assert trace._OPEN.stack == [] and trace._OPEN.fills is None


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
    """One replay's device operations from ``t0`` ns: every stage between
    its markers, with idle time inside the clip and the binning. Stage
    times: clip 6,000 ns, binning 6,000, raster_bwd 7,000."""
    ops, t = [], t0

    def op(name, ns):
        nonlocal t
        ops.append((name, t, t + ns, corr))
        t += ns

    def mark(close, open_):
        op(MARK.format(close, open_) if marks else "elementwise", 1000)

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
    op("loss", 500)
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
                                       ("raster_bwd_ms", 0.007)])
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
                                       ("raster_bwd_ms", 0.007)])
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
                                    "raster_bwd_ms"])
@pytest.mark.parametrize("fault", ["incomplete", "missing", "doubled",
                                   "unclosed", "no markers"])
def test_stage_readers_read_nothing_from_a_faulty_window(metric, fault):
    opening = {"clip_ms": MARK.format(0, 1), "binning_ms": MARK.format(2, 3),
               "raster_bwd_ms": MARK.format(0, 5)}[metric]
    if fault == "incomplete":
        window = _window(steps=5)
        assert not window.complete()
    elif fault == "missing":
        window = _window({2: _swap(_replay(200_000, 2), opening,
                                   "elementwise")})
    elif fault in ("doubled", "unclosed"):
        closing = {"clip_ms": MARK.format(1, 0),
                   "binning_ms": MARK.format(3, 4),
                   "raster_bwd_ms": MARK.format(5, 0)}[metric]
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


def test_registry_readers_read_nothing_without_a_card():
    trace.reset()
    assert _read("pool_use_pct", _window()) is None


def test_readers_read_nothing_from_a_program_without_the_registry(
        monkeypatch):
    monkeypatch.setitem(sys.modules, "dirt_tpu_torch.utils.trace", None)
    monkeypatch.delattr(dirt_tpu_torch.utils, "trace")
    for metric in ("clip_ms", "binning_ms", "raster_bwd_ms",
                   "pool_use_pct"):
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
    for name in trace.SPANS:
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
@pytest.mark.parametrize("engine", list(ENGINES))
def test_markers_change_no_bits(cuda, monkeypatch, engine):
    step, args = _card_step(cuda, engine)
    marked = [t.clone() for t in GraphedStep(step, args)(*args)]
    monkeypatch.setattr(trace, "_mark", lambda close, open_, like: None)
    bare = GraphedStep(step, args)(*args)
    for got, want in zip(bare, marked):
        assert torch.equal(got, want)
