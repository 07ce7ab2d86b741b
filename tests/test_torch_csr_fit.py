"""The benchmark's ``sphere100k.fit`` cell: a fit through the public API's
defaults (``clip=True``) on a mesh above ``STREAMING_FACES``, which the
streaming (CSR) engine renders, and the least times of its two kernels
(``benchmark/kernel_roofline.py``).

On the CPU the port's kernels' plain versions stand in and
``GraphedStep`` calls its step eagerly; the cell is cut to
``uv_sphere(92, 92)`` (16,744 faces, just above 16,384) at 64 x 64, so
that ``suggest_raster_config`` picks the CSR engine by itself. The cut
comes out correct under the cell's own limits; the TF32 control and each
planted fault of its mix do not.
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import check, faults, harness, kernel_roofline
from benchmark.pipelines import vertex_color
from benchmark.scenes import scene_arrays
from benchmark.trace import Window
from dirt_tpu_torch.ops import raster

CELL = "sphere100k.fit"
SEED = 2 ** 33 + 17


def cut():
    """The cell on ``uv_sphere(92, 92)`` at 64 x 64, fits of 5 steps."""
    cell = harness.load_cell(CELL)
    cell.config = dict(cell.config, size=64, faces=16744,
                       mesh={"kind": "uv_sphere", "n_lat": 92, "n_lon": 92})
    cell.mix = dict(cell.mix, steps_per_fit=5, starts=2, trace_steps=3,
                    forward_replays=2)
    return cell


@pytest.fixture
def routes(monkeypatch):
    """The prepare calls of the raster op, by engine."""
    calls = []
    for engine in ("csr", "packed", "dense"):
        real = getattr(raster, f"prepare_{engine}")

        def spy(*args, _real=real, _engine=engine, **kwargs):
            calls.append(_engine)
            return _real(*args, **kwargs)

        monkeypatch.setattr(raster, f"prepare_{engine}", spy)
    return calls


def _suggested(config, clip):
    import dirt_tpu_torch

    scene = vertex_color.scene(config, scene_arrays(config), "cpu")
    params = {"pose": vertex_color.true_value("pose", config, scene)}
    with torch.no_grad():
        return dirt_tpu_torch.suggest_raster_config(
            vertex_color.clip_vertices(config, scene, params),
            scene["faces"], config["size"], config["size"], clip=clip)


def test_the_configuration_streams_with_the_default_clip():
    config = harness.load_cell(CELL).config
    assert config["clip"] is True and config["faces"] > raster.STREAMING_FACES
    suggested = _suggested(config, clip=True)
    assert suggested.streaming is True
    assert raster.resolve_engine(suggested, config["faces"]) == "csr"
    assert raster.streams(suggested, config["faces"])
    # bench.py's clip=False renders the same mesh with the packed engine.
    packed = _suggested(config, clip=False)
    assert raster.resolve_engine(packed, config["faces"]) == "packed"
    assert not raster.streams(packed, config["faces"])


def test_a_cut_of_the_cell_is_correct_on_the_csr_route(routes):
    result = harness.run_cell(cut(), SEED, 0.2, False, "cpu",
                              time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert routes and set(routes) == {"csr"}


def test_the_control_of_the_cut_is_not_correct():
    cell = cut()
    loop = cell.loop.build(cell, SEED, "cpu", False)
    numbers = cell.loop.control(cell, loop.close(), "cpu")
    numbers["failed_steps"] = 0
    correct, table = check.judge(numbers, check.limits(CELL))
    assert not correct, table


@pytest.mark.parametrize("fault", harness.load_cell(CELL).mix["faults"])
def test_a_planted_fault_in_the_cut_is_not_correct(fault):
    cell = cut()
    undo = faults.FAULTS[fault](cell)
    try:
        result = harness.run_cell(cell, SEED, 0.2, False, "cpu",
                                  time.perf_counter())
    finally:
        undo()
    assert result["correct"] is False, result["checks"]


def test_kernel_roofline_counts_a_hand_worked_scene():
    cell = harness.load_cell(CELL)
    cell.config = dict(cell.config, faces=2, size=4, channels=3)
    # K7: 2 faces x (9 edge + 3 depth + 3 denominator + 9 attribute)
    # values; 16 pixels x 3 of background read; 16 x (3 + id + depth)
    # written; 4 B each.
    assert kernel_roofline.fwd_work(cell, 10) == (
        4 * (2 * 24 + 16 * 3 + 16 * 5), 10 * (22 + 6 + 15))
    # K8: 16 pixels x (id + depth + 3 values + 3 cotangents) read; 2 faces
    # x (9 edge + 3 denominator + 9 attribute) planes read and as many
    # cotangents written.
    assert kernel_roofline.bwd_work(cell, 10) == (
        4 * (16 * 8 + 2 * 2 * 21), 10 * (330 + 18 + 12 + 9))
    assert kernel_roofline.least_ms((704, 430)) == pytest.approx(
        704 / 3.35e12 * 1e3)


def _kernel_window(names, steps=2):
    """One profiler session of ``steps`` replays (correlations 1..steps),
    each running ``names`` for 1 us apiece after a 5 us glue kernel."""
    ops, t = [], 0
    for corr in range(1, steps + 1):
        for name, length in [("elementwise", 5000)] + [(n, 1000)
                                                       for n in names]:
            ops.append((name, t, t + length, corr))
            t += length
    launches = {corr: "cudaGraphLaunch" for corr in range(1, steps + 1)}
    return Window([ops], launches, steps, 1e-4, set())


@pytest.mark.parametrize("metric,kernels,work", [
    ("fwd_kernel_roofline", ["void cull_boxes_kernel(float const*, int)",
                             "void raster_fwd_csr_kernel(float const*)"],
     kernel_roofline.fwd_work),
    ("bwd_kernel_roofline",
     ["void (anonymous namespace)::fused_bwd_csr_partial_kernel<3, 8, 3>()",
      "void (anonymous namespace)::fused_bwd_csr_reduce_kernel(int const*)"],
     kernel_roofline.bwd_work)])
def test_kernel_roofline_readers_share_of_their_launches(metric, kernels,
                                                         work):
    cell = harness.load_cell(CELL)
    reader = harness.reader(metric)
    data = {"window": _kernel_window(kernels), "cell": cell,
            "covered": 300_000, "forward_ms": None}
    # Two kernels of 1 us a step: 0.002 ms.
    want = 100.0 * kernel_roofline.least_ms(work(cell, 300_000)) / 0.002
    assert reader.read(data) == pytest.approx(want)
    assert reader.read(dict(data, window=_kernel_window(kernels, 3)))\
        == pytest.approx(want)
    other = _kernel_window(["void raster_fwd_packed_kernel<3>()"])
    assert reader.read(dict(data, window=other)) is None
    incomplete = _kernel_window(kernels)
    incomplete.steps = 3
    assert reader.read(dict(data, window=incomplete)) is None
