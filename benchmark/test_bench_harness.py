"""CPU tests of the benchmark's harness and reference.

    python -m pytest benchmark/test_bench_harness.py --noconftest -q -p no:cacheprovider

(``--noconftest``: the repo's root ``conftest.py`` loads JAX.) Tiny cells
run through :func:`harness.run_cell` on the CPU, where the port's kernels'
plain versions stand in and ``GraphedStep`` calls its step eagerly. The
control and the planted faults must come out not correct under each cell's
own limits. The ``cuda`` test runs a real cell on a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import check, faults, harness, roofline
from benchmark.reference import raster

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 31 + 11


def tiny(name, n_lat=8, n_lon=12, size=48):
    """The cell ``name`` cut to a CPU-sized scene and mix."""
    cell = harness.load_cell(name)
    cell.config = dict(cell.config, size=size, faces=2 * n_lat * n_lon
                       - 2 * n_lon, mesh={"kind": "uv_sphere",
                                          "n_lat": n_lat, "n_lon": n_lon})
    if cell.mix["loop"] == "fit":
        last = max(cell.mix["check_from"]) + 2
        cell.mix = dict(cell.mix, steps_per_fit=max(5, last), starts=2,
                        trace_steps=3, forward_replays=2)
    else:
        cell.mix = dict(cell.mix, poses=4, sample_within=3, sampled_frames=2,
                        trace_steps=3)
    return cell


def run(cell, trace=False, seed=SEED):
    return harness.run_cell(cell, seed, 0.2, trace, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = harness.load_cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert hasattr(cell.loop, "build") and hasattr(cell.loop, "check_run")
    assert hasattr(cell.pipeline, "render")
    assert hasattr(cell.reference, "prepare")
    reported = {m["name"] for m in cell.end_to_end}
    for metric in cell.per_layer:
        assert callable(harness.reader(metric["name"]).read)
        assert metric["moves"] in reported
    assert set(check.limits(name)) >= {"failed_steps", "fid_mismatch"}
    assert {"step_ms", "peak_mem_mib", "setup_s"} <= {
        harness.quantity(m) for m in reported}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_prints_a_correct_line(name, trace):
    result = harness.plain(run(tiny(name), trace))
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    if not trace:
        assert {"setup_s", "step_ms"} <= {harness.quantity(m)
                                          for m in line["metrics"]}
    else:
        # The CPU runs no graph replay and traces no device operation:
        # every reader finds nothing to read and returns None.
        assert line["metrics"] == {}
    for entry in line["checks"].values():
        assert entry["value"] <= entry["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    # The control's gaps grow with the faces' density on the screen: the
    # 10,224-face sphere at 256^2.
    cell = tiny(name, 72, 72, 256)
    loop = cell.loop.build(cell, SEED, "cpu", False)
    for _ in range(4):
        loop.step()
    numbers = cell.loop.control(cell, loop.close(), "cpu")
    numbers["failed_steps"] = 0
    correct, table = check.judge(numbers, check.limits(name))
    assert not correct, table


FAULTS = {w["name"]: json.loads((ROOT / "benchmark" / "traffic"
                                 / f"{w['traffic']}.json").read_text())
          ["faults"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS for fault in FAULTS[name]])
def test_planted_fault_is_not_correct(name, fault):
    cell = tiny(name)
    undo = faults.FAULTS[fault](cell)
    try:
        result = run(cell)
    finally:
        undo()
    assert result["correct"] is False, result["checks"]


def test_roofline_counts_a_hand_worked_scene():
    cell = harness.load_cell("sphere1m.fit")
    cell.config = dict(cell.config, size=4, channels=3, faces=6,
                       mesh={"kind": "uv_sphere", "n_lat": 2, "n_lon": 3})
    # 12 vertices (12 x 3 x 4 B), 6 faces (6 x 3 x 8 B); pose 3 and 12 x 3
    # colours (156 B); 16 pixels x (3 + id + depth) x 4 B out; the target
    # and the upstream gradient 16 x 3 x 4 B each; gradients, moments read
    # and written, parameters written: 6 x 156 B.
    assert roofline.step_work(cell, 10) == (
        144 + 144 + 156 + 320 + 192 + 192 + 936,
        10 * (22 + 6 + 15 + 330 + 18 + 12 + 9))
    cell.mix = {"loop": "render"}
    assert roofline.step_work(cell, 10) == (144 + 144 + 12 + 320, 10 * 43)
    assert roofline.least_ms(cell, 10) == pytest.approx(620 / 3.35e12 * 1e3)


def test_reference_z_buffer_on_two_triangles():
    # A at depth 0.5 covers centres with i + j <= 3, B at 0.2 those with
    # i + j >= 3: B wins the diagonal.
    fv = torch.tensor([[[0, 0, 0.5, 1], [4, 0, 0.5, 1], [0, 4, 0.5, 1]],
                       [[4, 0, 0.2, 1], [4, 4, 0.2, 1], [0, 4, 0.2, 1]]],
                      dtype=torch.float64)
    fid, zbuf = raster.rasterise(fv, 4, 4)
    i, j = torch.meshgrid(torch.arange(4), torch.arange(4), indexing="ij")
    assert torch.equal(fid, torch.where(i + j <= 2, 0, 1))
    assert torch.allclose(zbuf, torch.where(i + j <= 2, 0.5, 0.2).double())
    fa = torch.tensor([[[1.0]] * 3, [[2.0]] * 3], dtype=torch.float64)
    pixels = raster.interpolate(fv, fa, fid, torch.zeros(4, 4, 1,
                                                         dtype=torch.float64),
                                "float64")
    assert torch.allclose(pixels[..., 0], (fid + 1).double())


def test_reference_gradients_on_a_silhouette():
    # One triangle whose right edge is x = 2.2 over a 1 x 4 row: pixels 0
    # and 1 show it (colour 1), 2 and 3 the background (0). With g = 1,
    # S = 1 on the pair (1, 2); the edge E = 10 (2.2 - x) crosses at x* =
    # 2.2, so d(A, B, C) = (0.22, 0.05, 0.1), which reaches vertex 1's x
    # as -dB + 5 dC = 0.45 and vertex 2's as dB + 5 dC = 0.55; the
    # interior term of a constant colour is 0.
    fv = torch.tensor([[[-5, -5, 0.5, 1], [2.2, -5, 0.5, 1],
                        [2.2, 5, 0.5, 1]]], dtype=torch.float64,
                      requires_grad=True)
    fa = torch.ones(1, 3, 1, dtype=torch.float64)
    background = torch.zeros(1, 4, 1, dtype=torch.float64)
    fid, zbuf = raster.rasterise(fv, 1, 4)
    assert fid.tolist() == [[0, 0, -1, -1]]
    pixels = raster.interpolate(fv, fa, fid, background, "float64")
    assert pixels[..., 0].tolist() == [[1.0, 1.0, 0.0, 0.0]]
    upstream = torch.ones_like(pixels)
    total = (torch.sum(pixels * upstream)
             + raster.edge_surrogate(fv, fid, zbuf, pixels, upstream))
    grad, = torch.autograd.grad(total, fv)
    expect = torch.zeros_like(grad)
    expect[0, 1, 0], expect[0, 2, 0] = 0.45, 0.55
    assert torch.allclose(grad, expect, atol=1e-12)


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_jax_after_a_run():
    loaded = _loaded(
        "import json, sys, time\n"
        "sys.path.insert(0, 'benchmark')\n"
        "from benchmark import harness\n"
        "from test_bench_harness import tiny\n"
        "for name in [w['name'] for w in json.load(open('BENCHMARK.json'))"
        "['workloads']]:\n"
        "    cell = tiny(name)\n"
        "    for trace in (False, True):\n"
        "        harness.run_cell(cell, 5, 0.1, trace, 'cpu',"
        " time.perf_counter())\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert not {"jax", "jaxlib", "flax", "dirt_tpu"} & set(loaded)
    assert "dirt_tpu_torch" in loaded


def test_reference_imports_nothing_of_the_port():
    loaded = _loaded(
        "import json, sys, pkgutil, importlib\n"
        "import benchmark.reference as ref\n"
        "for m in pkgutil.iter_modules(ref.__path__):\n"
        "    importlib.import_module('benchmark.reference.' + m.name)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert not {"dirt_tpu_torch", "dirt_tpu", "jax"} & set(loaded)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "deferred10k.render", "--seed", str(SEED), "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
