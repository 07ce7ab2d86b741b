"""CPU tests of the benchmark's harness and reference.

    python -m pytest benchmark/test_bench_harness.py --noconftest -q -p no:cacheprovider

(``--noconftest``: the repo's root ``conftest.py`` loads JAX.) Tiny cells
run through :func:`harness.run_cell` on the CPU, where the port's kernels'
plain versions stand in and ``GraphedStep`` calls its step eagerly. The
control and the planted faults must come out not correct under each cell's
own limits. The ``cuda`` test runs a real cell on a card.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import check, faults, harness, inputs, roofline
from benchmark.reference import camera as cam
from benchmark.reference import raster, steps
from benchmark.reference.shading import sample_bilinear
from benchmark.scenes import scene_arrays, to_device

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


# A pipeline whose shading reads a trained parameter: a texture sampled
# per pixel at the rasterised UVs (upstream DIRT's samples/textured.py).
# Both sides live here, not under pipelines/, so that no cell runs them.

def _textured_clip(config, scene, params):
    model = cam.rodrigues(params["pose"]) @ scene["offset"]
    return cam.homogeneous(scene["verts"]) @ (model @ scene["projection"])


def _textured_scene(config, arrays, device):
    out = to_device({k: v for k, v in arrays.items() if k != "texture"},
                    device)
    out["texture_shape"] = tuple(config["texture_shape"])
    out["projection"] = cam.perspective(config["camera"], torch.float32,
                                        device)
    out["offset"] = cam.translation(config["camera"]["offset"],
                                    torch.float32, device)
    return out


def _textured_shape(name, scene):
    return (3,) if name == "pose" else scene["texture_shape"]


def _textured_true(name, config, scene):
    if name != "pose":
        raise ValueError(f"the textured pipeline has no true {name}")
    return torch.tensor(config["pose"], dtype=torch.float32,
                        device=scene["verts"].device)


def _textured_render(config, scene, raster_config, params):
    from dirt_tpu_torch.core.texture import sample_texture
    from dirt_tpu_torch.render.gbuffer import render_gbuffer

    size = config["size"]
    gb = render_gbuffer(_textured_clip(config, scene, params), scene["faces"],
                        {"uv": scene["uvs"]}, size, size,
                        config=raster_config, clip=config["clip"])
    image = sample_texture(params["texture"], gb["uv"]) * gb["mask"]
    return {"image": image, "fid": gb["fid"], "overflow": gb["overflow"],
            "gbuffer": None}


def _textured_prepare(config, inputs_, params, prec):
    verts, faces = inputs_["verts"], inputs_["faces"]
    camera, size = config["camera"], config["size"]
    matrix = cam.mm(cam.model_matrix(params["pose"], camera, prec),
                    cam.perspective(camera, verts.dtype, verts.device), prec)
    clip = cam.mm(cam.homogeneous(verts), matrix, prec)
    attrs = torch.cat([inputs_["uvs"], torch.ones_like(verts[:, :1])], 1)
    background = torch.zeros((size, size, 3), dtype=verts.dtype,
                             device=verts.device)

    def shade(gbuffer):
        return sample_bilinear(params["texture"], gbuffer[..., :2]) \
            * gbuffer[..., 2:]

    return raster.screen(clip, size, size)[faces], attrs[faces], background, \
        shade


TEXTURED = SimpleNamespace(
    INPUTS=("verts", "faces", "uvs"),
    shape=_textured_shape, true_value=_textured_true, scene=_textured_scene,
    clip_vertices=_textured_clip, render=_textured_render)
TEXTURED_REF = SimpleNamespace(prepare=_textured_prepare)

TEXTURED_MIX = {
    "loop": "fit", "steps_per_fit": 5, "starts": 2,
    "target": {"pose": "true", "texture": {"uniform": [0.0, 1.0]}},
    "init": {"pose": {"near_true": 0.05}, "texture": {"fill": 0.5}},
    "trained": {"texture": {"lr": [[1, 0.02]]}, "pose": {"lr": [[1, 0.002]]}},
    "betas": [0.9, 0.999], "eps": 1e-08, "loss": "mse", "check_from": [1],
    "trace_steps": 3, "forward_replays": 2}


def textured_cell(n_lat=8, n_lon=12, size=48, texture_shape=(16, 24, 3)):
    """A fit of a texture and the pose through the textured pair, on the
    deferred configuration's camera, pose and clip flag."""
    base = harness.load_cell("deferred10k.fit").config
    config = {k: v for k, v in base.items()
              if k not in ("texture", "shading")}
    config.update(name="textured", pipeline="textured", size=size,
                  channels=3, image_channels=texture_shape[2],
                  texture_shape=list(texture_shape),
                  faces=2 * n_lat * n_lon - 2 * n_lon,
                  mesh={"kind": "uv_sphere", "n_lat": n_lat, "n_lon": n_lon})
    return harness.Cell(
        name="textured.fit",
        workload={"name": "textured.fit", "config": "textured",
                  "traffic": "fit_texture_pose", "chips": 1},
        config=config, mix=dict(TEXTURED_MIX),
        loop=importlib.import_module("benchmark.loops.fit"),
        pipeline=TEXTURED, reference=TEXTURED_REF,
        end_to_end=[{"name": "step_ms", "unit": "ms"},
                    {"name": "setup_s", "unit": "s"}],
        per_layer=[])


# The textured pair's limits, from its readings on the CPU (the program's
# plain kernels in float32 against the float64 reference): 12 sound seeds
# at 48^2 (2^31 + 11 + 7919 k) and 3 at 256^2; the control (TF32) and the
# faults on 3 seeds each.
TEXTURED_LIMITS = {
    # sound <= 7.9e-7; control >= 2.6e-3, half batch >= 4.2e-3
    "loss_gap": 1e-5,
    # sound <= 1.2e-5; control >= 0.055, half batch >= 0.26
    "grad_gap": 1e-3,
    # sound <= 7.6e-5 (the rest <= 2.9e-6); control >= 6.5e-3, frozen 1
    "change_gap": 1e-3,
    # sound 0 at 48^2, one pixel of 256^2 (1.5e-5); control >= 4.6e-3
    "fid_mismatch": 5e-4,
    # sound 3.0e-8 (a float32 texel); control >= 2.1e-4, answer 0.25
    "image_gap": 1e-5,
    # every step has to finish: no overflow, a finite loss
    "failed_steps": 0,
}


def _textured_problem(cell):
    """(float64 inputs, start params, target image) of a textured fit on
    the CPU: the texture drawn away from the target's, the pose off."""
    config = cell.config
    data = {k: torch.as_tensor(v) for k, v in scene_arrays(config).items()}
    data = {k: v.double() if v.is_floating_point() else v
            for k, v in data.items()}
    gen = torch.Generator().manual_seed(7)
    shape = tuple(config["texture_shape"])
    pose = torch.tensor(config["pose"], dtype=torch.float64)
    truth = {"texture": torch.rand(shape, generator=gen,
                                   dtype=torch.float64), "pose": pose}
    start = {"texture": torch.rand(shape, generator=gen,
                                   dtype=torch.float64), "pose": pose + 0.03}
    target, _, _ = steps.frame(TEXTURED_REF, config, data, truth)
    return data, start, target


def _textured_loss(cell, data, params, target):
    """The loss with the raster held: only the shading is differentiated."""
    config, size = cell.config, cell.config["size"]
    fv, fa, background, shade = TEXTURED_REF.prepare(config, data, params,
                                                     "float64")
    fid, _ = raster.rasterise(fv, size, size)
    pixels = raster.interpolate(fv, fa, fid, background, "float64")
    return torch.mean((shade(pixels.detach()) - target) ** 2)


def test_texture_gradient_is_the_shadings_exact_one():
    cell = textured_cell()
    data, start, target = _textured_problem(cell)
    state = {"params": start,
             "exp_avg": {k: torch.zeros_like(v) for k, v in start.items()},
             "exp_avg_sq": {k: torch.zeros_like(v)
                            for k, v in start.items()}}
    out = steps.fit_steps(TEXTURED_REF, cell.config, data, state, {}, target,
                          cell.loop.spec(cell.mix), 1, 1)
    got = out["grads"]["texture"]
    texture = start["texture"].clone().requires_grad_()
    want, = torch.autograd.grad(
        _textured_loss(cell, data, dict(start, texture=texture), target),
        texture)
    assert torch.equal(got, want)
    # The loss is quadratic in the texture: a central difference in a few
    # covered texels (the largest gradients) is exact to rounding.
    h = 1e-3
    for index in torch.topk(got.abs().flatten(), 4).indices.tolist():
        step = torch.zeros(got.numel(), dtype=torch.float64)
        step[index] = h
        step = step.reshape(got.shape)
        ahead, behind = (float(_textured_loss(
            cell, data, dict(start, texture=start["texture"] + sign * step),
            target)) for sign in (1.0, -1.0))
        assert (ahead - behind) / (2 * h) == pytest.approx(
            float(got.flatten()[index]), rel=1e-7)


def test_textured_fit_runs_correct():
    result = harness.run_cell(textured_cell(), SEED, 0.2, False, "cpu",
                              time.perf_counter(),
                              cell_limits=TEXTURED_LIMITS)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "answer"])
def test_textured_fault_is_not_correct(fault):
    cell = textured_cell()
    undo = faults.FAULTS[fault](cell)
    try:
        result = harness.run_cell(cell, SEED, 0.2, False, "cpu",
                                  time.perf_counter(),
                                  cell_limits=TEXTURED_LIMITS)
    finally:
        undo()
    assert result["correct"] is False, result["checks"]


def test_textured_control_is_not_correct():
    cell = textured_cell(72, 72, 256)
    loop = cell.loop.build(cell, SEED, "cpu", False)
    for _ in range(4):
        loop.step()
    numbers = cell.loop.control(cell, loop.close(), "cpu")
    numbers["failed_steps"] = 0
    correct, table = check.judge(numbers, TEXTURED_LIMITS)
    assert not correct, table


def _parent_loss_and_grads(pipeline, config, inputs_, params, target,
                           trained, prec, loss_fn):
    """``steps.loss_and_grads`` as it was before the shading's own route:
    the loss's gradient to the held raster output alone, then DIRT's
    surrogate to every trained parameter."""
    fv, fa, background, shade = pipeline.prepare(config, inputs_, params,
                                                 prec)
    size = config["size"]
    fid, zbuf = raster.rasterise(fv, size, size)
    pixels = raster.interpolate(fv, fa, fid, background, prec)
    held = pixels.detach().requires_grad_()
    image = shade(held)
    loss = loss_fn(image, target)
    upstream, = torch.autograd.grad(loss, held)
    total = (torch.sum(pixels * upstream)
             + raster.edge_surrogate(fv, fid, zbuf, pixels, upstream))
    grads = torch.autograd.grad(total, [params[name] for name in trained])
    return loss.detach(), image.detach(), fid, dict(zip(trained, grads))


@pytest.mark.parametrize("prec", ["float64", "tf32"])
@pytest.mark.parametrize("name", CELLS)
def test_reference_readings_are_the_parents_bit_for_bit(name, prec):
    cell = tiny(name)
    config, mix, pipe = cell.config, cell.mix, cell.pipeline
    arrays = scene_arrays(config)
    scene = pipe.scene(config, arrays, "cpu")
    if mix["loop"] == "fit":
        truth = inputs.make_params(mix["target"], pipe, config, scene, SEED,
                                   "target")
        start = inputs.make_params(mix["init"], pipe, config, scene, SEED,
                                   "start0")
        trained = list(mix["trained"])
    else:
        truth = {"pose": pipe.true_value("pose", config, scene)}
        start = {"pose": truth["pose"] + 0.05}
        trained = ["pose"]
    dtype = steps.DTYPES[prec]
    data = {k: torch.as_tensor(v) for k, v in arrays.items()}
    data = {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in data.items()}
    target, _, _ = steps.frame(cell.reference, config, data, truth, prec)
    params = {k: v.to(dtype) for k, v in {**truth, **start}.items()}
    for leaf in trained:
        params[leaf].requires_grad_()
    args = (cell.reference, config, data, params, target, trained, prec,
            steps.LOSSES["mse"])
    now, then = steps.loss_and_grads(*args), _parent_loss_and_grads(*args)
    for mine, theirs in zip(now[:3], then[:3]):
        assert torch.equal(mine, theirs)
    assert list(now[3]) == trained
    for leaf in trained:
        assert torch.equal(now[3][leaf], then[3][leaf]), leaf


def test_roofline_counts_a_lit_step_with_its_light():
    cell = harness.load_cell("lit512.fit")
    cell.config = dict(cell.config, size=4, faces=6,
                       mesh={"kind": "uv_sphere", "n_lat": 2, "n_lon": 3})
    # As the hand-worked scene, with the light (3) and the pose (3) as the
    # parameters: 24 B, and 6 x 24 B for their gradients, moments and
    # update.
    assert roofline.param_bytes(cell) == 24
    assert roofline.step_work(cell, 10) == (
        144 + 144 + 24 + 320 + 192 + 192 + 144,
        10 * (22 + 6 + 15 + 330 + 18 + 12 + 9))


def test_roofline_counts_a_texture_at_its_shape():
    cell = textured_cell(texture_shape=(4, 6, 3))
    assert roofline.param_bytes(cell) == 288 + 12
    cell.mix = dict(cell.mix, trained={"texture": {"lr": [[1, 0.02]]}})
    assert roofline.param_bytes(cell) == 288


def _parent_param_bytes(cell):
    """``roofline.param_bytes`` before it read the pipelines' shapes."""
    verts = len(scene_arrays(cell.config)["verts"])
    sizes = {"pose": 3, "bump": verts, "colors": verts * cell.config.get(
        "channels", 3)}
    names = (cell.mix["trained"] if cell.mix["loop"] == "fit" else ["pose"])
    return roofline.F32 * sum(sizes[name] for name in names)


@pytest.mark.parametrize("name", sorted(
    {w for m in BENCH["per_layer"] if harness.quantity(m["name"])
     == "step_roofline" for w in m["workloads"]} - {"lit512.fit"}))
def test_roofline_reads_the_parents_count_at_full_size(name, monkeypatch):
    cell = harness.load_cell(name)
    covered = cell.config["size"] ** 2 // 3
    work, least = roofline.step_work(cell, covered), roofline.least_ms(
        cell, covered)
    monkeypatch.setattr(roofline, "param_bytes", _parent_param_bytes)
    assert roofline.step_work(cell, covered) == work
    assert roofline.least_ms(cell, covered) == least


def test_start_seed_fixes_the_starts_and_the_run_seed_orders_them():
    cell = tiny("sphere1m.fit")
    cell.mix = dict(cell.mix, starts=8)
    assert "start_seed" in cell.mix
    loops = [cell.loop.build(cell, seed, "cpu", False)
             for seed in (SEED, SEED + 1)]
    poses = [[tuple(start["pose"].tolist()) for start in loop.starts]
             for loop in loops]
    assert sorted(poses[0]) == sorted(poses[1]) and poses[0] != poses[1]
    assert not torch.equal(loops[0].target, loops[1].target)
    for loop in loops:
        loop.close()
