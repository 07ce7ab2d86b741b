"""The benchmark's ``lit512.fit`` cell: demo 4's fit of a light and a pose
through per-vertex lighting (``core/lighting.py``) and the public API's
defaults (``clip=True``) on a mesh below ``PACKED_MIN_FACES``, which the
dense engine renders; its plain reference (``benchmark/reference/lit.py``)
against the port's lighting; and the dense engine's two roofline readers.

On the CPU the port's kernels' plain versions stand in and
``GraphedStep`` calls its step eagerly; the cell is cut to 64 x 64 with
fits of 5 steps and 2 starts, its mesh and shading as they are. The cut
comes out correct under the cell's own limits; the TF32 control and each
planted fault of its mix do not.
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import check, faults, harness, kernel_roofline
from benchmark.pipelines import lit as lit_pipeline
from benchmark.reference import camera as cam
from benchmark.reference import lit as lit_reference
from benchmark.reference.shading import vertex_normals
from benchmark.scenes import scene_arrays, uv_sphere
from dirt_tpu_torch.core import lighting
from dirt_tpu_torch.ops import raster
from test_torch_csr_fit import _kernel_window

CELL = "lit512.fit"
SEED = 2 ** 33 + 25


def cut():
    """The cell at 64 x 64, fits of 5 steps from 2 starts."""
    cell = harness.load_cell(CELL)
    cell.config = dict(cell.config, size=64)
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


def test_the_configuration_takes_the_dense_engine_with_the_default_clip():
    import dirt_tpu_torch

    config = harness.load_cell(CELL).config
    assert config["clip"] is True and config["faces"] == 2208
    assert config["faces"] < raster.PACKED_MIN_FACES
    scene = lit_pipeline.scene(config, scene_arrays(config), "cpu")
    params = {name: lit_pipeline.true_value(name, config, scene)
              for name in ("light", "pose")}
    with torch.no_grad():
        suggested = dirt_tpu_torch.suggest_raster_config(
            lit_pipeline.clip_vertices(config, scene, params),
            scene["faces"], config["size"], config["size"], clip=True)
    assert suggested.engine == "auto"
    assert raster.resolve_engine(suggested, config["faces"]) == "dense"
    assert not raster.streams(suggested, config["faces"])


def test_a_cut_of_the_cell_is_correct_on_the_dense_route(routes):
    result = harness.run_cell(cut(), SEED, 0.2, False, "cpu",
                              time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert routes and set(routes) == {"dense"}


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


# --- the reference's shading against the port's ---------------------------


def _shaded(dtype, verts, faces, light, pose, shading, camera):
    """Per-vertex colours of the lit scene in ``dtype``: the port's
    ``core/lighting.py`` for float32, the reference's for float64; the
    camera is the reference's in both."""
    pose = pose.to(dtype).requires_grad_()
    light = light.to(dtype).requires_grad_()
    model = cam.model_matrix(pose, camera, "float64")
    world = (cam.homogeneous(verts.to(dtype)) @ model)[:, :3]
    if dtype == torch.float64:
        colors = lit_reference.shade(world, vertex_normals(world, faces),
                                     light, shading)
    else:
        unit = light / torch.linalg.norm(light)
        normals = lighting.vertex_normals(world, faces)
        n = world.shape[0]
        colors = lighting.diffuse_directional(
            normals, torch.tensor(shading["albedo"]).expand(n, 3), unit,
            torch.tensor(shading["light_color"]),
        ) + lighting.specular_directional(
            world, normals, torch.full((n, 3), shading["specular_albedo"]),
            torch.tensor(shading["camera_position"]), unit,
            torch.tensor(shading["light_color"]), shading["shininess"])
    return colors, light, pose


def test_the_reference_shading_matches_the_port_with_its_gradients():
    """On a bumpy 6 x 10 sphere with a seeded light and pose near the
    cell's: the port in float32 against the reference in float64, the
    colours and the gradients of a seeded weighting of them with respect
    to the light and the pose. Tolerances: float32's rounding (~6e-8)
    through the normals' sums and the 20th power, which multiplies a
    cosine's relative error by 20: 2e-6 on colours of at most ~1.3, and
    1e-5 relative on the gradients, each a sum over the 50 vertices."""
    config = harness.load_cell(CELL).config
    gen = torch.Generator().manual_seed(20)
    verts, faces, _ = uv_sphere(6, 10)
    verts = torch.as_tensor(verts, dtype=torch.float64)
    verts = verts * (1.0 + 0.1 * torch.rand(len(verts), 1, generator=gen,
                                            dtype=torch.float64))
    faces = torch.as_tensor(faces)
    light = (torch.tensor(config["shading"]["light"], dtype=torch.float64)
             + 0.2 * torch.rand(3, generator=gen, dtype=torch.float64) - 0.1)
    pose = (torch.tensor(config["pose"], dtype=torch.float64)
            + 0.2 * torch.rand(3, generator=gen, dtype=torch.float64) - 0.1)
    weights = torch.rand(len(verts), 3, generator=gen, dtype=torch.float64)
    got, want = (_shaded(dtype, verts, faces, light, pose,
                         config["shading"], config["camera"])
                 for dtype in (torch.float32, torch.float64))
    # The scene has highlights, and vertices turned away from the light.
    diffuse, _, _ = _shaded(torch.float64, verts, faces, light, pose,
                            dict(config["shading"], specular_albedo=0.0),
                            config["camera"])
    assert float((want[0] - diffuse).detach().max()) > 0.01
    assert float(want[0].detach().min()) == 0.0
    torch.testing.assert_close(got[0].double(), want[0].detach(),
                               rtol=0.0, atol=2e-6)
    grads = [torch.autograd.grad((colors.double() * weights).sum(),
                                 [light_leaf, pose_leaf])
             for colors, light_leaf, pose_leaf in (got, want)]
    for mine, ref in zip(*grads):
        torch.testing.assert_close(mine.double(), ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))


# --- the dense engine's roofline readers ----------------------------------


OTHER_ENGINES = ["void raster_fwd_packed_kernel<3>()",
                 "void (anonymous namespace)::raster_fwd_csr_kernel()",
                 "void (anonymous namespace)::fused_bwd_csr_partial_kernel"
                 "<3, 8, 3>()",
                 "void (anonymous namespace)::fused_bwd_csr_reduce_kernel()",
                 "void packed_bwd_kernel<3>()"]


@pytest.mark.parametrize("metric,kernels,work,others", [
    ("dense_fwd_roofline",
     ["void (anonymous namespace)::cull_boxes_kernel(float const*, int)",
      "void (anonymous namespace)::raster_fwd_dense_kernel(float const*)"],
     kernel_roofline.fwd_work,
     ["void (anonymous namespace)::fused_bwd_partial_kernel<3, 4, 4>()"]),
    ("dense_bwd_roofline",
     ["void (anonymous namespace)::fused_bwd_partial_kernel<3, 4, 4>()",
      "void (anonymous namespace)::fused_bwd_reduce_kernel(int const*)"],
     kernel_roofline.bwd_work,
     ["void (anonymous namespace)::raster_fwd_dense_kernel(float const*)",
      "void (anonymous namespace)::cull_boxes_kernel(float const*, int)"])])
def test_dense_roofline_readers_count_only_their_own_launches(
        metric, kernels, work, others):
    cell = harness.load_cell(CELL)
    reader = harness.reader(metric)
    data = {"window": _kernel_window(kernels + others + OTHER_ENGINES),
            "cell": cell, "covered": 60_000, "forward_ms": None}
    # Its two kernels of 1 us a step: 0.002 ms, whatever else ran.
    want = 100.0 * kernel_roofline.least_ms(work(cell, 60_000)) / 0.002
    assert reader.read(data) == pytest.approx(want)
    assert reader.read(dict(data, window=_kernel_window(kernels, 3))) \
        == pytest.approx(want)
    assert reader.read(dict(data, window=_kernel_window(
        others + OTHER_ENGINES))) is None
    incomplete = _kernel_window(kernels)
    incomplete.steps = 3
    assert reader.read(dict(data, window=incomplete)) is None
