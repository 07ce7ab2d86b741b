"""The benchmark's ``textured512.fit`` cell: a fit of a 128 x 128 x 3
texture and the pose through ``render_gbuffer``'s UVs and mask and
``core/texture.sample_texture`` (upstream DIRT's ``samples/textured.py``)
under the public API's defaults (``clip=True``) on a mesh below
``PACKED_MIN_FACES``, which the dense engine renders; the texture lookup
against the reference's (``benchmark/reference/shading.sample_bilinear``);
and the texture gradient's one scatter against the four gathers' backwards
that autograd summed before it.

On the CPU the port's kernels' plain versions stand in and
``GraphedStep`` calls its step eagerly; the cell is cut to 64 x 64 with
fits of 5 steps and 2 starts, its mesh and texture as they are. The cut
comes out correct under the cell's own limits; the TF32 control and each
planted fault of its mix do not.
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import check, faults, harness
from benchmark.pipelines import textured as textured_pipeline
from benchmark.reference.shading import sample_bilinear
from benchmark.scenes import scene_arrays
from dirt_tpu_torch.core import texture as texture_mod
from dirt_tpu_torch.core.texture import sample_texture
from dirt_tpu_torch.ops import raster
from dirt_tpu_torch.utils import trace

CELL = "textured512.fit"
SEED = 2 ** 33 + 28


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
    scene = textured_pipeline.scene(config, scene_arrays(config), "cpu")
    assert len(scene["verts"]) == 1225
    truth = textured_pipeline.true_value("texture", config, scene)
    assert tuple(truth.shape) == (128, 128, 3) == tuple(
        config["texture_shape"])
    assert sorted(truth.unique().tolist()) == pytest.approx([0.2, 0.9])
    pose = textured_pipeline.true_value("pose", config, scene)
    with torch.no_grad():
        suggested = dirt_tpu_torch.suggest_raster_config(
            textured_pipeline.clip_vertices(config, scene, {"pose": pose}),
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


def test_frozen_one_freezes_the_pose():
    """The mix trains the texture first and the pose last, so that
    ``frozen_one`` leaves the texture's updates and holds the pose."""
    assert list(harness.load_cell(CELL).mix["trained"]) == ["texture",
                                                            "pose"]


# --- the texture lookup ------------------------------------------------------


def _lookup_inputs(dtype):
    """A seeded 16 x 24 x 3 texture, a 12 x 10 grid of UVs drawn in [-0.1,
    1.1] (past both edges, so that clamping shows) whose last three rows
    are the background's (0, 0), and a weighting of the samples."""
    gen = torch.Generator().manual_seed(28)
    tex = torch.rand(16, 24, 3, generator=gen, dtype=torch.float64)
    uv = torch.rand(12, 10, 2, generator=gen, dtype=torch.float64) * 1.2 - 0.1
    uv[9:] = 0.0
    weights = torch.rand(12, 10, 3, generator=gen, dtype=torch.float64)
    return tex.to(dtype), uv.to(dtype), weights.to(dtype)


def _grads(sample, tex, uv, weights):
    tex, uv = tex.clone().requires_grad_(), uv.clone().requires_grad_()
    values = sample(tex, uv)
    d_tex, d_uv = torch.autograd.grad((values * weights).sum(), (tex, uv))
    return values.detach(), d_tex, d_uv


def test_the_lookup_matches_the_reference_with_its_gradients():
    """The port in float32 against the reference in float64: the values,
    the texture gradient and the UV gradient of a weighting of them, with
    background pixels (UV (0, 0), all four corners on one clamped texel)
    present. Tolerances: float32's rounding (~6e-8) of a blend of four
    texels in [0, 1]: 1e-6 on values; the texture gradient sums at most a
    few dozen weighted rows a texel (1e-6 relative to its largest); the UV
    gradient is a texel difference times the texture's size (24): 2e-5
    relative to its largest."""
    got = _grads(sample_texture, *_lookup_inputs(torch.float32))
    want = _grads(sample_bilinear, *_lookup_inputs(torch.float64))
    # The background's texel is the bottom-left one, and it gets a gradient.
    assert float(want[1][15, 0].abs().sum()) > 0
    torch.testing.assert_close(got[0].double(), want[0], rtol=0.0, atol=1e-6)
    for mine, ref, rel in ((got[1], want[1], 1e-6), (got[2], want[2], 2e-5)):
        torch.testing.assert_close(mine.double(), ref, rtol=0.0,
                                   atol=rel * float(ref.abs().max()))


def _four_gathers(tex, uv):
    """``sample_texture``'s bilinear clamped lookup as it was before its
    gathers shared one backward: four ``index_select`` row gathers, each
    with its own backward, summed by autograd."""
    ht, wt, channels = tex.shape
    u, v = texture_mod._continuous_coords(tex, uv)
    u = texture_mod._clip_split(u, 0.0, wt - 1.0)
    v = texture_mod._clip_split(v, 0.0, ht - 1.0)
    u0f, v0f = torch.floor(u), torch.floor(v)
    fu, fv = (u - u0f)[..., None], (v - v0f)[..., None]
    u0 = texture_mod._wrap_index(u0f.to(torch.int64), wt, "clamp")
    v0 = texture_mod._wrap_index(v0f.to(torch.int64), ht, "clamp")
    u1 = texture_mod._wrap_index(u0 + 1, wt, "clamp")
    v1 = texture_mod._wrap_index(v0 + 1, ht, "clamp")

    def texels(iv, iu):
        rows = tex.reshape(ht * wt, channels).index_select(
            0, (iv * wt + iu).reshape(-1))
        return rows.reshape(*iv.shape, channels)

    top = texels(v0, u0) * (1.0 - fu) + texels(v0, u1) * fu
    bottom = texels(v1, u0) * (1.0 - fu) + texels(v1, u1) * fu
    return top * (1.0 - fv) + bottom * fv


@pytest.mark.parametrize("size", [(16, 24), (128, 128)])
def test_one_scatter_is_the_four_gathers_backwards(size):
    """The values and the UV gradient bit for bit; the texture gradient
    within float32 rounding of the sums' other order (1e-6 relative to
    its largest)."""
    tex, uv, weights = _lookup_inputs(torch.float32)
    tex = torch.rand(*size, 3, generator=torch.Generator().manual_seed(5))
    got = _grads(sample_texture, tex, uv, weights)
    want = _grads(_four_gathers, tex, uv, weights)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[2], want[2])
    torch.testing.assert_close(got[1], want[1], rtol=0.0,
                               atol=1e-6 * float(want[1].abs().max()))


@pytest.fixture
def marks(monkeypatch):
    """The markers launched, (closed, opened), with every tensor taken for
    a card tensor."""
    launched = []

    def record(close, open_, like):
        trace.mark_ids(close, open_)
        launched.append((close, open_))

    monkeypatch.setattr(trace, "_mark", record)
    monkeypatch.setattr(trace, "_on_card", lambda tensor: True)
    return launched


def test_a_texture_that_needs_no_gradient_scatters_nothing(marks,
                                                           monkeypatch):
    """With the UVs trained and the texture fixed, the lookup's backward
    carries the UV gradient and never runs the texture's scatter: no
    ``texture_grad`` marker and no call of the gathers' backward. With the
    texture trained, one call and one ``texture_grad`` pair."""
    calls = []
    real = texture_mod._Rows.backward

    def spy(ctx, *grads):
        calls.append(len(grads))
        return real(ctx, *grads)

    monkeypatch.setattr(texture_mod._Rows, "backward", staticmethod(spy))
    tex, uv, weights = _lookup_inputs(torch.float32)
    uv.requires_grad_()
    (sample_texture(tex, uv) * weights).sum().backward()
    assert marks == [(None, "texture"), ("texture", None)]
    assert calls == [] and uv.grad is not None
    marks.clear()
    tex.requires_grad_()
    (sample_texture(tex, uv) * weights).sum().backward()
    assert marks == [(None, "texture"), ("texture", None),
                     (None, "texture_grad"), ("texture_grad", None)]
    assert calls == [4] and tex.grad is not None
