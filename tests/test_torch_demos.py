"""The port's demos (``demos/torch_demo*.py``) against ``dirt_tpu`` on the CPU.

Demos 1-2 at their own sizes: the port's image and face ids against
``dirt_tpu.rasterise_with_aux`` on the same scene, built here from
``dirt_tpu`` calls as the JAX scripts build it (running those would write
into ``demos/out/``): face ids equal on all but 1% of the pixels (razor
edges, ``tests/test_sharding.py``'s policy), pixels within 1e-5 where they
agree; and against the stored ``demos/out/demo1_square.ppm`` (equal) and
``demo2_cube.ppm`` (all but 0.1% of the pixels within one 8-bit step).

Demos 3-5 at reduced sizes, through the port's ``problem`` and ``fit``:
demo 3 (texture recovery) and demo 4 (light and pose) at 96 x 96, four
steps each; demo 5 (deferred inverse rendering, Adam) on a 12 x 12 sphere
at 96 x 96, six steps with the switch from pose alone to pose and bump
after step three. ``dirt_tpu``'s side of demo 5 is the JAX demo module
itself, loaded with ``importlib`` under ``DIRT_DEMO_SIZE`` / ``_STEPS`` /
``_LAT`` / ``_LON`` and driven through its own ``build_scene`` and
``make_render`` (its ``main`` writes into ``demos/out/`` and is never
called), with its Adam update written out as the demo writes it. Held:
each step's loss within 1e-4 relative of ``dirt_tpu``'s trajectory; the
first step's gradients within 1e-4 of max |gradient|; the target image
within 1e-5 on all but 1% of the pixels; demo 5's checkpoint, which
``dirt_tpu.utils.checkpoint.load_pytree`` reads with the demo's keys and
the port's leaves, and its CSV header. Each JAX program is compiled once
per file (``lru_cache``).
"""

import functools
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dirt_tpu
from dirt_tpu.core import lighting, matrices, mesh
from dirt_tpu.core.texture import sample_texture
from dirt_tpu.render.gbuffer import render_gbuffer
from dirt_tpu.utils import checkpoint as jckpt
from dirt_tpu_torch.utils.image import load_ppm, to_uint8

DEMOS = Path(__file__).resolve().parents[1] / "demos"
# Face ids may differ on razor-edge pixels (tests/test_sharding.py's 1%).
RAZOR = 0.01
TOL_PIXELS = 1e-5
TOL_LOSS = 1e-4
TOL_GRAD = 1e-4
SIZE = 96
STEPS = 4
D5_STEPS = 6
D5_LAT = 12


def _load(name, env=None):
    """The module of ``demos/<name>.py``, imported under the environment
    variables ``env``."""
    old = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        spec = importlib.util.spec_from_file_location(
            f"_demo_{name}", DEMOS / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        for key, value in old.items():
            if value is None:
                os.environ.pop(key)
            else:
                os.environ[key] = value
    return module


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _assert_images_agree(got, want):
    off = np.abs(np.asarray(got) - np.asarray(want)).max(-1) > TOL_PIXELS
    assert off.mean() <= RAZOR, f"{off.mean():.3%} of pixels differ"


def _assert_trajectory(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS, atol=0)


# --- demos 1-2: images and face ids ---------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_render(demo):
    """(image, fid) of ``dirt_tpu`` on the demo's scene, as numpy."""
    if demo == 1:
        verts = jnp.array([[-0.5, -0.5, 0.0, 1.0], [0.5, -0.5, 0.0, 1.0],
                           [0.5, 0.5, 0.0, 1.0], [-0.5, 0.5, 0.0, 1.0]],
                          jnp.float32)
        faces = jnp.array([[0, 1, 2], [0, 2, 3]], jnp.int32)
        out = dirt_tpu.rasterise_with_aux(
            jnp.zeros((64, 64, 1), jnp.float32), verts,
            jnp.ones((4, 1), jnp.float32), faces)
    else:
        verts_obj, faces = mesh.cube()
        model_view = matrices.compose(
            matrices.rodrigues(jnp.array([0.5, 0.8, 0.0])),
            matrices.translation(jnp.array([0.0, 0.0, -3.0])),
        )
        projection = matrices.perspective_projection(
            near=0.1, far=20.0, right=0.05, aspect=1.0)
        clip = matrices.transform_homogeneous(
            jnp.asarray(verts_obj), matrices.compose(model_view, projection))
        out = dirt_tpu.rasterise_with_aux(
            jnp.full((256, 256, 3), 0.1, jnp.float32), clip,
            jnp.asarray(verts_obj + 0.5, jnp.float32), jnp.asarray(faces))
    return np.asarray(out[0]), np.asarray(out[1])


@functools.lru_cache(maxsize=None)
def _port_render(demo):
    module = _load({1: "torch_demo1_square", 2: "torch_demo2_cube"}[demo])
    image, fid = module.render("cpu")
    return image.numpy(), fid.numpy()


@pytest.mark.parametrize("demo", [1, 2])
def test_demo_render_matches_jax(demo):
    (want, want_fid), (got, got_fid) = _jax_render(demo), _port_render(demo)
    assert got.shape == want.shape and got_fid.shape == want_fid.shape
    same = got_fid == want_fid
    assert (~same).mean() <= RAZOR, f"{(~same).mean():.3%} fids differ"
    assert (got_fid >= 0).sum() > 0
    np.testing.assert_allclose(got[same], want[same], rtol=0,
                               atol=TOL_PIXELS)


@pytest.mark.parametrize("demo, name, steps_off", [
    (1, "demo1_square", 0.0), (2, "demo2_cube", 0.001)])
def test_demo_render_matches_stored_ppm(demo, name, steps_off):
    """The JAX demos' stored outputs: demo 1 to the byte, demo 2 within one
    8-bit step on all but 0.1% of the pixels (razor edges; ``dirt_tpu``
    today differs from the file on the same 17 pixels)."""
    stored = np.rint(load_ppm(str(DEMOS / "out" / f"{name}.ppm")) * 255)
    got = to_uint8(_port_render(demo)[0]).astype(np.float64)
    if got.shape[-1] == 1:
        got = got[..., 0]
    off = np.abs(got - stored)
    if off.ndim == 3:
        off = off.max(-1)
    assert (off > 1).mean() <= steps_off
    if demo == 1:
        assert (off == 0).all()


def test_demo_main_writes_ppm(tmp_path):
    """``main`` on the CPU writes the image it returns, into ``out``."""
    module = _load("torch_demo1_square")
    image, _ = module.main("cpu", str(tmp_path))
    saved = load_ppm(str(tmp_path / "demo1_square.ppm"))
    np.testing.assert_array_equal(saved * 255,
                                  to_uint8(image.numpy())[..., 0])


# --- demos 3-4: gradient descent ---------------------------------------------------


def _jax_descent(loss_fn, params, lr, steps):
    """(losses, first-step gradients) of ``steps`` plain gradient steps, as
    the JAX demos' scans take them."""
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    losses, first = [], None
    for _ in range(steps):
        loss, grads = value_and_grad(params)
        first = grads if first is None else first
        params = {k: params[k] - lr[k] * grads[k] for k in params}
        losses.append(float(loss))
    return np.array(losses), {k: np.asarray(v) for k, v in first.items()}


def _posed_clip(verts_obj, rot):
    model_view = matrices.compose(
        matrices.rodrigues(jnp.array(rot)),
        matrices.translation(jnp.array([0.0, 0.0, -3.0])),
    )
    projection = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)
    return matrices.transform_homogeneous(
        jnp.asarray(verts_obj), matrices.compose(model_view, projection))


@functools.lru_cache(maxsize=None)
def _jax_demo3():
    """``demos/demo3_textured.py``'s scene and descent at SIZE: (target
    image, losses, first-step gradients)."""
    verts_obj, faces, uvs = mesh.uv_sphere(n_lat=24, n_lon=48)
    texture = jnp.asarray(mesh.checkerboard_texture(64, 8, 3))
    clip = _posed_clip(verts_obj, [0.3, 0.5, 0.1])

    def render(tex):
        gb = render_gbuffer(clip, jnp.asarray(faces),
                            {"uv": jnp.asarray(uvs)}, SIZE, SIZE)
        return sample_texture(tex, gb["uv"]) * gb["mask"]

    target = jax.jit(render)(texture)
    losses, first = _jax_descent(
        lambda p: jnp.mean((render(p["texture"]) - target) ** 2),
        {"texture": jnp.full_like(texture, 0.5)}, {"texture": 300.0}, STEPS)
    return np.asarray(target), losses, first


@functools.lru_cache(maxsize=None)
def _jax_demo4():
    """``demos/demo4_lit.py``'s scene and descent at SIZE."""
    verts_obj, faces, _ = mesh.uv_sphere(n_lat=24, n_lon=48)
    verts_obj = jnp.asarray(verts_obj)
    faces = jnp.asarray(faces)
    albedo = jnp.broadcast_to(jnp.array([0.9, 0.6, 0.3], jnp.float32),
                              (verts_obj.shape[0], 3))
    projection = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)

    def render(light_dir_raw, pose):
        light_dir = light_dir_raw / jnp.linalg.norm(light_dir_raw)
        model = matrices.compose(
            matrices.rodrigues(pose),
            matrices.translation(jnp.array([0.0, 0.0, -3.0])),
        )
        world = matrices.transform_homogeneous(verts_obj, model)[..., :3]
        normals = lighting.vertex_normals(world, faces)
        shaded = lighting.diffuse_directional(
            normals, albedo, light_dir, jnp.ones(3)
        ) + lighting.specular_directional(
            world, normals, jnp.full_like(albedo, 0.4),
            camera_position=jnp.zeros(3), light_direction=light_dir,
            light_color=jnp.ones(3), shininess=20.0,
        )
        ones = jnp.ones(world.shape[:-1] + (1,), world.dtype)
        clip = jnp.concatenate([world, ones], -1) @ projection
        return dirt_tpu.rasterise(jnp.zeros((SIZE, SIZE, 3), jnp.float32),
                                  clip, shaded, faces)

    target = jax.jit(render)(jnp.array([0.3, 0.8, 0.52]),
                             jnp.array([0.4, 0.3, 0.0]))
    losses, first = _jax_descent(
        lambda p: jnp.mean((render(p["light"], p["pose"]) - target) ** 2),
        {"light": jnp.array([0.0, 1.0, 0.3]),
         "pose": jnp.array([0.55, 0.2, 0.05])},
        {"light": 3.0, "pose": 0.5}, STEPS)
    return np.asarray(target), losses, first


@functools.lru_cache(maxsize=None)
def _port_demo(demo):
    """(target image, losses, first-step gradients) of the port's demo 3 or
    4 at SIZE on the CPU."""
    module = _load({3: "torch_demo3_textured", 4: "torch_demo4_lit"}[demo])
    loss_fn, params, render, truth = module.problem(SIZE, "cpu")
    with torch.no_grad():
        target = (render(truth) if demo == 3
                  else render(truth["light"], truth["pose"]))
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    grads = torch.autograd.grad(loss_fn(**leaves), list(leaves.values()))
    _, losses = module.fit(loss_fn, params, STEPS)
    return (target.numpy(), losses.numpy(),
            {k: g.numpy() for k, g in zip(leaves, grads)})


_JAX_DEMO = {3: _jax_demo3, 4: _jax_demo4}


@pytest.mark.parametrize("demo", [3, 4])
def test_demo_target_matches_jax(demo):
    _assert_images_agree(_port_demo(demo)[0], _JAX_DEMO[demo]()[0])


@pytest.mark.parametrize("demo", [3, 4])
def test_demo_loss_trajectory_matches_jax(demo):
    got, want = _port_demo(demo)[1], _JAX_DEMO[demo]()[1]
    _assert_trajectory(got, want)
    assert got[-1] < got[0]


@pytest.mark.parametrize("demo", [3, 4])
def test_demo_first_gradients_match_jax(demo):
    got, want = _port_demo(demo)[2], _JAX_DEMO[demo]()[2]
    assert set(got) == set(want)
    for key in want:
        assert _rel_err(got[key], want[key]) <= TOL_GRAD, key


# --- demo 5: deferred inverse rendering with Adam -----------------------------------

_D5_ENV = {"DIRT_DEMO_SIZE": str(SIZE), "DIRT_DEMO_STEPS": str(D5_STEPS),
           "DIRT_DEMO_LAT": str(D5_LAT), "DIRT_DEMO_LON": str(D5_LAT)}


@functools.lru_cache(maxsize=None)
def _jax_demo5():
    """The JAX demo 5 at the reduced size, through its own ``build_scene``
    and ``make_render`` and its Adam update: (target, losses, first-step
    gradients, final params, m, v)."""
    demo = _load("demo5_deferred", _D5_ENV)
    verts_obj, faces, uvs, texture, projection = demo.build_scene()
    true_pose = jnp.array([0.4, 0.3, 0.0])
    clip0 = matrices.transform_homogeneous(verts_obj, matrices.compose(
        matrices.compose(matrices.rodrigues(true_pose),
                         matrices.translation(jnp.array([0.0, 0.0, -3.0]))),
        projection))
    config = dirt_tpu.suggest_raster_config(clip0, faces, SIZE, SIZE)
    render = jax.jit(demo.make_render(faces, uvs, texture, projection,
                                      config))
    target = render(verts_obj, true_pose)

    def loss_fn(params):
        verts = verts_obj * (1.0 + params["bump"][:, None])
        return jnp.mean((render(verts, params["pose"]) - target) ** 2)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    params = {"pose": jnp.array([0.52, 0.22, 0.05]),
              "bump": jnp.zeros((verts_obj.shape[0],))}
    m = jax.tree.map(jnp.zeros_like, params)
    v = jax.tree.map(jnp.zeros_like, params)
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, first = [], None
    for t in range(1, D5_STEPS + 1):
        lrs = {"pose": 5e-3, "bump": 0.0 if t <= D5_STEPS // 2 else 2e-4}
        loss, g = value_and_grad(params)
        first = g if first is None else first
        m = jax.tree.map(lambda a, b: b1 * a + (1 - b1) * b, m, g)
        v = jax.tree.map(lambda a, b: b2 * a + (1 - b2) * b * b, v, g)
        mh = jax.tree.map(lambda a: a / (1 - b1 ** t), m)
        vh = jax.tree.map(lambda a: a / (1 - b2 ** t), v)
        params = jax.tree.map(
            lambda p, lr, a, b: p - lr * a / (jnp.sqrt(b) + eps),
            params, lrs, mh, vh)
        losses.append(float(loss))

    def numpy(tree):
        return {k: np.asarray(x) for k, x in tree.items()}

    return (np.asarray(target), np.array(losses), numpy(first),
            numpy(params), numpy(m), numpy(v))


@functools.lru_cache(maxsize=None)
def _port_demo5():
    """The port's demo 5 at the reduced size: (module, target, losses,
    first-step gradients, final params, optimiser)."""
    demo = _load("torch_demo5_deferred")
    loss_fn, params, _, target, _ = demo.problem(SIZE, D5_LAT, D5_LAT, "cpu")
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    grads = torch.autograd.grad(loss_fn(**leaves), list(leaves.values()))
    final, opt, losses = demo.fit(loss_fn, params, D5_STEPS)
    return (demo, target.numpy(), losses.numpy(),
            {k: g.numpy() for k, g in zip(leaves, grads)}, final, opt)


def test_demo5_target_matches_jax():
    _assert_images_agree(_port_demo5()[1], _jax_demo5()[0])


def test_demo5_loss_trajectory_matches_jax():
    got, want = _port_demo5()[2], _jax_demo5()[1]
    _assert_trajectory(got, want)
    assert got[-1] < got[0]


def test_demo5_first_gradients_match_jax():
    got, want = _port_demo5()[3], _jax_demo5()[2]
    assert set(got) == set(want) == {"pose", "bump"}
    for key in want:
        assert _rel_err(got[key], want[key]) <= TOL_GRAD, key


def test_demo5_final_state_matches_jax():
    """Params and Adam moments after the six steps within 1e-3 of max |x| of
    ``dirt_tpu``'s. The bump's rate is 0 for the first three steps, so it
    has taken three Adam steps of about 2e-4 (its moments update from step
    one in both packages)."""
    demo, _, _, _, final, opt = _port_demo5()
    _, _, _, params, m, v = _jax_demo5()
    for group, name in zip(opt.param_groups, ("pose", "bump")):
        state = opt.state[group["params"][0]]
        for got, want in ((final[name], params[name]),
                          (state["exp_avg"], m[name]),
                          (state["exp_avg_sq"], v[name])):
            assert _rel_err(got.numpy(), want) <= 1e-3, name
    steps = D5_STEPS - D5_STEPS // 2
    bump = float(final["bump"].abs().max())
    assert (steps - 0.5) * demo.LR_BUMP < bump < (steps + 0.5) * demo.LR_BUMP


def test_demo5_checkpoint_and_csv_read_by_dirt_tpu(tmp_path):
    demo, _, losses, _, final, opt = _port_demo5()
    path = demo.save_run(str(tmp_path), final, opt, torch.tensor(losses))
    restored = jckpt.load_pytree(path)
    _, _, _, params, m, v = _jax_demo5()
    assert set(restored) == {"params", "m", "v", "step"}
    assert int(restored["step"]) == D5_STEPS
    want = {"params": final, "m": {}, "v": {}}
    for group, name in zip(opt.param_groups, ("pose", "bump")):
        state = opt.state[group["params"][0]]
        want["m"][name] = state["exp_avg"]
        want["v"][name] = state["exp_avg_sq"]
    for key, jax_tree in (("params", params), ("m", m), ("v", v)):
        assert set(restored[key]) == set(jax_tree) == {"pose", "bump"}
        for name in jax_tree:
            leaf = np.asarray(restored[key][name])
            assert leaf.shape == jax_tree[name].shape
            assert leaf.dtype == jax_tree[name].dtype
            np.testing.assert_array_equal(leaf, want[key][name].numpy())
    header = (tmp_path / "demo5_metrics.csv").read_text().splitlines()
    stored = (DEMOS / "out" / "demo5_metrics.csv").read_text().splitlines()
    assert header[0] == stored[0] == "step,wall_s,loss"
    assert len(header) == D5_STEPS + 1
    np.testing.assert_allclose(
        [float(row.split(",")[2]) for row in header[1:]], losses, rtol=1e-7)


def test_demo_main_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("torch_demo1_square", "torch_demo2_cube",
                 "torch_demo3_textured", "torch_demo4_lit",
                 "torch_demo5_deferred"):
        with pytest.raises(RuntimeError, match="CUDA card"):
            _load(name).main(out=str(tmp_path))
