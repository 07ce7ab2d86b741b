"""bench_configs_torch.py's scenes against dirt_tpu's, on the CPU.

Configs 1 and 2 of the port's sheet (one triangle at 64 x 64, the cube at
256 x 256) build, render and differentiate on the CPU through the plain
versions (the timing functions stay unrun). Their forwards are held to
``dirt_tpu.rasterise`` on the same scene as ``bench_configs.py`` builds it
(default caps there, honest caps here: an untruncated render is the same
image): face ids equal on all but 1% of the pixels and pixels within 1e-5
where they agree; the gradients of ``sum(image * w)`` within 1e-4 of max
|gradient| of ``dirt_tpu``'s.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_configs_torch as sheet
import dirt_tpu
from dirt_tpu.core import matrices, mesh
from dirt_tpu_torch import RasterConfig

RAZOR = 0.01


def _jax_scene(n):
    """(background, leaves, colors or None, faces, w) of config ``n`` of
    ``bench_configs.py``."""
    if n == 1:
        verts = jnp.array([[-0.5, -0.5, 0, 1], [0.5, -0.5, 0, 1],
                           [0.0, 0.6, 0, 1]], jnp.float32)
        colors = jnp.ones((3, 1), jnp.float32)
        return (jnp.zeros((64, 64, 1), jnp.float32), (verts,), colors,
                jnp.array([[0, 1, 2]], jnp.int32),
                np.random.RandomState(1).rand(64, 64, 1))
    verts_obj, faces = mesh.cube()
    model_view = matrices.compose(
        matrices.rodrigues(jnp.asarray((0.4, 0.3, 0.0), jnp.float32)),
        matrices.translation(jnp.array([0.0, 0.0, -3.0])),
    )
    projection = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)
    clip = matrices.transform_homogeneous(
        jnp.asarray(verts_obj), matrices.compose(model_view, projection))
    colors = jnp.asarray(np.random.RandomState(0).rand(len(verts_obj), 3),
                         jnp.float32)
    return (jnp.zeros((256, 256, 3), jnp.float32), (clip, colors), None,
            jnp.asarray(faces), np.random.RandomState(1).rand(256, 256, 3))


@functools.lru_cache(maxsize=None)
def _jax(n):
    """(image, fid, gradients) of ``dirt_tpu`` on config ``n``."""
    bg, leaves, colors, faces, w = _jax_scene(n)
    w = jnp.asarray(w, jnp.float32)

    def render(*args):
        return dirt_tpu.rasterise_with_aux(
            bg, args[0], colors if colors is not None else args[1], faces)

    image, fid, _, _ = render(*leaves)
    grads = jax.grad(lambda *a: jnp.sum(render(*a)[0] * w),
                     argnums=tuple(range(len(leaves))))(*leaves)
    return (np.asarray(image), np.asarray(fid),
            [np.asarray(g) for g in grads])


@functools.lru_cache(maxsize=None)
def _port(n):
    """(config, image, fid, gradients) of the port's config ``n``."""
    import dirt_tpu_torch

    config = sheet.CONFIGS[n - 1]("cpu")
    with torch.no_grad():
        image = config.forward(*config.leaves)
    # The forward's face ids: the same render through rasterise_with_aux.
    if n == 1:
        bg = torch.zeros((64, 64, 1))
        colors = torch.ones((3, 1))
        clip = config.leaves[0]
    else:
        bg = torch.zeros((256, 256, 3))
        clip, colors = config.leaves
    faces = torch.as_tensor(_jax_scene(n)[3].tolist())
    fid = dirt_tpu_torch.rasterise_with_aux(bg, clip, colors, faces,
                                            config=config.raster)[1]
    grads = sheet.gradient_step(config)(*config.leaves)
    return config, image.numpy(), fid.numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("n", [1, 2])
def test_config_forward_matches_jax(n):
    want, want_fid, _ = _jax(n)
    config, got, got_fid, _ = _port(n)
    assert got.shape == want.shape == (config.size, config.size,
                                       want.shape[-1])
    same = got_fid == want_fid
    assert (~same).mean() <= RAZOR and (got_fid >= 0).any()
    np.testing.assert_allclose(got[same], want[same], rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2])
def test_config_gradients_match_jax(n):
    want = _jax(n)[2]
    got = _port(n)[3]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and np.abs(w).max() > 0
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


@pytest.mark.parametrize("n", [1, 2])
def test_config_loss_weights_the_forward(n):
    """``loss`` is ``sum(forward * w)`` with ``w = RandomState(1).rand``,
    under the suggested caps (concrete: ``bin_cap`` measured)."""
    config, image = _port(n)[:2]
    assert isinstance(config.raster, RasterConfig)
    assert config.raster.bin_cap is not None
    w = sheet.weights(config.size, image.shape[-1], "cpu")
    with torch.no_grad():
        loss = float(config.loss(*config.leaves))
    assert loss == pytest.approx(float((torch.as_tensor(image) * w).sum()),
                                 rel=1e-6)


def test_honest_raises_on_overflowing_caps(monkeypatch):
    import dirt_tpu_torch

    tight = RasterConfig(bin_cap=1, expand_cap=1, engine="dense")
    monkeypatch.setattr(dirt_tpu_torch, "suggest_raster_config",
                        lambda *a, **k: tight)
    verts_obj, faces = mesh.cube()
    clip = sheet.posed(torch.as_tensor(verts_obj), "cpu")
    with pytest.raises(RuntimeError, match="overflow"):
        sheet.honest(clip, torch.as_tensor(faces.astype(np.int64)), 256)
