"""The row-sharded renderer of dirt_tpu_torch vs dirt_tpu's on its CPU mesh.

``dirt_tpu.parallel.sharding.rasterise_sharded`` runs on four of the eight
virtual CPU devices the root conftest sets up (Pallas kernels in interpret
mode); the port runs ``LocalGroup(4)`` on CPU tensors (plain versions). The
JAX side is compiled three times in this file, once each for the dense, the
streaming (CSR) and the packed engine, each compile giving image and
gradients, and cached. Tolerances are ``tests/test_sharding.py``'s: image
atol 3e-5; gradients of ``0.5 * sum(image ** 2)`` to vertices, colors and
background rtol = atol = 1e-4. The streaming engine, whose backward ends in
the CSR scatter, meets them with room: its image differs by about 1.2e-6 and
its vertex gradient by about 6e-4 where the largest entry is 882 (the two
packages sum a face's pixels in other orders). ``dryrun_multichip`` is held against the losses
``__graft_entry__.dryrun_multichip`` prints (5 and 4 decimals), and its
overlap and face-sharded variants against the loss all of dirt_tpu's
variants 2-4 give, 2128.7512, and the largest vertex gradient dirt_tpu's
face-sharded variant gives on four CPU devices, 1.0396e+03.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import __graft_entry__ as graft
from _torch_port_scene import SHARDING_CAPS, sharding_scene
from dirt_tpu.ops.raster import RasterConfig as JaxConfig
from dirt_tpu.parallel.sharding import rasterise_sharded as jax_sharded
from dirt_tpu_torch import RasterConfig, entry
from dirt_tpu_torch.parallel.group import LocalGroup
from dirt_tpu_torch.parallel.sharding import rasterise_sharded

N = 4


@functools.lru_cache(maxsize=None)
def _jax_step(engine):
    """(image, d_vertices, d_colors, d_background) of dirt_tpu's sharded
    render of ``sharding_scene(3)`` on a 4-device mesh, as numpy."""
    verts, colors, faces, bg = sharding_scene(3)
    config = JaxConfig(**SHARDING_CAPS[engine])
    mesh = Mesh(np.array(jax.devices()[:N]), ("tiles",))

    def loss(v, c, b):
        image = jax_sharded(b, v, c, jnp.asarray(faces), mesh, config=config)
        return 0.5 * jnp.sum(image ** 2), image

    with mesh:
        (_, image), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
                jnp.asarray(verts), jnp.asarray(colors), jnp.asarray(bg))
    return [np.asarray(a) for a in (image, *grads)]


@functools.lru_cache(maxsize=None)
def _port_step(engine):
    verts, colors, faces, bg = (torch.tensor(a) for a in sharding_scene(3))
    leaves = [t.clone().requires_grad_() for t in (verts, colors, bg)]
    image = rasterise_sharded(leaves[2], leaves[0], leaves[1], faces,
                              LocalGroup(N),
                              config=RasterConfig(**SHARDING_CAPS[engine]))
    (0.5 * (image ** 2).sum()).backward()
    return [image.detach().numpy(), *(t.grad.numpy() for t in leaves)]


@pytest.mark.parametrize("engine", ["dense", "csr", "packed"])
def test_sharded_image_matches_jax(engine):
    want, got = _jax_step(engine)[0], _port_step(engine)[0]
    assert got.shape == want.shape == (128, 128, 3)
    np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("which", [1, 2, 3],
                         ids=["vertices", "colors", "background"])
@pytest.mark.parametrize("engine", ["dense", "csr", "packed"])
def test_sharded_gradients_match_jax(engine, which):
    want, got = _jax_step(engine)[which], _port_step(engine)[which]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(want).max() > 0


def test_dryrun_multichip_matches_jax(capfd):
    """The data x tiles training step and the overlap variant (n = 2: one
    scene, two slabs), the two-level render and the face-sharded variant
    (n = 4: the recorded dry run's values; dirt_tpu's n = 4 run would
    compile all four variants)."""
    graft.dryrun_multichip(2)
    jax_text = capfd.readouterr().out
    jax_loss, overlap_loss = (float(x) for x in re.findall(
        r"loss=([0-9.]+)", jax_text))
    overlap_grad = float(re.search(r"overlap_chunks=2 OK: .*\|d verts\|="
                                   r"([0-9.e+]+)", jax_text).group(1))
    two = entry.dryrun_multichip(2, "cpu")
    four = entry.dryrun_multichip(4, "cpu")
    port_text = capfd.readouterr().out
    assert two["loss"] == pytest.approx(jax_loss, abs=1e-5)
    assert two["loss_two_level"] is None
    assert "dryrun_multichip OK: 2 devices (data=1 x tiles=2)" in port_text
    assert "two-level mesh OK: data=1 x dcn=2 x tiles=2" in port_text
    # The overlap variant renders the same scene as the two-level one, and
    # dirt_tpu checks the two against each other: the value both print.
    assert four["loss_two_level"] == pytest.approx(overlap_loss, abs=1e-3)
    assert four["loss_two_level"] == pytest.approx(2128.7512, abs=1e-3)
    assert four["grad_two_level"] > 0 and 0 < four["step"] <= 0.011
    assert four["loss"] != two["loss"]          # two scenes, not one
    assert "overlap_chunks=2 OK: tiles=2" in port_text
    assert "face-sharded OK: faces=4" in port_text
    for out in (two, four):
        assert out["loss_overlap"] == pytest.approx(overlap_loss, abs=1e-3)
        # dirt_tpu prints its gradient to three digits.
        assert out["grad_overlap"] == pytest.approx(overlap_grad, rel=5e-3)
    assert two["loss_face_sharded"] is None
    assert four["loss_face_sharded"] == pytest.approx(2128.7512, abs=1e-3)
    assert four["grad_face_sharded"] == pytest.approx(1.0396e3, rel=1e-4)
