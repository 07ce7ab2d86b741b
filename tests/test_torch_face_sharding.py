"""Face-list sharding of dirt_tpu_torch on the CPU: local groups.

``parallel.face_sharding`` on ``LocalGroup(n)`` (n members in one process)
against the port's own single-device render and against
``dirt_tpu.parallel.face_sharding`` on the eight virtual CPU devices of the
root conftest, with ``tests/test_face_sharding.py``'s scenes and
tolerances: fids equal, pixels atol 3e-5; gradients of ``0.5 * sum(image **
2)`` to vertices, colors and background rtol = atol = 1e-4. With eight
members the backward's row bands are eight rows tall, which stresses the
halo rows. The JAX program is compiled once in this file (``lru_cache``).
``tests/test_torch_distributed.py`` runs the op over gloo processes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import dirt_tpu_torch
from dirt_tpu.ops.raster import RasterConfig as JaxConfig
from dirt_tpu.parallel.face_sharding import (
    rasterise_face_sharded as jax_face_sharded,
)
from dirt_tpu_torch import RasterConfig
from dirt_tpu_torch.parallel.face_sharding import rasterise_face_sharded
from dirt_tpu_torch.parallel.group import LocalGroup

CFG = dict(tile_h=8, tile_w=128, bin_cap=64)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _scene(seed=0, num_faces=48, num_verts=40):
    """``tests/test_face_sharding.py``'s scene, as numpy: (vertices, colors,
    faces, background [64, 128, 3])."""
    rng = np.random.RandomState(seed)
    verts = np.zeros((num_verts, 4), np.float32)
    verts[:, :2] = rng.uniform(-0.9, 0.9, (num_verts, 2))
    verts[:, 2] = rng.uniform(-0.5, 0.5, num_verts)
    verts[:, 3] = 1.0
    faces = rng.randint(0, num_verts, (num_faces, 3)).astype(np.int32)
    colors = rng.uniform(0, 1, (num_verts, 3)).astype(np.float32)
    bg = rng.uniform(0, 1, (64, 128, 3)).astype(np.float32)
    return verts, colors, faces, bg


def _step(render, scene):
    """(image, [d_vertices, d_colors, d_background]) of ``0.5 *
    sum(render(background, vertices, colors) ** 2)``."""
    verts, colors, _, bg = (torch.tensor(a) for a in scene)
    leaves = [t.clone().requires_grad_() for t in (verts, colors, bg)]
    image = render(leaves[2], leaves[0], leaves[1])
    (0.5 * (image ** 2).sum()).backward()
    return image.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("n", [4, 8])
def test_face_sharded_forward_matches_single_device(n):
    verts, colors, faces, bg = (torch.tensor(a) for a in _scene())
    config = RasterConfig(**CFG)
    want = dirt_tpu_torch.rasterise_with_aux(bg, verts, colors, faces,
                                             config=config, clip=False)
    got = rasterise_face_sharded(bg, verts, colors, faces, LocalGroup(n),
                                 config=config, with_aux=True)
    assert torch.equal(got[1], want[1])             # fid
    torch.testing.assert_close(got[0], want[0], atol=3e-5, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=3e-5, rtol=0)
    assert not bool(got[3]) and not bool(want[3])
    # Every member's faces win pixels: the composite really mixes them.
    owners = torch.unique(got[1][got[1] >= 0] // (48 // n))
    assert owners.tolist() == list(range(n))


@pytest.mark.parametrize("n", [4, 8])
def test_face_sharded_gradients_match_single_device(n):
    scene = _scene(seed=4)
    faces, config = torch.tensor(scene[2]), RasterConfig(**CFG)
    _, want = _step(lambda b, v, c: dirt_tpu_torch.rasterise(
        b, v, c, faces, config=config, clip=False), scene)
    _, got = _step(lambda b, v, c: rasterise_face_sharded(
        b, v, c, faces, LocalGroup(n), config=config), scene)
    for g, w, name in zip(got, want, ("verts", "colors", "bg")):
        torch.testing.assert_close(g, w, msg=lambda m: f"{name}: {m}",
                                   **GRAD_TOL)
    assert want[0].abs().max() > 0


def test_z_ties_go_to_the_lowest_global_face_id():
    """Eight identical overlapping faces, one per member: the tie resolves
    to global face 0, as on one device."""
    verts = torch.tensor([[-0.5, -0.5, 0.1, 1.0], [0.5, -0.5, 0.1, 1.0],
                          [0.0, 0.6, 0.1, 1.0]])
    faces = torch.tensor([[0, 1, 2]] * 8)
    colors = torch.tensor(np.random.RandomState(0).rand(3, 2)
                          .astype(np.float32))
    bg = torch.zeros((32, 128, 2))
    config = RasterConfig(**CFG)
    want = dirt_tpu_torch.rasterise_with_aux(bg, verts, colors, faces,
                                             config=config, clip=False)
    got = rasterise_face_sharded(bg, verts, colors, faces, LocalGroup(8),
                                 config=config, with_aux=True)
    torch.testing.assert_close(got[0], want[0], atol=3e-5, rtol=0)
    assert set(want[1].unique().tolist()) == {-1, 0}
    assert torch.equal(got[1], want[1])


@functools.lru_cache(maxsize=None)
def _jax_step():
    """dirt_tpu's face-sharded image and gradients of ``0.5 * sum(image **
    2)`` over eight devices, as numpy."""
    verts, colors, faces, bg = _scene(seed=4)
    mesh = Mesh(np.array(jax.devices()[:8]), ("faces",))

    def loss(v, c, b):
        image = jax_face_sharded(b, v, c, jnp.asarray(faces), mesh,
                                 config=JaxConfig(**CFG))
        return 0.5 * jnp.sum(image ** 2), image

    with mesh:
        (_, image), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
                jnp.asarray(verts), jnp.asarray(colors), jnp.asarray(bg))
    return [np.asarray(a) for a in (image, *grads)]


@functools.lru_cache(maxsize=None)
def _port_step():
    scene = _scene(seed=4)
    faces = torch.tensor(scene[2])
    image, grads = _step(lambda b, v, c: rasterise_face_sharded(
        b, v, c, faces, LocalGroup(8), config=RasterConfig(**CFG)), scene)
    return [image.numpy(), *(g.numpy() for g in grads)]


@pytest.mark.parametrize("which", range(4),
                         ids=["image", "vertices", "colors", "background"])
def test_face_sharded_matches_jax(which):
    want, got = _jax_step()[which], _port_step()[which]
    assert got.shape == want.shape
    if which == 0:
        np.testing.assert_allclose(got, want, atol=3e-5)
    else:
        np.testing.assert_allclose(got, want, **GRAD_TOL)
        assert np.abs(want).max() > 0


def test_face_sharded_rejects_bad_arguments():
    verts, colors, faces, bg = _scene()
    with pytest.raises(ValueError, match=r"faces \(48\) must divide by 5"):
        rasterise_face_sharded(bg, verts, colors, faces, LocalGroup(5))
    with pytest.raises(ValueError, match=r"height \(64\) must divide by 3"):
        rasterise_face_sharded(bg, verts, colors, faces, LocalGroup(3))
