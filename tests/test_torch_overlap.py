"""The overlapped row-sharded backward of dirt_tpu_torch on the CPU.

``parallel.overlap`` runs the sharded backward in chunks, each chunk's
parameter gradients summed over the group at once. On ``LocalGroup(n)``
(n slabs in one process) it is held against ``dirt_tpu.parallel.overlap``
on four of the eight virtual CPU devices the root conftest sets up, against
``dirt_tpu.rasterise``'s single-device ``jax.grad`` and against the port's
own single-device render, with ``tests/test_overlap.py``'s scenes and
tolerances: loss rtol 1e-5; gradients rtol = atol = 1e-4; one chunk against
four rtol 1e-5, atol 1e-6. Each JAX program is compiled once in this file
(``lru_cache``). ``tests/test_torch_distributed.py`` runs the op over gloo
processes, where a second sum of the parameter gradients would show.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import dirt_tpu
import dirt_tpu_torch
from dirt_tpu.ops.raster import RasterConfig as JaxConfig
from dirt_tpu.parallel import overlap as jax_overlap
from dirt_tpu_torch import RasterConfig
from dirt_tpu_torch.ops import packed_bwd
from dirt_tpu_torch.parallel.group import LocalGroup
from dirt_tpu_torch.parallel.overlap import (
    overlapped_loss_and_grads,
    rasterise_overlapped,
)
from dirt_tpu_torch.parallel.sharding import rasterise_sharded

CFG = dict(tile_h=8, tile_w=128, bin_cap=64)
PACKED_CFG = dict(tile_h=8, tile_w=128, engine="packed", expand_cap=128,
                  budget=2048)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CHUNK_TOL = dict(rtol=1e-5, atol=1e-6)
OUTPUTS = ["loss", "verts", "colors", "background"]


def _scene(seed=3, num_faces=24, num_verts=30, size=128):
    """``tests/test_overlap.py``'s scene, as numpy: (vertices, colors,
    faces, background, target)."""
    rng = np.random.RandomState(seed)
    verts = np.zeros((num_verts, 4), np.float32)
    verts[:, :2] = rng.uniform(-0.9, 0.9, (num_verts, 2))
    verts[:, 2] = rng.uniform(-0.5, 0.5, num_verts)
    verts[:, 3] = 1.0
    faces = rng.randint(0, num_verts, (num_faces, 3)).astype(np.int32)
    colors = rng.uniform(0, 1, (num_verts, 3)).astype(np.float32)
    bg = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
    return verts, colors, faces, bg, target


def _weights():
    return np.random.RandomState(7).rand(64, 64, 3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_overlapped():
    """dirt_tpu's (loss, d_vertices, d_colors, d_background) of the L2 loss
    on four devices, two chunks, as numpy."""
    verts, colors, faces, bg, target = _scene()
    mesh = Mesh(np.array(jax.devices()[:4]), ("tiles",))
    with mesh:
        out = jax.jit(lambda v, c, b: jax_overlap.overlapped_loss_and_grads(
            b, v, c, jnp.asarray(faces), jnp.asarray(target), mesh, "tiles",
            JaxConfig(**CFG), n_chunks=2))(
                jnp.asarray(verts), jnp.asarray(colors), jnp.asarray(bg))
    return [np.asarray(a) for a in out]


@functools.lru_cache(maxsize=None)
def _port_overlapped():
    verts, colors, faces, bg, target = _scene()
    out = overlapped_loss_and_grads(bg, verts, colors, faces, target,
                                    LocalGroup(4), RasterConfig(**CFG),
                                    n_chunks=2)
    return [a.numpy() for a in out]


@functools.lru_cache(maxsize=None)
def _port_single_l2():
    """The port's single-device loss and gradients of the same L2 loss."""
    verts, colors, faces, bg, target = (torch.tensor(a) for a in _scene())
    leaves = [t.clone().requires_grad_() for t in (verts, colors, bg)]
    image = dirt_tpu_torch.rasterise(leaves[2], leaves[0], leaves[1], faces,
                                     config=RasterConfig(**CFG), clip=False)
    loss = ((image - target) ** 2).sum()
    loss.backward()
    return [loss.detach().numpy(), *(t.grad.numpy() for t in leaves)]


@pytest.mark.parametrize("which", range(4), ids=OUTPUTS)
@pytest.mark.parametrize("reference", ["jax", "single_device"])
def test_overlapped_loss_and_grads_matches(reference, which):
    want = (_jax_overlapped() if reference == "jax" else _port_single_l2())
    got = _port_overlapped()
    assert got[which].shape == want[which].shape
    tol = dict(rtol=1e-5) if which == 0 else GRAD_TOL
    np.testing.assert_allclose(got[which], want[which], **tol)
    assert np.abs(want[1]).max() > 0


def _arbitrary_loss(image):
    """``tests/test_overlap.py``'s downstream loss."""
    weights = torch.tensor(_weights())
    target = torch.tensor(_scene(seed=5, size=64)[4])
    return torch.sum(torch.sin(image * 2.0) * weights + image * target)


@functools.lru_cache(maxsize=None)
def _jax_single_arbitrary():
    """``jax.grad`` of the arbitrary loss over ``dirt_tpu.rasterise`` on one
    device (packed engine), as numpy."""
    verts, colors, faces, bg, target = _scene(seed=5, size=64)
    weights = jnp.asarray(_weights())

    def loss(v, c, b):
        image = dirt_tpu.rasterise(b, v, c, jnp.asarray(faces),
                                   config=JaxConfig(**PACKED_CFG), clip=False)
        return jnp.sum(jnp.sin(image * 2.0) * weights + image * target)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(verts), jnp.asarray(colors), jnp.asarray(bg))
    return [np.asarray(g) for g in grads]


def _port_grads(render, seed=5):
    """Gradients of the arbitrary loss to (vertices, colors, background)."""
    verts, colors, faces, bg, _ = (torch.tensor(a)
                                   for a in _scene(seed=seed, size=64))
    leaves = [t.clone().requires_grad_() for t in (verts, colors, bg)]
    _arbitrary_loss(render(leaves[2], leaves[0], leaves[1], faces)).backward()
    return [t.grad for t in leaves]


@functools.lru_cache(maxsize=None)
def _port_single_arbitrary():
    return _port_grads(lambda b, v, c, f: dirt_tpu_torch.rasterise(
        b, v, c, f, config=RasterConfig(**PACKED_CFG), clip=False))


def _overlapped(slabs, chunks, config=PACKED_CFG):
    def render(b, v, c, f):
        return rasterise_sharded(b, v, c, f, LocalGroup(slabs),
                                 config=RasterConfig(**config),
                                 overlap_chunks=chunks)
    return render


@pytest.mark.parametrize("chunks", [1, 2, 3])
@pytest.mark.parametrize("slabs", [1, 2, 4])
def test_overlap_chunks_match_jax_single_device_grad(slabs, chunks):
    """rasterise_sharded(overlap_chunks=chunks) under an arbitrary
    downstream loss against dirt_tpu.rasterise's single-device jax.grad."""
    got = _port_grads(_overlapped(slabs, chunks))
    for g, w, name in zip(got, _jax_single_arbitrary(),
                          ("verts", "colors", "bg")):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **GRAD_TOL)
    assert np.abs(_jax_single_arbitrary()[0]).max() > 0


@pytest.mark.parametrize("chunks", [1, 2, 3])
@pytest.mark.parametrize("slabs", [1, 2, 4])
def test_overlap_slabs_and_chunks_match_unsharded(slabs, chunks):
    got = _port_grads(_overlapped(slabs, chunks))
    for g, w, name in zip(got, _port_single_arbitrary(),
                          ("verts", "colors", "bg")):
        torch.testing.assert_close(g, w, msg=lambda m: f"{name}: {m}",
                                   **GRAD_TOL)


@pytest.mark.parametrize("path", ["rasterise_overlapped",
                                  "overlapped_loss_and_grads"])
def test_one_chunk_equals_four(path):
    """The chunk count moves only the order of float32 sums."""
    verts, colors, faces, bg, target = _scene(seed=11 if path.startswith(
        "rasterise") else 9, size=64)
    outs = []
    for chunks in (1, 4):
        if path == "rasterise_overlapped":
            def render(b, v, c, f, chunks=chunks):
                return rasterise_overlapped(b, v, c, f, LocalGroup(2),
                                            RasterConfig(**PACKED_CFG),
                                            n_chunks=chunks)
            outs.append(_port_grads(render, seed=11))
        else:
            outs.append(overlapped_loss_and_grads(
                bg, verts, colors, faces, target, LocalGroup(2),
                RasterConfig(**CFG), n_chunks=chunks))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, **CHUNK_TOL)
    assert outs[0][0].abs().max() > 0


def test_backward_runs_the_kernel_once_per_chunk_and_slab(monkeypatch):
    """Three chunks over two slabs: six slices of the budget's 32 chunks,
    at the reference's bounds round(k * 32 / 3), and the image, fid and
    gradients of the non-overlapped sharded render."""
    calls = []
    entry_rows = packed_bwd.packed_entry_rows

    def spy(prep, c_lo=0, c_hi=None):
        calls.append((prep.budget_chunks, c_lo, c_hi))
        return entry_rows(prep, c_lo, c_hi)

    verts, colors, faces, bg, _ = (torch.tensor(a)
                                   for a in _scene(seed=5, size=64))
    config = RasterConfig(**PACKED_CFG)
    leaves = [t.clone().requires_grad_() for t in (verts, colors, bg)]
    monkeypatch.setattr(packed_bwd, "packed_entry_rows", spy)
    image, fid, _, overflow = rasterise_sharded(
        leaves[2], leaves[0], leaves[1], faces, LocalGroup(2), config=config,
        overlap_chunks=3, with_aux=True)
    _arbitrary_loss(image).backward()
    assert calls == [(32, 0, 11), (32, 0, 11), (32, 11, 21), (32, 11, 21),
                     (32, 21, 32), (32, 21, 32)]
    monkeypatch.undo()
    want_image, want_fid, _, _ = rasterise_sharded(
        bg, verts, colors, faces, LocalGroup(2), config=config, with_aux=True)
    assert torch.equal(image, want_image) and torch.equal(fid, want_fid)
    assert not bool(overflow)
    want = _port_grads(lambda b, v, c, f: rasterise_sharded(
        b, v, c, f, LocalGroup(2), config=config))
    for g, w in zip((t.grad for t in leaves), want):
        torch.testing.assert_close(g, w, **CHUNK_TOL)


def test_more_chunks_than_the_budget_has_are_clamped():
    """n_chunks past the budget's 32 chunks runs one slice per chunk."""
    want = _port_grads(_overlapped(2, 32))
    got = _port_grads(_overlapped(2, 1000))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_overlap_rejects_bad_arguments():
    verts, colors, faces, bg, target = _scene(seed=5, size=64)
    with pytest.raises(ValueError, match="requires the packed engine"):
        rasterise_overlapped(bg, verts, colors, faces, LocalGroup(2),
                             RasterConfig(**CFG))
    with pytest.raises(ValueError, match=r"must divide devices\*tile_h"):
        rasterise_overlapped(bg, verts, colors, faces, LocalGroup(3),
                             RasterConfig(**PACKED_CFG))
    with pytest.raises(ValueError, match="slab height must divide n_chunks"):
        overlapped_loss_and_grads(bg, verts, colors, faces, target,
                                  LocalGroup(2), RasterConfig(**CFG),
                                  n_chunks=3)
    with pytest.raises(ValueError, match="must divide devices"):
        overlapped_loss_and_grads(bg, verts, colors, faces, target,
                                  LocalGroup(3), RasterConfig(**CFG))
