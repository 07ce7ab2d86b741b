"""Gradients through the port's near-plane clip, and ``rasterise_batch``.

The port's clip path is plain torch, so its gradients come from autograd
(the compaction's gathers reduce through the ``index`` backward). The
checks of tests/test_clipping.py, on the packed engine: gradients flow
and are finite, reach vertices behind the camera (only possible through
the clip's interpolation), and match central finite differences through
the whole clipped render (see the FD test for its scene and tolerances).

``rasterise_batch`` (B = 2) against ``dirt_tpu.rasterise_batch``: images
equal within 1e-5 absolute except on at most 0.5% of pixels (razor-edge
fid flips, the policy of test_torch_pipeline.py); its gradients equal the
per-view renders' exactly (the same ops on the same inputs).
"""

import functools

import numpy as np
import pytest
import torch

import dirt_tpu
import dirt_tpu_torch
from _torch_port_scene import SIZE, sphere_scene
from dirt_tpu.ops.raster import RasterConfig as JaxConfig
from dirt_tpu_torch import convert
from dirt_tpu_torch.ops.raster import RasterConfig

PACKED = RasterConfig(engine="packed")


def _straddle_scene(seed=5, n=40, channels=3, h=64, w=128):
    """Random triangles with w straddling the near plane (the scene of
    tests/test_clipping.py), as tensors."""
    rng = np.random.RandomState(seed)
    v = rng.uniform(-1.2, 1.2, (3 * n, 4)).astype(np.float32)
    v[:, 2] = rng.uniform(-0.5, 0.5, 3 * n)
    v[:, 3] = rng.uniform(0.5, 2.0, 3 * n)
    behind = rng.rand(3 * n) < 0.25
    v[behind, 3] = -rng.uniform(0.2, 1.0, behind.sum()).astype(np.float32)
    colors = rng.rand(3 * n, channels).astype(np.float32)
    faces = np.arange(3 * n, dtype=np.int64).reshape(n, 3)
    bg = rng.rand(h, w, channels).astype(np.float32)
    return (torch.tensor(v), torch.tensor(colors), torch.tensor(faces),
            torch.tensor(bg))


def test_clip_gradients_flow_and_are_finite():
    verts, colors, faces, bg = _straddle_scene(seed=9, n=12)
    verts.requires_grad_()
    colors.requires_grad_()
    img, _, _, overflow = dirt_tpu_torch.rasterise_with_aux(
        bg, verts, colors, faces, config=PACKED, clip=True)
    assert not bool(overflow)
    torch.mean(img ** 2).backward()
    assert torch.isfinite(verts.grad).all()
    assert torch.isfinite(colors.grad).all()
    behind = verts.detach()[:, 3] <= 0
    assert behind.any()
    assert float(verts.grad[behind].abs().sum()) > 0


def test_clip_interior_gradient_matches_fd():
    """Finite differences through the clipped render of one face whose
    vertex 1 lies past the near plane (z + w < 0, w > 0: the clipped quad
    is visible; tests/test_clipping.py's vertex at w < 0 leaves a seam at
    w < 0 that setup culls, so nothing renders there in either package).

    Only pixels at least 3 px inside the face carry weight, so no coverage
    change enters the loss and FD sees the exact interior gradient. The
    analytic gradient also holds DIRT's boundary term along the clipped
    quad's diagonal (its two triangles have different slot ids), which FD
    of the continuous image does not see: sign only for vertex 1, whose
    motion moves the diagonal; magnitude within 10% for x, y and w of the
    vertices in front.
    """
    v = torch.tensor(
        [[-0.8, -0.8, 0.2, 1.5],
         [3.0, -0.5, -1.0, 0.5],   # past the near plane
         [-0.5, 3.0, 0.3, 1.2]])
    colors = torch.tensor([[1.0, 0.2], [0.1, 0.9], [0.4, 0.5]])
    faces = torch.tensor([[0, 1, 2]])
    bg = torch.zeros((48, 128, 2))
    config = dirt_tpu_torch.suggest_raster_config(v, faces, 48, 128,
                                                  config=PACKED, clip=True)
    _, fid, _, overflow = dirt_tpu_torch.rasterise_with_aux(
        bg, v, colors, faces, config=config, clip=True)
    assert not bool(overflow)
    hole = (fid < 0).to(torch.float32)[None, None]
    inner = torch.nn.functional.max_pool2d(hole, 7, stride=1,
                                           padding=3)[0, 0] == 0
    assert inner.sum() > 1000
    gsel = torch.tensor(
        np.random.RandomState(0).rand(48, 128, 2).astype(np.float32))
    gsel = gsel * inner[..., None]

    def loss(vv):
        return torch.sum(dirt_tpu_torch.rasterise(
            bg, vv, colors, faces, config=config, clip=True).double() * gsel)

    leaf = v.clone().requires_grad_()
    loss(leaf).backward()
    g = leaf.grad
    eps = 1e-3
    for (i, j), magnitude in [
        ((1, 0), False), ((1, 1), False), ((1, 3), False),
        ((0, 0), True), ((0, 1), True), ((0, 3), True),
        ((2, 0), True), ((2, 1), True), ((2, 3), True),
    ]:
        vp, vm = v.clone(), v.clone()
        vp[i, j] += eps
        vm[i, j] -= eps
        fd = (float(loss(vp)) - float(loss(vm))) / (2 * eps)
        an = float(g[i, j])
        assert abs(fd) > 1.0, (i, j, fd)
        assert np.sign(fd) == np.sign(an), (i, j, fd, an)
        if magnitude:
            assert abs(an - fd) / abs(fd) < 0.1, (i, j, fd, an)


@functools.lru_cache(maxsize=None)
def _batch_scene():
    """Two views of one small sphere (distances 3.0 and 2.4), one config
    that fits both (the larger of each suggested cap)."""
    views = [sphere_scene(distance=d, seed=s) for d, s in ((3.0, 0), (2.4, 1))]
    faces = views[0][2]
    verts = np.stack([v[0] for v in views])
    colors = np.stack([v[1] for v in views])
    bg = np.random.RandomState(15).rand(2, SIZE, SIZE, 3).astype(np.float32)
    configs = [dirt_tpu.suggest_raster_config(
        verts[b], faces, SIZE, SIZE, config=JaxConfig(engine="packed"))
        for b in range(2)]
    caps = ("expand_cap", "budget", "pool_cap", "work_cap", "clip_cap",
            "bin_cap")
    config = configs[0]._replace(**{
        k: max(getattr(c, k) for c in configs) for k in caps})
    return bg, verts, colors, faces, config


def test_rasterise_batch_matches_jax():
    bg, verts, colors, faces, config = _batch_scene()
    want = np.asarray(dirt_tpu.rasterise_batch(bg, verts, colors, faces,
                                               config=config))
    got = dirt_tpu_torch.rasterise_batch(
        torch.tensor(bg), torch.tensor(verts), torch.tensor(colors),
        torch.tensor(faces), config=convert.config_from_jax(config))
    assert got.shape == (2, SIZE, SIZE, 3)
    differ = np.abs(got.numpy() - want).max(axis=-1) > 1e-5
    assert differ.mean() <= 0.005
    for b in range(2):
        _, fid, _, overflow = dirt_tpu_torch.rasterise_with_aux(
            torch.tensor(bg[b]), torch.tensor(verts[b]),
            torch.tensor(colors[b]), torch.tensor(faces),
            config=convert.config_from_jax(config))
        assert not bool(overflow) and (fid >= 0).float().mean() > 0.2


def test_rasterise_batch_gradients_equal_per_view():
    bg, verts, colors, faces, config = _batch_scene()
    config = convert.config_from_jax(config)
    w = torch.tensor(
        np.random.RandomState(16).randn(2, SIZE, SIZE, 3).astype(np.float32))
    leaves = [torch.tensor(a, requires_grad=True) for a in (verts, colors)]
    (dirt_tpu_torch.rasterise_batch(
        None, *leaves, torch.tensor(faces), height=SIZE, width=SIZE,
        channels=3, config=config) * w).sum().backward()
    for b in range(2):
        view = [torch.tensor(a[b], requires_grad=True)
                for a in (verts, colors)]
        (dirt_tpu_torch.rasterise(
            None, *view, torch.tensor(faces), height=SIZE, width=SIZE,
            channels=3, config=config) * w[b]).sum().backward()
        for batch_leaf, view_leaf in zip(leaves, view):
            assert torch.equal(batch_leaf.grad[b], view_leaf.grad)
            assert view_leaf.grad.abs().max() > 0


def test_rasterise_batch_needs_a_size_without_background():
    bg, verts, colors, faces, _ = _batch_scene()
    with pytest.raises(ValueError, match="height, width and channels"):
        dirt_tpu_torch.rasterise_batch(None, verts, colors, faces)
