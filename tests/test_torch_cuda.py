"""dirt_tpu_torch's CUDA kernel on the card (``cuda`` marker).

Every test here needs a CUDA device and nvcc; without one it skips. This
file imports torch and the port only (no jax), so on the machine with the
card it runs without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: the kernel against its plain version on the card, fid and
zbuf equal (the kernel is built with -fmad=false and IEEE division, so
both round alike), pixels allclose(rtol=1e-6, atol=1e-6). The whole
forward on the card against the same forward on the CPU: fid equal,
pixels and zbuf allclose(rtol=1e-6, atol=1e-6), overflow flag equal.
"""

import numpy as np
import pytest
import torch

import dirt_tpu_torch
from _torch_port_scene import screen_soup, sphere_scene
from dirt_tpu_torch import convert
from dirt_tpu_torch.ops import raster, raster_fwd
from dirt_tpu_torch.ops.triangle_setup import screen_from_clip

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _faces(kind, height, width, channels):
    """Screen-space faces [F, 3, 4] and attributes [F, 3, C] (numpy)."""
    if kind == "soup":
        return screen_soup(150, height, width, seed=9, channels=channels,
                           spread=30.0)
    clip, _, faces = sphere_scene(24, 32)
    fv = screen_from_clip(torch.tensor(clip), height, width).numpy()[faces]
    attrs = np.random.RandomState(2).rand(*faces.shape, channels)
    return fv, attrs.astype(np.float32)


# (scene, height, width, channels, tile_h): padded sizes, both tile
# heights, one to five channels.
_KERNEL_CASES = [
    ("sphere", 128, 128, 3, 32),
    ("sphere", 256, 384, 1, 64),
    ("soup", 100, 130, 5, 32),
    ("soup", 200, 256, 2, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,height,width,channels,tile_h", _KERNEL_CASES)
def test_kernel_matches_plain_on_card(cuda, kind, height, width, channels,
                                      tile_h):
    fv, fa = _faces(kind, height, width, channels)
    fv = torch.tensor(fv, device=cuda)
    bg = torch.rand(height, width, channels, device=cuda)
    config = raster.suggest_config(
        fv, height, width, raster.RasterConfig(engine="packed", tile_h=tile_h))
    # This test checks the kernel, not cap sizing: widen the budget, which
    # the suggested caps can undercount with several tile columns (the
    # reference's count, kept for parity; ROADMAP Queue 3).
    config = config._replace(budget=4 * config.budget)
    table2, bins, bg_chw, cfg = raster.prepare_packed(
        fv, torch.tensor(fa, device=cuda), bg, config)
    assert not bool(bins.overflow)
    before = raster_fwd.LAUNCHES
    pix_k, fid_k, z_k = raster_fwd.raster_forward_packed(
        table2, bins, bg_chw, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
        rows=bins.rows)
    torch.cuda.synchronize()
    assert raster_fwd.LAUNCHES == before + 1
    pix_p, fid_p, z_p = raster_fwd.raster_forward_packed_plain(
        bins.rows, bins, bg_chw, tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    assert torch.equal(fid_k, fid_p)
    assert torch.equal(z_k, z_p)
    torch.testing.assert_close(pix_k, pix_p, **TOL)
    assert (fid_k >= 0).any() and (fid_k < 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("distance,clip", [(3.0, False), (3.0, True),
                                           (0.9, True)])
def test_forward_on_card_matches_cpu(cuda, distance, clip):
    verts, colors, faces = sphere_scene(24, 32, distance=distance)
    bg = np.random.RandomState(6).rand(192, 256, 3).astype(np.float32)
    outs = []
    for device in ("cpu", cuda):
        scene = convert.scene_from_numpy(bg, verts, colors, faces, device)
        config = dirt_tpu_torch.suggest_raster_config(
            scene[1], scene[3], 192, 256,
            config=dirt_tpu_torch.RasterConfig(engine="packed"), clip=clip)
        outs.append((config, dirt_tpu_torch.rasterise_with_aux(
            *scene, config=config, clip=clip)))
    (cfg_c, (pix_c, fid_c, z_c, ovf_c)), (cfg_g, (pix_g, fid_g, z_g,
                                                   ovf_g)) = outs
    assert cfg_g == cfg_c
    assert bool(ovf_g) is bool(ovf_c) is False
    assert torch.equal(fid_g.cpu(), fid_c)
    torch.testing.assert_close(pix_g.cpu(), pix_c, **TOL)
    torch.testing.assert_close(z_g.cpu(), z_c, **TOL)
