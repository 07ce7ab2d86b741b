"""dirt_tpu_torch's CUDA kernels on the card (``cuda`` marker).

Every test here needs a CUDA device and nvcc; without one it skips. This
file imports torch and the port only (no jax), so on the machine with the
card it runs without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: the forward kernel against its plain version on the card,
fid and zbuf equal (the kernel is built with -fmad=false and IEEE
division, so both round alike), pixels allclose(rtol=1e-6, atol=1e-6).
The prologue kernel: bits equal, sval allclose(rtol=1e-6, atol=1e-6). The
backward kernel: entry rows allclose(rtol=1e-5, atol=1e-6) (same
expressions and the same per-row summation order as its plain version;
the margin allows for a torch CUDA op rounding one step otherwise), and
equal on two runs (deterministic). The whole forward on the card against
the same forward on the CPU: fid equal, pixels and zbuf allclose(rtol=1e-6,
atol=1e-6), overflow flag equal. Gradients on the card against the CPU:
max |diff| <= 1e-4 max |gradient| (the card's scatter-adds and the CPU's
sum in other orders).
"""

import numpy as np
import pytest
import torch

import dirt_tpu_torch
from _torch_port_scene import screen_soup, sphere_scene
from dirt_tpu_torch import convert
from dirt_tpu_torch.ops import packed_bwd, raster, raster_fwd
from dirt_tpu_torch.ops.triangle_setup import screen_from_clip, setup_planes

TOL = dict(rtol=1e-6, atol=1e-6)
TOL_BWD = dict(rtol=1e-5, atol=1e-6)


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


def _backward_inputs(cuda, kind, height, width, channels, tile_h):
    """The backward's prepared inputs on the card for one _KERNEL_CASES
    case: its forward, a random upstream gradient, and the prologue run
    through its plain version (the prologue kernel is tested apart)."""
    fv, fa = _faces(kind, height, width, channels)
    fv = torch.tensor(fv, device=cuda)
    fa = torch.tensor(fa, device=cuda)
    bg = torch.rand(height, width, channels, device=cuda)
    config = raster.suggest_config(
        fv, height, width, raster.RasterConfig(engine="packed", tile_h=tile_h))
    config = config._replace(budget=4 * config.budget)
    pixels, fid, zbuf, bins, cfg = raster._forward_impl(fv, fa, bg, config)
    assert not bool(bins.overflow)
    grad = torch.randn(height, width, channels, device=cuda)
    geo, att, _ = setup_planes(fv, fa)
    return packed_bwd.prepare_backward_packed(
        geo, att, fid, zbuf, pixels, grad, bins, cfg.tile_h, cfg.tile_w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,height,width,channels,tile_h", _KERNEL_CASES)
def test_prologue_kernel_matches_plain_on_card(cuda, kind, height, width,
                                               channels, tile_h):
    prep = _backward_inputs(cuda, kind, height, width, channels, tile_h)
    args = (prep.fid_p, torch.rand_like(prep.fid_p, dtype=torch.float32),
            prep.pix_cf, prep.grad_cf)
    before = packed_bwd.LAUNCHES_PROLOGUE
    bits_k, sval_k = packed_bwd.fused_neighbor_prologue(*args)
    torch.cuda.synchronize()
    assert packed_bwd.LAUNCHES_PROLOGUE == before + 1
    bits_p, sval_p = packed_bwd.fused_neighbor_prologue_plain(*args)
    assert torch.equal(bits_k, bits_p)
    torch.testing.assert_close(sval_k, sval_p, **TOL)
    assert (bits_k != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,height,width,channels,tile_h", _KERNEL_CASES)
def test_backward_kernel_matches_plain_on_card(cuda, kind, height, width,
                                               channels, tile_h):
    prep = _backward_inputs(cuda, kind, height, width, channels, tile_h)
    before = packed_bwd.LAUNCHES_BWD
    rows_k = packed_bwd.packed_entry_rows(prep)
    torch.cuda.synchronize()
    assert packed_bwd.LAUNCHES_BWD == before + 1
    rows_p = packed_bwd.packed_entry_rows_plain(
        prep, prep.bins.rows, 0, prep.budget_chunks)
    torch.testing.assert_close(rows_k, rows_p, **TOL_BWD)
    assert (rows_k != 0).any()
    # Deterministic: a second run is equal.
    assert torch.equal(rows_k, packed_bwd.packed_entry_rows(prep))
    # Chunk slices compose exactly.
    mid = prep.budget_chunks // 2
    halves = torch.cat([packed_bwd.packed_entry_rows(prep, 0, mid),
                        packed_bwd.packed_entry_rows(prep, mid)])
    assert torch.equal(halves, rows_k)


@pytest.mark.cuda
def test_backward_kernel_rejects_too_many_channels(cuda):
    prep = _backward_inputs(cuda, "soup", 64, 128, 1, 32)
    wide = packed_bwd.MAX_CHANNELS + 1
    prep.channels = wide
    prep.pix_cf = prep.pix_cf.expand(wide, -1, -1).contiguous()
    prep.grad_cf = prep.grad_cf.expand(wide, -1, -1).contiguous()
    with pytest.raises(ValueError, match="channels"):
        packed_bwd.packed_entry_rows(prep)


def _rel_err(got, want):
    """max |got - want| / max |want| (the difference itself when want is
    0, as d_background is where the mesh covers the whole image)."""
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    return diff / scale if scale else diff


@pytest.mark.cuda
@pytest.mark.parametrize("distance,clip", [(3.0, False), (3.0, True),
                                           (0.9, True)])
def test_gradients_on_card_match_cpu(cuda, distance, clip):
    verts, colors, faces = sphere_scene(24, 32, distance=distance)
    bg = np.random.RandomState(6).rand(192, 256, 3).astype(np.float32)
    w = np.random.RandomState(7).randn(192, 256, 3).astype(np.float32)
    grads = []
    for device in ("cpu", cuda):
        bg_t, v_t, c_t, f_t = convert.scene_from_numpy(bg, verts, colors,
                                                       faces, device)
        config = dirt_tpu_torch.suggest_raster_config(
            v_t, f_t, 192, 256,
            config=dirt_tpu_torch.RasterConfig(engine="packed"), clip=clip)
        leaves = [t.clone().requires_grad_() for t in (v_t, c_t, bg_t)]
        pix = dirt_tpu_torch.rasterise(leaves[2], leaves[0], leaves[1], f_t,
                                       config=config, clip=clip)
        (pix * torch.tensor(w, device=device)).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    for g_cpu, g_card in zip(*grads):
        assert torch.isfinite(g_card).all()
        assert _rel_err(g_card, g_cpu) <= 1e-4
