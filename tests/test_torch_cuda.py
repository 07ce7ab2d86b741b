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

The dense engine: the forward kernel like the packed one (fid and zbuf
equal, pixels allclose(rtol=1e-6, atol=1e-6)); the fused backward kernel's
rows within 1e-5 of the column's largest magnitude plus 1e-6 of its plain
version (the kernel sums float32 in its own fixed order, the plain version
in float64) and equal on two runs; gradients and the flagship loss on the
card against the CPU as above.
"""

import numpy as np
import pytest
import torch

import dirt_tpu_torch
from _torch_port_scene import screen_soup, sphere_scene
from dirt_tpu_torch import convert, entry
from dirt_tpu_torch.ops import fused_bwd, packed_bwd, raster, raster_fwd
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
# heights, one to nine channels (nine is the deferred G-buffer's count).
_KERNEL_CASES = [
    ("sphere", 128, 128, 3, 32),
    ("sphere", 256, 384, 1, 64),
    ("soup", 100, 130, 5, 32),
    ("soup", 200, 256, 2, 64),
    ("sphere", 128, 256, 9, 64),
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
    wide = packed_bwd.max_channels(cuda) + 1
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


# --- the dense engine ---------------------------------------------------------

# (scene, height, width, channels, tile_h, tile_w): padded sizes, narrow
# and full-width tiles, one to nine channels.
_DENSE_CASES = [
    ("sphere", 128, 128, 3, 32, 128),
    ("sphere", 256, 384, 1, 64, 128),
    ("soup", 100, 130, 9, 32, 128),
    ("soup", 64, 80, 2, 8, 32),
]


def _dense_forward(cuda, kind, height, width, channels, tile_h, tile_w):
    fv, fa = _faces(kind, height, width, channels)
    fv = torch.tensor(fv, device=cuda)
    fa = torch.tensor(fa, device=cuda)
    bg = torch.rand(height, width, channels, device=cuda)
    config = raster.RasterConfig(engine="dense", tile_h=tile_h, tile_w=tile_w)
    table, bins, bg_chw, cfg = raster.prepare_dense(fv, fa, bg, config)
    assert not bool(bins.overflow.any())
    return fv, fa, table, bins, bg_chw, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("kind,height,width,channels,tile_h,tile_w",
                         _DENSE_CASES)
def test_dense_kernel_matches_plain_on_card(cuda, kind, height, width,
                                            channels, tile_h, tile_w):
    _, _, table, bins, bg_chw, cfg = _dense_forward(
        cuda, kind, height, width, channels, tile_h, tile_w)
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    before = raster_fwd.LAUNCHES_DENSE
    pix_k, fid_k, z_k = raster_fwd.raster_forward(
        table, bins.bins, bins.counts, bg_chw, **geom)
    torch.cuda.synchronize()
    assert raster_fwd.LAUNCHES_DENSE == before + 1
    pix_p, fid_p, z_p = raster_fwd.raster_forward_plain(
        table, bins.bins, bins.counts, bg_chw, **geom)
    assert torch.equal(fid_k, fid_p)
    assert torch.equal(z_k, z_p)
    torch.testing.assert_close(pix_k, pix_p, **TOL)
    assert (fid_k >= 0).any() and (fid_k < 0).any()
    # Slots past a tile's count are never read.
    slot = torch.arange(bins.bins.shape[1], device=cuda)[None, :]
    dirty = torch.where(slot < bins.counts[:, None], bins.bins,
                        torch.full_like(bins.bins, 1 << 30))
    again = raster_fwd.raster_forward(table, dirty, bins.counts, bg_chw,
                                      **geom)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(again, (pix_k, fid_k, z_k)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,height,width,channels,tile_h,tile_w",
                         _DENSE_CASES)
def test_fused_bwd_kernel_matches_plain_on_card(cuda, kind, height, width,
                                                channels, tile_h, tile_w):
    fv, fa, table, bins, bg_chw, cfg = _dense_forward(
        cuda, kind, height, width, channels, tile_h, tile_w)
    pix_cf, fid, zbuf = raster_fwd.raster_forward_plain(
        table, bins.bins, bins.counts, bg_chw, tile_h=cfg.tile_h,
        tile_w=cfg.tile_w)
    hp, wp = fid.shape
    # Padding as backward_fused makes it: fid -2, depth BIG_Z, values 0.
    inside = torch.zeros((hp, wp), dtype=torch.bool, device=cuda)
    inside[:height, :width] = True
    fid = torch.where(inside, fid, -2).contiguous()
    zbuf = torch.where(inside, zbuf, raster_fwd.BIG_Z).contiguous()
    pix_cf = torch.where(inside, pix_cf, 0.0).contiguous()
    grad_cf = torch.where(inside, torch.randn_like(pix_cf), 0.0).contiguous()
    bits, sval = packed_bwd.fused_neighbor_prologue_plain(fid, zbuf, pix_cf,
                                                          grad_cf)
    geo, _, _ = setup_planes(fv, fa)
    num_faces = fv.shape[0]
    args = (geo.contiguous(), bins.bins, bins.counts, fid, bits, sval,
            pix_cf, grad_cf, num_faces + 1)
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    before = fused_bwd.LAUNCHES
    rows_k = fused_bwd.fused_backward_rows(*args, bbox=bins.bbox, **geom)
    torch.cuda.synchronize()
    assert fused_bwd.LAUNCHES == before + 1
    rows_p = fused_bwd.fused_backward_rows_plain(
        geo, fid, bits, sval, pix_cf, grad_cf, num_faces + 1)
    assert rows_k.shape == rows_p.shape
    scale = rows_p.abs().amax(dim=0, keepdim=True)
    assert ((rows_k - rows_p).abs() <= 1e-5 * scale + 1e-6).all()
    assert (rows_k != 0).any() and not rows_k[num_faces:].any()
    # Deterministic: a second run is equal. Without the boxes it raises.
    assert torch.equal(rows_k, fused_bwd.fused_backward_rows(
        *args, bbox=bins.bbox, **geom))
    with pytest.raises(ValueError, match="bbox"):
        fused_bwd.fused_backward_rows(*args, **geom)


@pytest.mark.cuda
@pytest.mark.parametrize("distance,clip,engine", [
    (3.0, False, "dense"), (3.0, True, "auto"), (0.9, True, "dense")])
def test_dense_gradients_on_card_match_cpu(cuda, distance, clip, engine):
    verts, colors, faces = sphere_scene(24, 32, distance=distance,
                                        channels=9)
    bg = np.random.RandomState(6).rand(192, 256, 9).astype(np.float32)
    w = np.random.RandomState(7).randn(192, 256, 9).astype(np.float32)
    config = dirt_tpu_torch.RasterConfig(engine=engine)
    outs, grads = [], []
    for device in ("cpu", cuda):
        bg_t, v_t, c_t, f_t = convert.scene_from_numpy(bg, verts, colors,
                                                       faces, device)
        leaves = [t.clone().requires_grad_() for t in (v_t, c_t, bg_t)]
        pix, fid, zbuf, ovf = dirt_tpu_torch.rasterise_with_aux(
            leaves[2], leaves[0], leaves[1], f_t, config=config, clip=clip)
        (pix * torch.tensor(w, device=device)).sum().backward()
        outs.append((pix.detach().cpu(), fid.cpu(), zbuf.cpu(), bool(ovf)))
        grads.append([t.grad.cpu() for t in leaves])
    (pix_c, fid_c, z_c, ovf_c), (pix_g, fid_g, z_g, ovf_g) = outs
    assert ovf_g is ovf_c is False
    assert torch.equal(fid_g, fid_c)
    torch.testing.assert_close(pix_g, pix_c, **TOL)
    torch.testing.assert_close(z_g, z_c, **TOL)
    for g_cpu, g_card in zip(*grads):
        assert torch.isfinite(g_card).all()
        assert _rel_err(g_card, g_cpu) <= 1e-4


@pytest.mark.cuda
def test_entry_step_on_card_matches_cpu(cuda):
    """The flagship loss (deferred G-buffer, texture, Phong; dense engine)
    and its gradients to vertices and pose, card against CPU."""
    results = []
    for device in ("cpu", cuda):
        step, (verts, pose) = entry.entry(device=device, size=128, n_lat=12,
                                          n_lon=16)
        verts = verts.clone().requires_grad_()
        pose = pose.clone().requires_grad_()
        loss = step(verts, pose)
        loss.backward()
        results.append((loss.item(), verts.grad.cpu(), pose.grad.cpu()))
    (loss_c, dv_c, dp_c), (loss_g, dv_g, dp_g) = results
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    assert _rel_err(dv_g, dv_c) <= 1e-4 and _rel_err(dp_g, dp_c) <= 1e-4
