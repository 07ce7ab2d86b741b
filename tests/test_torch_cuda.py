"""dirt_tpu_torch's CUDA kernels on the card (``cuda`` marker).

Every test marked ``cuda`` needs a CUDA device and nvcc; without one it
skips (the one unmarked test checks the streaming scenes on the CPU). This
file imports torch and the port only (no jax), so on the machine with the
card it runs without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: the forward kernel against its plain version on the card,
fid, zbuf and pixels equal bit for bit (the kernel is built with
-fmad=false and IEEE division and keeps the plain version's operation
order, so both round alike), at every tile height (one to eight strips),
depth ties included. The prologue kernel: bits and sval equal bit for
bit (the same sums in the same order), depth ties included; with the
padding taken in (``padded_prologue``), its padded fid, pixels and
gradient too, at sizes off the tile multiple and through strided inputs;
one launch per backward on each engine. The
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

The streaming (CSR) engine: the same checks and tolerances as the dense
engine's (the two forward kernels share their strip walk, the two backward
kernels their passes), at small and odd shapes.

The scatter kernels (the row-sharded renderer's reduction onto faces): rows
within 1e-5 of the column's largest magnitude plus 1e-6 of their plain
versions (float64 ``index_add_``) on the dense and the streaming cases'
bins, cut lists included, and equal on two runs; also on scenes made for
what their enumeration of live list entries can get wrong (boxes placed
directly, so a tile lists exactly 0, 1, 128 or 129 faces; see
``_SCATTER_SCENES``), there also value by value within 1e-5 of the sum of
the magnitudes the value adds up, so one dropped pixel shows. The sharded renderer with
four local slabs on the card against the same on the CPU as above, with
each slab's kernels counted. The packed backward above one launch's column
count (16, 32 and 33 channels) like the packed backward below it.

The layout swap kernel against its plain version (a permutation: equal bit
for bit, float32 and int32 alike), and the packed backward kernel on
flat-subtile fields bit-equal to itself on image-layout fields. The packed
backward at 3, 9 and 16 channels on image and flat-subtile fields also bit
for bit against its plain version run on the CPU (the same sums in the
same order; on the card the plain version's ``index_add_`` flushes
subnormal sums to zero), and the fused dense backward at each of its
compile-time instances and its general form with the dense engine's
tolerance, on lists that reach their cap beside empty tiles.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import dirt_tpu_torch
from _torch_port_scene import needle_soup, screen_soup, sphere_scene
from dirt_tpu_torch import convert, entry
from dirt_tpu_torch.ops import (
    binning,
    fused_bwd,
    packed_bwd,
    raster,
    raster_fwd,
    scatter,
)
from dirt_tpu_torch.parallel.group import LocalGroup
from dirt_tpu_torch.parallel.sharding import rasterise_sharded
from dirt_tpu_torch.ops.triangle_setup import (
    face_bboxes,
    screen_from_clip,
    setup_planes,
)
from dirt_tpu_torch.utils import trace

TOL = dict(rtol=1e-6, atol=1e-6)
TOL_BWD = dict(rtol=1e-5, atol=1e-6)


def _launches(kernel):
    """Host launches of ``csrc/<kernel>.cu`` so far (the registry's
    ``launch.<kernel>``)."""
    return trace.counters().get(f"launch.{kernel}", 0)


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


# The forward's cases: those above and the two tile heights they lack,
# one strip (8) and two (16).
_FORWARD_CASES = _KERNEL_CASES + [
    ("soup", 100, 130, 5, 8),
    ("sphere", 128, 256, 3, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,height,width,channels,tile_h", _FORWARD_CASES)
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
    before = _launches("raster_fwd_packed")
    pix_k, fid_k, z_k = raster_fwd.raster_forward_packed(
        table2, bins, bg_chw, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
        rows=bins.rows)
    torch.cuda.synchronize()
    assert _launches("raster_fwd_packed") == before + 1
    pix_p, fid_p, z_p = raster_fwd.raster_forward_packed_plain(
        bins.rows, bins, bg_chw, tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    assert torch.equal(fid_k, fid_p)
    assert torch.equal(z_k, z_p)
    assert torch.equal(pix_k, pix_p)
    assert (fid_k >= 0).any() and (fid_k < 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("tile_h", [8, 64])
def test_packed_kernel_gives_depth_ties_to_the_lower_id_on_card(cuda,
                                                                tile_h):
    """Every face twice, the copy after the original in id order and with
    other colors: equal depths everywhere, so the original wins each pixel
    of the pair (the strict depth test over ascending iterations), as in
    the plain version."""
    height, width, channels = 100, 130, 3
    fv, fa = screen_soup(60, height, width, seed=4, channels=channels,
                         spread=30.0)
    fv = torch.tensor(np.concatenate([fv, fv])).to(cuda)
    fa = torch.tensor(np.concatenate([fa, 1.0 - fa])).to(cuda)
    bg = torch.zeros(height, width, channels, device=cuda)
    config = raster.suggest_config(
        fv, height, width, raster.RasterConfig(engine="packed", tile_h=tile_h))
    config = config._replace(budget=4 * config.budget)
    table2, bins, bg_chw, cfg = raster.prepare_packed(fv, fa, bg, config)
    assert not bool(bins.overflow)
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    pix_k, fid_k, z_k = raster_fwd.raster_forward_packed(
        table2, bins, bg_chw, rows=bins.rows, **geom)
    pix_p, fid_p, z_p = raster_fwd.raster_forward_packed_plain(
        bins.rows, bins, bg_chw, **geom)
    assert torch.equal(fid_k, fid_p) and torch.equal(z_k, z_p)
    assert torch.equal(pix_k, pix_p)
    covered = fid_k >= 0
    assert covered.any() and bool((fid_k[covered] < 60).all())


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
    before = _launches("packed_prologue")
    bits_k, sval_k = packed_bwd.fused_neighbor_prologue(*args)
    torch.cuda.synchronize()
    assert _launches("packed_prologue") == before + 1
    bits_p, sval_p = packed_bwd.fused_neighbor_prologue_plain(*args)
    assert torch.equal(bits_k, bits_p)
    assert torch.equal(sval_k, sval_p)
    assert (bits_k != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,height,width,channels,tile_h",
                         _KERNEL_CASES[:3])
def test_prologue_kernel_keeps_the_tie_rule_on_card(cuda, kind, height,
                                                    width, channels, tile_h):
    """Depths quantised to 9 values, so many neighbour pairs with other
    faces tie: bits and sval equal to the plain version's bit for bit."""
    prep = _backward_inputs(cuda, kind, height, width, channels, tile_h)
    gen = torch.Generator(device=cuda).manual_seed(height + channels)
    zbuf = torch.round(4.0 * (2.0 * torch.rand(
        prep.fid_p.shape, generator=gen, device=cuda) - 1.0)) / 4.0
    fid = prep.fid_p
    ties = ((fid[:, 1:] != fid[:, :-1]) & (fid[:, 1:] >= 0)
            & (fid[:, :-1] >= 0) & (zbuf[:, 1:] == zbuf[:, :-1]))
    assert ties.any()
    args = (fid, zbuf, prep.pix_cf, prep.grad_cf)
    bits_k, sval_k = packed_bwd.fused_neighbor_prologue(*args)
    torch.cuda.synchronize()
    bits_p, sval_p = packed_bwd.fused_neighbor_prologue_plain(*args)
    assert torch.equal(bits_k, bits_p)
    assert torch.equal(sval_k, sval_p)


# (height, width, channels, tile_h, tile_w, layout): sizes off the tile
# multiple; a tile width that is not a multiple of 4 (the kernel's
# one-pixel stores); the inputs as the backward hands them (pixels a
# permuted, cropped view of a [C, Hp, Wp] array, the gradient [H, W, C]),
# contiguous [H, W, C] pixels, and a float64 gradient.
_PADDED_CASES = [
    (37, 131, 3, 32, 128, "view"),
    (100, 130, 9, 32, 128, "view"),
    (100, 130, 1, 64, 128, "contiguous"),
    (64, 256, 3, 8, 128, "float64"),
    (50, 70, 2, 8, 20, "view"),
    (33, 45, 5, 16, 15, "contiguous"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("height,width,channels,tile_h,tile_w,layout",
                         _PADDED_CASES)
def test_padded_prologue_matches_plain_on_card(cuda, height, width,
                                               channels, tile_h, tile_w,
                                               layout):
    gen = torch.Generator(device=cuda).manual_seed(height * width)
    hp = -(-height // tile_h) * tile_h
    wp = -(-width // tile_w) * tile_w
    fid = torch.randint(-1, 9, (hp, wp), generator=gen, device=cuda,
                        dtype=torch.int32)[:height, :width]
    zbuf = torch.round(4.0 * torch.rand((hp, wp), generator=gen,
                                        device=cuda)) / 4.0
    zbuf = torch.where(fid < 0, 3.0e38, zbuf[:height, :width])
    chw = torch.rand((channels, hp, wp), generator=gen, device=cuda)
    pixels = chw.permute(1, 2, 0)[:height, :width]
    if layout == "contiguous":
        pixels = pixels.contiguous()
    grad = torch.randn((height, width, channels), generator=gen, device=cuda)
    if layout == "float64":
        grad = grad.double()
    args = (fid, zbuf, pixels, grad, tile_h, tile_w)
    before = _launches("packed_prologue")
    got = packed_bwd.padded_prologue(*args)
    torch.cuda.synchronize()
    assert _launches("packed_prologue") == before + 1
    want = packed_bwd.padded_prologue_plain(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)
    assert (got[1] != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["packed", "dense", "csr"])
def test_one_prologue_launch_per_backward_on_card(cuda, engine):
    """Each single-device backward pads its fields in the prologue's one
    launch and gives the gradients of the same backward on the CPU."""
    verts, colors, faces = sphere_scene(24, 32)
    bg = np.random.RandomState(6).rand(100, 130, 3).astype(np.float32)
    weights = np.random.RandomState(7).randn(100, 130, 3).astype(np.float32)
    fields = {"packed": dict(engine="packed"),
              "dense": dict(engine="dense"),
              "csr": dict(streaming=True)}[engine]
    grads = []
    for device, launches in (("cpu", 0), (cuda, 1)):
        scene = convert.scene_from_numpy(bg, verts, colors, faces, device)
        config = dirt_tpu_torch.suggest_raster_config(
            scene[1], scene[3], 100, 130,
            config=dirt_tpu_torch.RasterConfig(**fields), clip=False)
        leaves = [t.clone().requires_grad_() for t in scene[:3]]
        before = _launches("packed_prologue")
        pixels = dirt_tpu_torch.rasterise(leaves[0], leaves[1], leaves[2],
                                          scene[3], config=config,
                                          clip=False)
        (pixels * torch.tensor(weights, device=device)).sum().backward()
        torch.cuda.synchronize()
        assert _launches("packed_prologue") == before + launches
        grads.append([t.grad.cpu() for t in leaves])
    for g_cpu, g_card in zip(*grads):
        scale = float(g_cpu.abs().max())
        assert float((g_card - g_cpu).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("kind,height,width,channels,tile_h", _KERNEL_CASES)
def test_backward_kernel_matches_plain_on_card(cuda, kind, height, width,
                                               channels, tile_h):
    prep = _backward_inputs(cuda, kind, height, width, channels, tile_h)
    before = _launches("packed_bwd")
    rows_k = packed_bwd.packed_entry_rows(prep)
    torch.cuda.synchronize()
    assert _launches("packed_bwd") == before + 1
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
@pytest.mark.parametrize("hp,wp,planes", [(8, 128, (1, 1)),
                                          (104, 256, (1, 1, 5, 5, 4)),
                                          (64, 384, (3,) * 10),
                                          (40, 640, (1, 4, 1, 3, 3, 1, 2, 1,
                                                     5))])
def test_swap_kernel_matches_plain_on_card(cuda, hp, wp, planes):
    """Mixed int32 and float32 arrays in one call (ten arrays take two
    launches); NaN and -0.0 bit patterns move untouched; an array at an
    odd offset of its storage is taken too. A plane count of 1 is a 2-D
    array."""
    gen = torch.Generator(device=cuda).manual_seed(hp + wp)
    arrays = []
    for i, k in enumerate(planes):
        shape = (hp, wp) if k == 1 else (k, hp, wp)
        if i % 2:
            arrays.append(torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                                        device=cuda, dtype=torch.int32))
        else:
            arrays.append(torch.randn(shape, generator=gen, device=cuda))
    arrays[0].view(-1)[:2] = torch.tensor([float("nan"), -0.0], device=cuda)
    # A contiguous view one word into its storage: not 16-byte aligned.
    last = arrays[-1]
    odd = torch.empty(last.numel() + 1, dtype=last.dtype, device=cuda)[1:]
    arrays[-1] = odd.view(last.shape).copy_(last)
    assert arrays[-1].is_contiguous() and arrays[-1].data_ptr() % 16
    before = _launches("subtile_swap")
    got = raster_fwd.flat_subtile_swap(arrays)
    torch.cuda.synchronize()
    assert _launches("subtile_swap") == before + -(-len(planes) // 8)
    for a, g in zip(arrays, got):
        want = raster_fwd.flat_subtile_swap_plain(a)
        assert g.dtype == a.dtype and g.shape == a.shape
        assert g.is_contiguous()
        assert torch.equal(g.view(torch.int32), want.view(torch.int32))
    for a, b in zip(arrays, raster_fwd.flat_subtile_swap(got)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,height,width,channels,tile_h",
                         _KERNEL_CASES + [("soup", 100, 130, 16, 32)])
def test_backward_kernel_on_flat_fields_equals_image_fields(
        cuda, kind, height, width, channels, tile_h):
    """The halo path's layout: the same prepared inputs with the five
    per-pixel fields swapped give the same entry rows, bit for bit."""
    prep = _backward_inputs(cuda, kind, height, width, channels, tile_h)
    fid_f, bits_f, sval_f, pix_f, grad_f = raster_fwd.flat_subtile_swap(
        [prep.fid_p, prep.bits, prep.sval, prep.pix_cf, prep.grad_cf])
    flat = packed_bwd._PackedBwdPrep(
        fid_f, bits_f, sval_f, pix_f, grad_f, prep.bins, prep.geo, prep.att,
        prep.channels, prep.k_cols, prep.tile_h, prep.tile_w, flat=True)
    rows = packed_bwd.packed_entry_rows(prep)
    assert torch.equal(packed_bwd.packed_entry_rows(flat), rows)
    torch.testing.assert_close(
        packed_bwd.packed_entry_rows_plain(flat, prep.bins.rows, 0,
                                           prep.budget_chunks),
        rows, **TOL_BWD)
    assert (rows != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [16, 32, 33])
def test_backward_kernel_takes_channels_beyond_one_pass(cuda, channels):
    """More cotangent columns than one launch stages (54 on an H100, which
    is 14 channels) run as further launches over the same owners: 16
    channels are 60 columns (two passes), 32 are 108 (two full ones), 33 are
    111 (three)."""
    assert 12 + 3 * channels > packed_bwd.columns_per_pass(cuda)
    prep = _backward_inputs(cuda, "soup", 100, 130, channels, 32)
    before = _launches("packed_bwd")
    rows_k = packed_bwd.packed_entry_rows(prep)
    torch.cuda.synchronize()
    assert _launches("packed_bwd") == before + 1
    rows_p = packed_bwd.packed_entry_rows_plain(
        prep, prep.bins.rows, 0, prep.budget_chunks)
    torch.testing.assert_close(rows_k, rows_p, **TOL_BWD)
    assert (rows_k != 0).any(dim=0).all()           # every column is written
    assert torch.equal(rows_k, packed_bwd.packed_entry_rows(prep))
    mid = prep.budget_chunks // 2
    halves = torch.cat([packed_bwd.packed_entry_rows(prep, 0, mid),
                        packed_bwd.packed_entry_rows(prep, mid)])
    assert torch.equal(halves, rows_k)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [3, 9, 16])
@pytest.mark.parametrize("layout", ["image", "flat"])
def test_backward_kernel_bits_equal_plain_on_card(cuda, channels, layout):
    """The packed backward sums each budget row's own pixels in the
    subtile's row-major order, as its plain version does: the rows are
    equal bit for bit to the plain version's run on the CPU (on the card
    the plain version's ``index_add_`` sums with atomicAdd, which flushes
    subnormal sums to zero), 16 channels in two launches, on image and on
    flat-subtile fields; equal on a second run; and two chunk slices
    [0, k) and [k, n) give the whole range's rows."""
    prep = _backward_inputs(cuda, "sphere", 192, 256, channels, 64)
    if layout == "flat":
        prep = packed_bwd._PackedBwdPrep(
            *raster_fwd.flat_subtile_swap(
                [prep.fid_p, prep.bits, prep.sval, prep.pix_cf,
                 prep.grad_cf]),
            prep.bins, prep.geo, prep.att, prep.channels, prep.k_cols,
            prep.tile_h, prep.tile_w, flat=True)
    rows_k = packed_bwd.packed_entry_rows(prep)
    on_cpu = packed_bwd._PackedBwdPrep(
        *(t.cpu() for t in (prep.fid_p, prep.bits, prep.sval, prep.pix_cf,
                            prep.grad_cf)),
        type(prep.bins)(*(None if v is None else v.cpu() for v in prep.bins)),
        prep.geo.cpu(), prep.att.cpu(), prep.channels, prep.k_cols,
        prep.tile_h, prep.tile_w, flat=prep.flat)
    rows_p = packed_bwd.packed_entry_rows_plain(
        on_cpu, on_cpu.bins.rows, 0, prep.budget_chunks)
    assert torch.equal(rows_k.cpu(), rows_p)
    assert int((rows_k != 0).any(1).sum()) > 100
    assert torch.equal(rows_k, packed_bwd.packed_entry_rows(prep))
    for k in (1, prep.budget_chunks // 3, prep.budget_chunks - 1):
        halves = torch.cat([packed_bwd.packed_entry_rows(prep, 0, k),
                            packed_bwd.packed_entry_rows(prep, k)])
        assert torch.equal(halves, rows_k)


@pytest.mark.cuda
def test_packed_gradients_with_16_channels_on_card_match_cpu(cuda):
    verts, colors, faces = sphere_scene(24, 32, channels=16)
    bg = np.random.RandomState(6).rand(192, 256, 16).astype(np.float32)
    w = np.random.RandomState(7).randn(192, 256, 16).astype(np.float32)
    grads = []
    for device in ("cpu", cuda):
        bg_t, v_t, c_t, f_t = convert.scene_from_numpy(bg, verts, colors,
                                                       faces, device)
        config = dirt_tpu_torch.suggest_raster_config(
            v_t, f_t, 192, 256,
            config=dirt_tpu_torch.RasterConfig(engine="packed"))
        leaves = [t.clone().requires_grad_() for t in (v_t, c_t, bg_t)]
        pix, _, _, ovf = dirt_tpu_torch.rasterise_with_aux(
            leaves[2], leaves[0], leaves[1], f_t, config=config)
        assert not bool(ovf)
        (pix * torch.tensor(w, device=device)).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    for g_cpu, g_card in zip(*grads):
        assert torch.isfinite(g_card).all()
        assert _rel_err(g_card, g_cpu) <= 1e-4


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
    before = _launches("raster_fwd_dense")
    pix_k, fid_k, z_k, boxes = raster_fwd.raster_forward(
        table, bins.bins, bins.counts, bg_chw, **geom)
    torch.cuda.synchronize()
    assert _launches("raster_fwd_dense") == before + 1
    pix_p, fid_p, z_p = raster_fwd.raster_forward_plain(
        table, bins.bins, bins.counts, bg_chw, **geom)
    assert torch.equal(fid_k, fid_p)
    assert torch.equal(z_k, z_p)
    torch.testing.assert_close(pix_k, pix_p, **TOL)
    # The boxes it culled by, which it hands the backward.
    assert torch.equal(boxes, raster_fwd.csr_cull_boxes_plain(
        table, *bg_chw.shape[1:]))
    assert (fid_k >= 0).any() and (fid_k < 0).any()
    # Slots past a tile's count are never read.
    slot = torch.arange(bins.bins.shape[1], device=cuda)[None, :]
    dirty = torch.where(slot < bins.counts[:, None], bins.bins,
                        torch.full_like(bins.bins, 1 << 30))
    again = raster_fwd.raster_forward(table, dirty, bins.counts, bg_chw,
                                      **geom)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b)
               for a, b in zip(again, (pix_k, fid_k, z_k, boxes)))


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
    boxes = dict(bbox=bins.bbox,
                 cull=raster_fwd.csr_cull_boxes(table, hp, wp))
    before = _launches("fused_bwd")
    rows_k = fused_bwd.fused_backward_rows(*args, **boxes, **geom)
    torch.cuda.synchronize()
    assert _launches("fused_bwd") == before + 1
    rows_p = fused_bwd.fused_backward_rows_plain(
        geo, fid, bits, sval, pix_cf, grad_cf, num_faces + 1)
    assert rows_k.shape == rows_p.shape
    scale = rows_p.abs().amax(dim=0, keepdim=True)
    assert ((rows_k - rows_p).abs() <= 1e-5 * scale + 1e-6).all()
    assert (rows_k != 0).any() and not rows_k[num_faces:].any()
    # Deterministic: a second run is equal. Without the boxes it raises.
    assert torch.equal(rows_k, fused_bwd.fused_backward_rows(
        *args, **boxes, **geom))
    with pytest.raises(ValueError, match="bbox"):
        fused_bwd.fused_backward_rows(*args, **geom)
    with pytest.raises(ValueError, match="cull"):
        fused_bwd.fused_backward_rows(*args, bbox=bins.bbox, **geom)


# (scene, channels, height, width): the fused dense backward's
# compile-time instances, at C = 3 on a mesh of small faces (2,400 faces of
# a few pixels over the left half of 128 x 512) and on one of larger faces
# (the 1,472-face sphere at 512 x 512) and at C = 9, and its general form
# at C = 5.
_FUSED_INSTANCES = [("soup", 3, 128, 512), ("sphere", 3, 512, 512),
                    ("sphere", 9, 512, 512), ("sphere", 5, 256, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,channels,height,width", _FUSED_INSTANCES)
def test_fused_bwd_kernel_instances_on_card(cuda, kind, channels, height,
                                            width):
    """A scene binned with its cap at the fullest tile's count (so one
    list reaches the cap exactly) over an image with empty tiles: the
    fused dense backward's rows within the row tolerance of the plain
    version's, equal on a second run, and zero for the sentinel and
    padding rows."""
    if kind == "soup":
        faces = screen_soup(2400, height, width // 2, seed=13,
                            channels=channels, spread=6.0)
    else:
        faces = _faces(kind, height, width, channels)
    fv, fa = (torch.tensor(a, device=cuda) for a in faces)
    bg = torch.zeros(height, width, channels, device=cuda)
    config = raster.RasterConfig(engine="dense", tile_h=32, tile_w=128,
                                 bin_cap=fv.shape[0])
    _, bins, _, _ = raster.prepare_dense(fv, fa, bg, config)
    cap = int(bins.counts.max())
    table, bins, bg_chw, cfg = raster.prepare_dense(
        fv, fa, bg, config._replace(bin_cap=cap))
    assert not bool(bins.overflow.any())
    assert bins.bins.shape[1] == cap and int(bins.counts.max()) == cap
    assert bool((bins.counts == 0).any())
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    pix_cf, fid, zbuf = raster_fwd.raster_forward_plain(
        table, bins.bins, bins.counts, bg_chw, **geom)
    grad_cf = torch.randn_like(pix_cf)
    bits, sval = packed_bwd.fused_neighbor_prologue_plain(fid, zbuf, pix_cf,
                                                          grad_cf)
    geo = setup_planes(fv, fa)[0].contiguous()
    num_faces = fv.shape[0]
    args = (geo, bins.bins, bins.counts, fid, bits, sval, pix_cf, grad_cf,
            num_faces + 1)
    boxes = dict(bbox=bins.bbox,
                 cull=raster_fwd.csr_cull_boxes(table, *fid.shape))
    before = _launches("fused_bwd")
    rows_k = fused_bwd.fused_backward_rows(*args, **boxes, **geom)
    torch.cuda.synchronize()
    assert _launches("fused_bwd") == before + 1
    rows_p = fused_bwd.fused_backward_rows_plain(
        geo, fid, bits, sval, pix_cf, grad_cf, num_faces + 1)
    assert rows_k.shape == rows_p.shape
    scale = rows_p.abs().amax(dim=0, keepdim=True)
    assert ((rows_k - rows_p).abs() <= 1e-5 * scale + 1e-6).all()
    assert int((rows_k != 0).any(1).sum()) > num_faces // 4
    assert not rows_k[num_faces:].any()
    assert torch.equal(rows_k, fused_bwd.fused_backward_rows(
        *args, **boxes, **geom))


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


# --- the streaming (CSR) engine -----------------------------------------------

# name: (faces, height, width, channels, tile_h, tile_w, bin_cap, expand_cap,
# largest run, overflow). One tile; a run of exactly 128 entries (one full
# chunk) and of 129 (one entry into the second chunk); a tile whose run the
# cap cuts; nine channels on an image that is no multiple of the tile; small
# tiles; tiles 40 wide (the culled walk's warps straddle two rows) and 10
# wide (80 pixels a strip: its block rounds up to three warps, the last
# with idle lanes).
_CSR_CASES = {
    "one-tile": (60, 32, 128, 1, 32, 128, None, None, 60, False),
    "run-128": (128, 32, 128, 3, 32, 128, None, None, 128, False),
    "run-129": (129, 32, 128, 3, 32, 128, None, None, 129, False),
    "cap-cut": (300, 32, 128, 2, 32, 128, 128, None, 128, True),
    "ragged-c9": (150, 100, 130, 9, 32, 128, None, None, None, False),
    "small-tiles": (150, 64, 80, 2, 8, 32, None, 64, None, False),
    "40-wide-tiles": (150, 37, 131, 3, 16, 40, None, None, None, False),
    "10-wide-tiles": (80, 37, 131, 2, 8, 10, None, 64, None, False),
    "ragged-c16": (150, 100, 130, 16, 32, 128, None, None, None, False),
}


def _csr_forward(device, case):
    """(fv, fa, table, StreamBins, bg_chw, cfg, height, width) of one
    _CSR_CASES scene on ``device``."""
    (num_faces, height, width, channels, tile_h, tile_w, bin_cap, expand,
     largest, overflow) = _CSR_CASES[case]
    fv, fa = screen_soup(2 * num_faces, height, width, seed=9,
                         channels=channels, spread=30.0)
    # The first ``num_faces`` faces that binning lists (setup drops
    # back-facing ones), so a one-tile scene's run has that length.
    fv_t, fa_t = torch.tensor(fv), torch.tensor(fa)
    box = face_bboxes(fv_t, setup_planes(fv_t, fa_t)[2], height, width)
    live = torch.nonzero((box[:, 1] >= box[:, 0]) & (box[:, 3] >= box[:, 2]))
    keep = live[:num_faces, 0]
    assert keep.shape[0] == num_faces
    fv = fv_t[keep].to(device)
    fa = fa_t[keep].to(device)
    bg = torch.rand(height, width, channels, device=device)
    config = raster.RasterConfig(streaming=True, tile_h=tile_h, tile_w=tile_w,
                                 bin_cap=bin_cap, expand_cap=expand)
    table, bins, bg_chw, cfg = raster.prepare_csr(fv, fa, bg, config)
    assert bool(bins.overflow) is overflow
    if largest is not None:
        assert int(bins.counts.max()) == largest
    return fv, fa, table, bins, bg_chw, cfg, height, width


@pytest.mark.parametrize("case", list(_CSR_CASES))
def test_csr_cases_have_the_runs_they_name(case):
    """The scenes above on the CPU: the runs have the lengths the card
    tests rely on (this one needs no card)."""
    _csr_forward("cpu", case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_CSR_CASES))
def test_csr_kernel_matches_plain_on_card(cuda, case):
    """The culled walk against the plain (un-culled) one: fid and zbuf
    equal on the whole padded arrays, padding included."""
    _, _, table, bins, bg_chw, cfg, _, _ = _csr_forward(cuda, case)
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    args = (bins.start_block, bins.counts, bg_chw)
    before = _launches("raster_fwd_csr")
    pix_k, fid_k, z_k, boxes = raster_fwd.raster_forward_csr(
        table, bins.entry_face, *args, **geom)
    torch.cuda.synchronize()
    assert _launches("raster_fwd_csr") == before + 1
    assert torch.equal(boxes, raster_fwd.csr_cull_boxes_plain(
        table, *bg_chw.shape[1:]))
    pix_p, fid_p, z_p = raster_fwd.raster_forward_csr_plain(
        table, bins.entry_face, *args, **geom)
    assert torch.equal(fid_k, fid_p)
    assert torch.equal(z_k, z_p)
    torch.testing.assert_close(pix_k, pix_p, **TOL)
    assert (fid_k >= 0).any()
    # Slots past a run's count are never read.
    sentinel = int(bins.entry_face.max())           # F, on padding slots
    dirty = torch.where(bins.entry_face == sentinel,
                        torch.full_like(bins.entry_face, 1 << 30),
                        bins.entry_face)
    again = raster_fwd.raster_forward_csr(table, dirty, *args, **geom)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b)
               for a, b in zip(again, (pix_k, fid_k, z_k, boxes)))


@pytest.mark.cuda
def test_csr_kernel_gives_depth_ties_to_the_lower_id_on_card(cuda):
    """Every face twice, the copy after the original in id order and with
    other colors: equal depths everywhere, so the original wins each pixel
    of the pair, through the cull as through the plain walk."""
    height, width, channels = 100, 130, 3
    fv, fa = screen_soup(60, height, width, seed=4, channels=channels,
                         spread=30.0)
    fv = torch.tensor(np.concatenate([fv, fv])).to(cuda)
    fa = torch.tensor(np.concatenate([fa, 1.0 - fa])).to(cuda)
    bg = torch.zeros(height, width, channels, device=cuda)
    config = raster.RasterConfig(streaming=True, tile_h=32, tile_w=128)
    table, bins, bg_chw, cfg = raster.prepare_csr(fv, fa, bg, config)
    assert not bool(bins.overflow)
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    args = (table, bins.entry_face, bins.start_block, bins.counts, bg_chw)
    pix_k, fid_k, z_k, _ = raster_fwd.raster_forward_csr(*args, **geom)
    pix_p, fid_p, z_p = raster_fwd.raster_forward_csr_plain(*args, **geom)
    assert torch.equal(fid_k, fid_p) and torch.equal(z_k, z_p)
    torch.testing.assert_close(pix_k, pix_p, **TOL)
    covered = fid_k >= 0
    assert covered.any() and bool((fid_k[covered] < 60).all())


def _needle_forward(device, seed):
    """A CSR scene of needle-thin faces whose far corners lie 1e3 to 1e6
    pixels off the 128 x 256 image: float32 rounding lets them pass the
    edge tests well past the boxes of their corners."""
    fv, fa = needle_soup(200, 128, 256, seed, (3.0, 6.0), (-6.0, 0.0))
    bg = torch.rand(128, 256, 3, device=device)
    config = raster.RasterConfig(streaming=True, tile_h=32, tile_w=128,
                                 bin_cap=2048, expand_cap=64)
    table, bins, bg_chw, cfg = raster.prepare_csr(
        torch.tensor(fv).to(device), torch.tensor(fa).to(device), bg, config)
    assert not bool(bins.overflow)
    return table, bins, bg_chw, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_csr_kernel_matches_plain_on_far_needles_on_card(cuda, seed):
    table, bins, bg_chw, cfg = _needle_forward(cuda, seed)
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    args = (table, bins.entry_face, bins.start_block, bins.counts, bg_chw)
    pix_k, fid_k, z_k, _ = raster_fwd.raster_forward_csr(*args, **geom)
    pix_p, fid_p, z_p = raster_fwd.raster_forward_csr_plain(*args, **geom)
    assert torch.equal(fid_k, fid_p) and torch.equal(z_k, z_p)
    torch.testing.assert_close(pix_k, pix_p, **TOL)
    assert (fid_k >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_CSR_CASES) + ["far-needles"])
def test_csr_cull_boxes_match_plain_on_card(cuda, case):
    """The kernel's cull boxes equal csr_cull_boxes_plain bit for bit
    (float64, -fmad=false), rows with NaN, parallel edges and no area
    among them."""
    if case == "far-needles":
        table = _needle_forward(cuda, 0)[0]
    else:
        table = _csr_forward(cuda, case)[2]
    hp, wp = 160, 384
    special = table[:3].clone()
    special[0, 5] = float("nan")
    special[1, [2, 3, 5, 6, 8, 9]] = torch.tensor(
        [1.0, 0.0, 1.0, 0.0, -1.0, 0.0], device=cuda)
    special[2, [2, 3, 4]] = torch.tensor([0.0, 0.0, -1.0], device=cuda)
    table = torch.cat([table, special])
    got = raster_fwd.csr_cull_boxes(table, hp, wp)
    torch.cuda.synchronize()
    assert torch.equal(got, raster_fwd.csr_cull_boxes_plain(table, hp, wp))
    assert got[-3:].tolist() == [[0, wp - 1, 0, hp - 1],
                                 [0, wp - 1, 0, hp - 1], [0, -1, 0, -1]]


# --- far needles: the boxes the backward kernels scan ---------------------------

# The far-needle scenes of _needle_forward through either engine.
_NEEDLE_ENGINES = {"dense": dict(engine="dense", streaming=False),
                   "csr": dict(streaming=True)}


def _needle_scene(device, seed, engine):
    """(face_verts, face_attrs, background, upstream gradient, config) of
    _needle_forward's faces."""
    fv, fa = needle_soup(200, 128, 256, seed, (3.0, 6.0), (-6.0, 0.0))
    rng = np.random.RandomState(seed)
    bg, w = (torch.tensor(a.astype(np.float32), device=device)
             for a in (rng.rand(128, 256, 3), rng.randn(128, 256, 3)))
    config = raster.RasterConfig(tile_h=32, tile_w=128, bin_cap=2048,
                                 expand_cap=64, **_NEEDLE_ENGINES[engine])
    return (torch.tensor(fv).to(device), torch.tensor(fa).to(device), bg, w,
            config)


def _calls(module, name, run):
    """[(args, kwargs)] of every call of ``module.name`` during ``run()``."""
    seen = []
    inner = getattr(module, name)

    def record(*args, **kwargs):
        seen.append((args, kwargs))
        return inner(*args, **kwargs)

    with mock.patch.object(module, name, record):
        run()
    return seen


def _past_binning_boxes(fid, bbox):
    """Covered pixels outside their owner's binning box grown by one."""
    ys, xs = torch.nonzero(fid >= 0, as_tuple=True)
    box = bbox.long()[fid[ys, xs].long()]
    return int(((xs < box[:, 0] - 1) | (xs > box[:, 1] + 1)
                | (ys < box[:, 2] - 1) | (ys > box[:, 3] + 1)).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_dense_kernel_matches_plain_on_far_needles_on_card(cuda, seed):
    """The culled dense walk, as the streaming one above: fid and zbuf
    equal to the un-culled plain walk on the padded arrays, and its boxes
    equal to the plain ones."""
    fv, fa, bg, _, config = _needle_scene(cuda, seed, "dense")
    table, bins, bg_chw, cfg = raster.prepare_dense(fv, fa, bg, config)
    assert not bool(bins.overflow.any())
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    args = (table, bins.bins, bins.counts, bg_chw)
    pix_k, fid_k, z_k, boxes = raster_fwd.raster_forward(*args, **geom)
    pix_p, fid_p, z_p = raster_fwd.raster_forward_plain(*args, **geom)
    assert torch.equal(fid_k, fid_p) and torch.equal(z_k, z_p)
    torch.testing.assert_close(pix_k, pix_p, **TOL)
    assert torch.equal(boxes, raster_fwd.csr_cull_boxes_plain(
        table, *bg_chw.shape[1:]))
    assert _past_binning_boxes(fid_k[:128, :256], bins.bbox) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("engine", list(_NEEDLE_ENGINES))
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_fused_bwd_kernels_match_plain_on_far_needles_on_card(cuda, seed,
                                                              engine):
    """fused_bwd (dense) and fused_bwd_csr on what the op's own backward
    hands them on far needles, whose pixels past their binning boxes the
    kernels once dropped: rows within the row tolerance and, value by
    value, within 1e-5 of the sum of the magnitudes the value adds up, so
    one dropped pixel shows; equal on a second run."""
    fv, fa, bg, w, config = _needle_scene(cuda, seed, engine)
    name = {"dense": "fused_backward_rows",
            "csr": "fused_backward_rows_csr"}[engine]
    out = []

    def step():
        verts = fv.clone().requires_grad_()
        out.extend(raster.rasterize_screen(verts, fa, bg, config))
        (out[0] * w).sum().backward()

    ((args, kwargs),) = _calls(fused_bwd, name, step)
    assert not bool(out[3])
    assert _past_binning_boxes(out[1], kwargs["bbox"]) > 0
    geo, *_, fid, bits, sval, pix_cf, grad_cf, n_rows = args
    kernel = getattr(fused_bwd, name)
    rows_k = kernel(*args, **kwargs)
    torch.cuda.synchronize()
    plain_rows = n_rows + 1 if engine == "csr" else n_rows
    rows_p = fused_bwd.fused_backward_rows_plain(
        geo, fid, bits, sval, pix_cf, grad_cf, plain_rows)[:rows_k.shape[0]]
    terms = fused_bwd.pixel_rows_plain(geo, fid, bits, sval, pix_cf, grad_cf)
    mass = torch.zeros(rows_p.shape, dtype=torch.float64, device=cuda)
    owned = fid.reshape(-1) >= 0
    mass.index_add_(0, fid.reshape(-1)[owned].long(),
                    terms[owned].abs().double())
    _check_scatter_rows(rows_k, rows_p, lambda: kernel(*args, **kwargs),
                        mass.float())


def _needle_clip(fv):
    """Clip-space vertices (w = 1, three a face) [3F, 4] of screen-space
    faces [F, 3, 4] on a 128 x 256 image, and the faces [F, 3]."""
    xs, ys = fv[..., 0].double(), fv[..., 1].double()
    verts = torch.stack([2.0 * xs / 256 - 1.0, 1.0 - 2.0 * ys / 128,
                         fv[..., 2].double(), torch.ones_like(xs)], -1)
    faces = torch.arange(3 * fv.shape[0], device=fv.device).reshape(-1, 3)
    return verts.float().reshape(-1, 4), faces


@pytest.mark.cuda
@pytest.mark.parametrize("engine", list(_NEEDLE_ENGINES))
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_scatter_kernels_match_plain_on_far_needles_on_card(cuda, seed,
                                                            engine):
    """scatter_faces (dense) and scatter_faces_csr on what each of two
    slabs of the row-sharded renderer hands them on far needles: rows as
    in test_scatter_kernel_matches_plain_on_card, value by value too."""
    fv, fa, bg, w, config = _needle_scene(cuda, seed, engine)
    verts, faces = _needle_clip(fv)
    colors = fa.reshape(-1, 3)
    name = {"dense": "scatter_to_faces",
            "csr": "scatter_to_faces_csr"}[engine]

    def step():
        leaves = [verts.clone().requires_grad_(),
                  colors.clone().requires_grad_()]
        pixels, _, _, overflow = rasterise_sharded(
            bg, leaves[0], leaves[1], faces, LocalGroup(2), config=config,
            with_aux=True)
        assert not bool(overflow)
        (pixels * w).sum().backward()

    calls = _calls(scatter, name, step)
    assert len(calls) == 2
    kernel = getattr(scatter, name)
    plain = getattr(scatter, name + "_plain")
    for args, kwargs in calls:
        cot, fid_p, *_, n_out = args
        rows_k = kernel(*args, **kwargs)
        torch.cuda.synchronize()
        _check_scatter_rows(rows_k, plain(cot, fid_p, n_out),
                            lambda: kernel(*args, **kwargs),
                            plain(cot.abs(), fid_p, n_out))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_CSR_CASES))
def test_fused_bwd_csr_kernel_matches_plain_on_card(cuda, case):
    fv, fa, table, bins, bg_chw, cfg, height, width = _csr_forward(cuda, case)
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    pix_cf, fid, zbuf = raster_fwd.raster_forward_csr_plain(
        table, bins.entry_face, bins.start_block, bins.counts, bg_chw, **geom)
    hp, wp = fid.shape
    # Padding as backward_fused_csr makes it: fid -2, depth BIG_Z, values 0.
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
    args = (geo.contiguous(), bins.entry_face, bins.start_block, bins.counts,
            fid, bits, sval, pix_cf, grad_cf, num_faces)
    boxes = dict(bbox=bins.bbox,
                 cull=raster_fwd.csr_cull_boxes(table, hp, wp))
    before = _launches("fused_bwd_csr")
    rows_k = fused_bwd.fused_backward_rows_csr(*args, **boxes, **geom)
    torch.cuda.synchronize()
    assert _launches("fused_bwd_csr") == before + 1
    rows_p = fused_bwd.fused_backward_rows_csr_plain(
        geo, fid, bits, sval, pix_cf, grad_cf, num_faces)
    assert rows_k.shape == rows_p.shape == (num_faces,
                                            12 + 3 * pix_cf.shape[0])
    scale = rows_p.abs().amax(dim=0, keepdim=True)
    assert ((rows_k - rows_p).abs() <= 1e-5 * scale + 1e-6).all()
    assert (rows_k != 0).any()
    # Deterministic: a second run is equal. Without the boxes it raises.
    assert torch.equal(rows_k, fused_bwd.fused_backward_rows_csr(
        *args, **boxes, **geom))
    with pytest.raises(ValueError, match="bbox"):
        fused_bwd.fused_backward_rows_csr(*args, **geom)
    with pytest.raises(ValueError, match="cull"):
        fused_bwd.fused_backward_rows_csr(*args, bbox=bins.bbox, **geom)


@pytest.mark.cuda
@pytest.mark.parametrize("distance,clip,fields", [
    (3.0, False, dict(streaming=True)),
    (3.0, True, dict(engine="csr", tile_h=16, bin_cap=300)),
    (0.9, True, dict(engine="dense", streaming=True)),
])
def test_streaming_gradients_on_card_match_cpu(cuda, distance, clip, fields):
    verts, colors, faces = sphere_scene(24, 32, distance=distance,
                                        channels=9)
    bg = np.random.RandomState(6).rand(192, 256, 9).astype(np.float32)
    w = np.random.RandomState(7).randn(192, 256, 9).astype(np.float32)
    config = dirt_tpu_torch.RasterConfig(**fields)
    outs, grads = [], []
    for device in ("cpu", cuda):
        bg_t, v_t, c_t, f_t = convert.scene_from_numpy(bg, verts, colors,
                                                       faces, device)
        leaves = [t.clone().requires_grad_() for t in (v_t, c_t, bg_t)]
        before = (_launches("raster_fwd_csr"), _launches("fused_bwd_csr"))
        pix, fid, zbuf, ovf = dirt_tpu_torch.rasterise_with_aux(
            leaves[2], leaves[0], leaves[1], f_t, config=config, clip=clip)
        (pix * torch.tensor(w, device=device)).sum().backward()
        launched = (_launches("raster_fwd_csr") - before[0],
                    _launches("fused_bwd_csr") - before[1])
        assert launched == ((0, 0) if device == "cpu" else (1, 1))
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


# --- the scatter kernels and the row-sharded renderer ---------------------------


def _scatter_inputs(fid, channels, height, width):
    """(cot [K, Hp, Wp], fid_p): random rows on the pixels a face owns,
    minus a band of rows as an ``own_mask`` takes them out, zero and -1
    elsewhere (``raster_bwd.pack_cotangent_tiles``' contract)."""
    hp, wp = fid.shape
    owned = fid >= 0
    owned[height:] = False
    owned[:, width:] = False
    owned[height // 3: height // 3 + 5] = False
    k_cols = 12 + 3 * channels
    cot = torch.randn(k_cols, hp, wp, device=fid.device) * owned
    return cot.contiguous(), torch.where(owned, fid, -1).contiguous()


def _check_scatter_rows(rows_k, rows_p, launch_again, mass=None):
    assert rows_k.shape == rows_p.shape
    scale = rows_p.abs().amax(dim=0, keepdim=True)
    assert ((rows_k - rows_p).abs() <= 1e-5 * scale + 1e-6).all()
    if mass is not None:
        # Value by value against the sum of its terms' magnitudes: one
        # dropped or doubled pixel of any face shows.
        assert ((rows_k - rows_p).abs() <= 1e-5 * mass + 1e-9).all()
    assert (rows_k != 0).any()
    assert torch.equal(rows_k, launch_again())      # deterministic


def _boxes_in(rng, n, x0, x1, y0, y1, size=7):
    """``n`` random boxes (xmin, xmax, ymin, ymax) of up to ``size`` pixels a
    side inside the inclusive region."""
    w = rng.randint(1, size + 1, n)
    h = rng.randint(1, size + 1, n)
    xmin = x0 + (rng.rand(n) * (x1 - x0 + 2 - w)).astype(np.int64)
    ymin = y0 + (rng.rand(n) * (y1 - y0 + 2 - h)).astype(np.int64)
    return np.stack([xmin, xmin + w - 1, ymin, ymin + h - 1], axis=1)


def _scene_counts(rng):
    """Four 32 x 128 tiles listing 0, 1, 128 and 129 faces."""
    return np.concatenate([
        _boxes_in(rng, n, 128 * t, 128 * t + 127, 0, 31)
        for t, n in ((1, 1), (2, 128), (3, 129))])


def _scene_spans(rng):
    """2 x 2 tiles of 32 x 128: face 0's box is the whole of tile 1, face
    1's spans all four tiles, 40 small ones lie anywhere (some across a
    tile edge)."""
    return np.concatenate([
        np.array([[128, 255, 0, 31], [100, 160, 20, 40]]),
        _boxes_in(rng, 40, 0, 255, 0, 63, size=12)])


# name: (height, width, tile_h, tile_w, cap, expand_cap, cot channels, boxes,
# faces the caps cut). What the kernels' enumeration of live entries can get
# wrong: tiles listing 0, 1, 128 and 129 faces (an empty tile, one entry, a
# full chunk, one entry into the second chunk); CSR arrays whose last blocks
# are all padding; a face whose box is a whole tile and one across four
# tiles; lists cut by a cap; 12, 21, 39 and 60 columns (one batch, a ragged
# last batch, several batches); an image of one tile.
_SCATTER_SCENES = {
    "counts-0-1-128-129": (32, 512, 32, 128, 160, 4, 3, _scene_counts, False),
    "padding-blocks": (32, 256, 32, 128, 128, 16, 3,
                       lambda rng: _boxes_in(rng, 10, 0, 255, 0, 31), False),
    "whole-tile-four-tiles": (64, 256, 32, 128, 64, 4, 9, _scene_spans,
                              False),
    "soup-over-cap": (32, 128, 32, 128, 128, 1, 16,
                      lambda rng: _boxes_in(rng, 300, 0, 127, 0, 31), True),
    "one-tile-k12": (32, 128, 32, 128, 64, 1, 0,
                     lambda rng: _boxes_in(rng, 60, 0, 127, 0, 31), False),
}


def _scatter_scene(device, name, streaming):
    """(cot, fid, lists, bbox, num_faces, geom) of one _SCATTER_SCENES case:
    boxes made directly, binned by the package's own binning, and owners
    painted inside the boxes (a random 60% of each box, later faces over
    earlier ones), minus the pixels of faces their tile's list lacks, as the
    forward, which draws listed faces only, leaves them."""
    (height, width, tile_h, tile_w, cap, expand, channels, make_boxes,
     cut) = _SCATTER_SCENES[name]
    rng = np.random.RandomState(11)
    boxes = make_boxes(rng)
    num_faces = boxes.shape[0]
    owner = np.full((height, width), -1, np.int64)
    for face, (x0, x1, y0, y1) in enumerate(boxes):
        region = owner[y0:y1 + 1, x0:x1 + 1]
        region[rng.rand(*region.shape) < 0.6] = face
    bbox = torch.tensor(boxes, dtype=torch.int32, device=device)
    tiles_x = width // tile_w
    total = (height // tile_h) * tiles_x
    listed = torch.zeros((total, num_faces + 1), dtype=torch.bool,
                         device=device)
    if streaming:
        bins = binning.bin_faces_csr(bbox, height, width, tile_h, tile_w,
                                     cap, expand)
        assert bool(bins.overflow) is cut
        lists = (bins.entry_face, bins.start_block, bins.counts)
        for t in range(total):
            row0 = int(bins.start_block[t]) * binning.CHUNK
            run = bins.entry_face[row0:row0 + int(bins.counts[t])]
            listed[t, run.long()] = True
        used = int(bins.start_block[-1]) + -(-int(bins.counts[-1])
                                             // binning.CHUNK)
        assert bins.entry_face.shape[0] // binning.CHUNK > used
    else:
        cap = min(cap, num_faces)               # bin_faces takes no more
        bins = binning.bin_faces(bbox, height, width, tile_h, tile_w, cap)
        assert bool(bins.overflow.any()) is cut
        lists = (bins.bins, bins.counts)
        slot = torch.arange(cap, device=device)[None, :]
        ids = torch.where(slot < bins.counts[:, None], bins.bins.long(),
                          num_faces)
        listed.scatter_(1, ids, True)
    owner = torch.tensor(owner, device=device)
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    tile = (ys // tile_h) * tiles_x + xs // tile_w
    keep = (owner >= 0) & listed[tile, owner.clamp(min=0)]
    fid = torch.where(keep, owner, -1).to(torch.int32).contiguous()
    cot = (torch.randn(12 + 3 * channels, height, width, device=device)
           * keep).contiguous()
    return (cot, fid, lists, bbox, num_faces,
            dict(tile_h=tile_h, tile_w=tile_w))


@pytest.mark.parametrize("streaming", [False, True], ids=["dense", "csr"])
@pytest.mark.parametrize("name", list(_SCATTER_SCENES))
def test_scatter_scenes_have_the_lists_they_name(name, streaming):
    """The scenes above on the CPU (this one needs no card): the lists have
    the lengths the card tests rely on, and the wrappers, which take their
    plain versions there, give a nonzero row to every face that owns a
    pixel and to no other."""
    cot, fid, lists, bbox, num_faces, geom = _scatter_scene("cpu", name,
                                                            streaming)
    counts = lists[-1].tolist()
    if name == "counts-0-1-128-129":
        assert counts == [0, 1, 128, 129]
    if name == "whole-tile-four-tiles":
        assert bbox[0].tolist() == [128, 255, 0, 31] and min(counts) >= 2
    cut = _SCATTER_SCENES[name][-1]
    assert (max(counts) == 128 and sum(counts) < num_faces) is cut
    owners = torch.unique(fid[fid >= 0]).long()
    assert owners.numel() > num_faces // 3
    if streaming:
        rows = scatter.scatter_to_faces_csr(cot, fid, *lists, num_faces,
                                            bbox=bbox, cull=bbox, **geom)
    else:
        rows = scatter.scatter_to_faces(cot, fid, *lists, num_faces + 1,
                                        bbox=bbox, cull=bbox,
                                        **geom)[:num_faces]
    assert rows.shape == (num_faces, cot.shape[0])
    assert torch.equal(torch.nonzero((rows != 0).any(1))[:, 0], owners)


def _case_id(case):
    return case if isinstance(case, str) else "-".join(map(str, case))


@pytest.mark.cuda
@pytest.mark.parametrize("case", _DENSE_CASES + list(_SCATTER_SCENES),
                         ids=_case_id)
def test_scatter_kernel_matches_plain_on_card(cuda, case):
    mass = None
    if isinstance(case, str):
        cot, fid_p, lists, bbox, num_faces, geom = _scatter_scene(
            cuda, case, streaming=False)
        mass = scatter.scatter_to_faces_plain(cot.abs(), fid_p,
                                              num_faces + 1)
    else:
        kind, height, width, channels, tile_h, tile_w = case
        fv, _, table, bins, bg_chw, cfg = _dense_forward(
            cuda, kind, height, width, channels, tile_h, tile_w)
        geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
        _, fid, _ = raster_fwd.raster_forward_plain(
            table, bins.bins, bins.counts, bg_chw, **geom)
        cot, fid_p = _scatter_inputs(fid, channels, height, width)
        num_faces, lists, bbox = fv.shape[0], (bins.bins, bins.counts), \
            bins.bbox
        cull = raster_fwd.csr_cull_boxes(table, *bg_chw.shape[1:])
    # The scenes' faces own pixels inside their boxes only.
    boxes = dict(bbox=bbox, cull=bbox if isinstance(case, str) else cull)
    args = (cot, fid_p, *lists, num_faces + 1)
    before = _launches("scatter_faces")
    rows_k = scatter.scatter_to_faces(*args, **boxes, **geom)
    torch.cuda.synchronize()
    assert _launches("scatter_faces") == before + 1
    _check_scatter_rows(
        rows_k, scatter.scatter_to_faces_plain(cot, fid_p, num_faces + 1),
        lambda: scatter.scatter_to_faces(*args, **boxes, **geom), mass)
    assert rows_k.shape[0] % 8 == 0 and not rows_k[num_faces:].any()
    with pytest.raises(ValueError, match="bbox"):
        scatter.scatter_to_faces(*args, **geom)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_CSR_CASES) + list(_SCATTER_SCENES))
def test_scatter_csr_kernel_matches_plain_on_card(cuda, case):
    mass = None
    if case in _SCATTER_SCENES:
        cot, fid_p, lists, bbox, num_faces, geom = _scatter_scene(
            cuda, case, streaming=True)
        mass = scatter.scatter_to_faces_csr_plain(cot.abs(), fid_p,
                                                  num_faces)
    else:
        fv, _, table, bins, bg_chw, cfg, height, width = _csr_forward(cuda,
                                                                      case)
        geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
        lists = (bins.entry_face, bins.start_block, bins.counts)
        _, fid, _ = raster_fwd.raster_forward_csr_plain(table, *lists, bg_chw,
                                                        **geom)
        cot, fid_p = _scatter_inputs(fid, bg_chw.shape[0], height, width)
        num_faces, bbox = fv.shape[0], bins.bbox
        cull = raster_fwd.csr_cull_boxes(table, *bg_chw.shape[1:])
    # The scenes' faces own pixels inside their boxes only.
    boxes = dict(bbox=bbox, cull=bbox if case in _SCATTER_SCENES else cull)
    args = (cot, fid_p, *lists, num_faces)
    before = _launches("scatter_faces_csr")
    rows_k = scatter.scatter_to_faces_csr(*args, **boxes, **geom)
    torch.cuda.synchronize()
    assert _launches("scatter_faces_csr") == before + 1
    _check_scatter_rows(
        rows_k, scatter.scatter_to_faces_csr_plain(cot, fid_p, num_faces),
        lambda: scatter.scatter_to_faces_csr(*args, **boxes, **geom), mass)
    assert rows_k.shape == (num_faces, cot.shape[0])
    with pytest.raises(ValueError, match="bbox"):
        scatter.scatter_to_faces_csr(*args, **geom)


def _sharded_counts():
    kernels = {"packed": ("raster_fwd_packed", "packed_bwd", "subtile_swap"),
               "dense": ("raster_fwd_dense", "scatter_faces"),
               "csr": ("raster_fwd_csr", "scatter_faces_csr")}
    return {engine: tuple(_launches(k) for k in names)
            for engine, names in kernels.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["dense", "csr", "packed"])
def test_sharded_renderer_on_card_matches_cpu(cuda, engine):
    """Four local slabs of a sphere at 256 x 256: the engine's forward
    kernel and its sharded backward's reduction (the scatter kernels, or
    the layout swap and the packed backward on halo-spliced neighbour maps)
    run once per slab,
    and no other engine's; image and gradients as on the CPU."""
    verts, colors, faces = sphere_scene(24, 32)
    bg = np.random.RandomState(6).rand(256, 256, 3).astype(np.float32)
    w = np.random.RandomState(7).randn(256, 256, 3).astype(np.float32)
    config = {"dense": dirt_tpu_torch.RasterConfig(engine="dense"),
              "csr": dirt_tpu_torch.RasterConfig(streaming=True),
              "packed": dirt_tpu_torch.RasterConfig(engine="packed")}[engine]
    outs, grads = [], []
    for device in ("cpu", cuda):
        bg_t, v_t, c_t, f_t = convert.scene_from_numpy(bg, verts, colors,
                                                       faces, device)
        leaves = [t.clone().requires_grad_() for t in (v_t, c_t, bg_t)]
        before = _sharded_counts()
        pix, fid, zbuf, ovf = rasterise_sharded(
            leaves[2], leaves[0], leaves[1], f_t, LocalGroup(4),
            config=config, with_aux=True)
        (pix * torch.tensor(w, device=device)).sum().backward()
        after = _sharded_counts()
        for name in after:
            n = 4 if (name == engine and device != "cpu") else 0
            assert after[name] == tuple(c + n for c in before[name])
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
