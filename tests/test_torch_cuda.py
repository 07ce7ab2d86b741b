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
the magnitudes the value adds up, so one dropped pixel shows; and on what
a row-sharded slab's backward hands them at 1024 x 1024 (the bench sphere
at 3, 9 and 16 channels, the 99,904-face sphere). The sharded renderer with
four local slabs on the card against the same on the CPU as above, with
each slab's kernels counted; at 1024 x 1024 with one and four slabs
against the single device (face ids equal, pixels within 3e-5, gradients
within 1e-4) and against its plain path (gradients within 1e-5). The
packed backward above one launch's column count (16, 32 and 33 channels)
like the packed backward below it.

The layout swap kernel against its plain version (a permutation: equal bit
for bit, float32 and int32 alike), and the packed backward kernel on
flat-subtile fields bit-equal to itself on image-layout fields; both also
on the fields a packed slab's halo backward swaps at 1024 x 1024. The packed
backward at 3, 9 and 16 channels on image and flat-subtile fields also bit
for bit against its plain version run on the CPU (the same sums in the
same order; on the card the plain version's ``index_add_`` flushes
subnormal sums to zero), and the fused dense backward at each of its
compile-time instances and its general form with the dense engine's
tolerance, on lists that reach their cap beside empty tiles. The packed
forward and backward kernels, which read each budget row's face row from
the face table through its entry, on what a gradient step hands them on
the 1,001,112-face sphere at 3 channels and on two slabs of the sharded
packed path at 3 and 9: bit for bit against their plain versions on the
card (the backward's rows but for sums below the smallest normal float).

The max-scan kernel (``ops/scan.py``, the packed binning's running maxima)
equal bit for bit to ``torch.cummax(x, 0).values``, twenty times in a row
on each input (the look-back's races would show as a run that differs):
lengths around a tile and up to the 1,001,112-face sphere's pool, the
whole int64 range, constant and strictly decreasing inputs, an input off
16-byte alignment, the five inputs the binning scans on the bench sphere
and on the 1,001,112-face sphere; inside a CUDA graph replayed ten times on
new inputs (its status words are zeroed by every replay). One eager
``bin_faces_packed`` call launches it five times, and its fields and the
ten ``_stage`` checksums on the card equal the CPU's.

The forward setup kernel (``triangle_setup.setup_faces``: planes, validity,
boxes and edge columns in one launch) bit for bit against its plain version
on the card, NaN where it is NaN: on faces made to hit each of its rules
(invalid, NaN, far off the image, z beyond either plane, just off each
side) at C = 1, 3, 9 and 16 (its two compile-time instances and its general
form; 326 faces, not a multiple of its block), in every box layout, on the
cells' spheres (1,001,112 faces with the clip off, 99,904 and 10,224 with
it on) and on inputs off 16-byte alignment; one launch a call, none for no
faces, and one a forward on each engine (none in a backward).
"""

import contextlib
import functools
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import dirt_tpu_torch
from _torch_port_scene import (
    SCAN_KINDS,
    SCAN_LENGTHS,
    SETUP_IMAGE,
    bits_equal,
    needle_soup,
    scan_input,
    screen_soup,
    setup_fwd_scenes,
    setup_vjp_cotangents,
    setup_vjp_scenes,
    sphere_scene,
)
from dirt_tpu_torch import convert, entry
from dirt_tpu_torch.ops import (
    _build,
    binning,
    fused_bwd,
    packed_bwd,
    raster,
    raster_fwd,
    scan,
    scatter,
)
from dirt_tpu_torch.parallel.group import LocalGroup
from dirt_tpu_torch.parallel.sharding import rasterise_sharded
from dirt_tpu_torch.ops import triangle_setup
from dirt_tpu_torch.ops.triangle_setup import (
    face_bboxes,
    screen_from_clip,
    setup_planes,
)
from dirt_tpu_torch.utils import trace

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import card_common  # noqa: E402
import bench_configs_torch  # noqa: E402  (card_common puts it on the path)

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
        table2, bins, bg_chw, tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    torch.cuda.synchronize()
    assert _launches("raster_fwd_packed") == before + 1
    pix_p, fid_p, z_p = raster_fwd.raster_forward_packed_plain(
        table2, bins, bg_chw, tile_h=cfg.tile_h, tile_w=cfg.tile_w)
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
        table2, bins, bg_chw, **geom)
    pix_p, fid_p, z_p = raster_fwd.raster_forward_packed_plain(
        table2, bins, bg_chw, **geom)
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


def _check_prologue_on_padded(fid, zbuf, pix_cf, grad_cf, tile_h, tile_w):
    """``padded_prologue`` on fields that are padded already (nothing left
    to pad): its five outputs bit for bit against its plain version's,
    in one launch; returns the bits."""
    args = (fid, zbuf, pix_cf.permute(1, 2, 0), grad_cf.permute(1, 2, 0),
            tile_h, tile_w)
    before = _launches("packed_prologue")
    got = packed_bwd.padded_prologue(*args)
    torch.cuda.synchronize()
    assert _launches("packed_prologue") == before + 1
    for g, w in zip(got, packed_bwd.padded_prologue_plain(*args)):
        assert torch.equal(g, w)
    return got[1]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,height,width,channels,tile_h", _KERNEL_CASES)
def test_prologue_kernel_matches_plain_on_card(cuda, kind, height, width,
                                               channels, tile_h):
    prep = _backward_inputs(cuda, kind, height, width, channels, tile_h)
    bits = _check_prologue_on_padded(
        prep.fid_p, torch.rand_like(prep.fid_p, dtype=torch.float32),
        prep.pix_cf, prep.grad_cf, prep.tile_h, prep.tile_w)
    assert (bits != 0).any()


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
    _check_prologue_on_padded(fid, zbuf, prep.pix_cf, prep.grad_cf,
                              prep.tile_h, prep.tile_w)


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
        prep, prep.bins.table, 0, prep.budget_chunks)
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
        packed_bwd.packed_entry_rows_plain(flat, prep.bins.table, 0,
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
        prep, prep.bins.table, 0, prep.budget_chunks)
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
        on_cpu, on_cpu.bins.table, 0, prep.budget_chunks)
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
        assert card_common.rel_err(g_card, g_cpu) <= 1e-4


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
        assert card_common.rel_err(g_card, g_cpu) <= 1e-4


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
        assert card_common.rel_err(g_card, g_cpu) <= 1e-4


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
    assert card_common.rel_err(dv_g, dv_c) <= 1e-4
    assert card_common.rel_err(dp_g, dp_c) <= 1e-4


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

    ((args, kwargs),) = card_common.calls(fused_bwd, name, step)
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

    calls = card_common.calls(scatter, name, step)
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
        assert card_common.rel_err(g_card, g_cpu) <= 1e-4


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
    and no other engine's; the setup VJP once per slab, the forward setup
    once per slab's forward (and, dense and streaming, once per slab's
    backward, which sets the planes up one row down); image and
    gradients as on the CPU."""
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
        vjp_before = _launches("setup_vjp")
        fwd_before = _launches("setup_fwd")
        pix, fid, zbuf, ovf = rasterise_sharded(
            leaves[2], leaves[0], leaves[1], f_t, LocalGroup(4),
            config=config, with_aux=True)
        (pix * torch.tensor(w, device=device)).sum().backward()
        after = _sharded_counts()
        for name in after:
            n = 4 if (name == engine and device != "cpu") else 0
            assert after[name] == tuple(c + n for c in before[name])
        assert _launches("setup_vjp") == vjp_before + (
            4 if device != "cpu" else 0)
        assert _launches("setup_fwd") == fwd_before + (
            0 if device == "cpu" else 4 if engine == "packed" else 8)
        outs.append((pix.detach().cpu(), fid.cpu(), zbuf.cpu(), bool(ovf)))
        grads.append([t.grad.cpu() for t in leaves])
    (pix_c, fid_c, z_c, ovf_c), (pix_g, fid_g, z_g, ovf_g) = outs
    assert ovf_g is ovf_c is False
    assert torch.equal(fid_g, fid_c)
    torch.testing.assert_close(pix_g, pix_c, **TOL)
    torch.testing.assert_close(z_g, z_c, **TOL)
    for g_cpu, g_card in zip(*grads):
        assert torch.isfinite(g_card).all()
        assert card_common.rel_err(g_card, g_cpu) <= 1e-4


# --- max-scan ------------------------------------------------------------

# Runs of each max-scan case: a race in the look-back would give a run that
# differs from the others.
SCAN_REPEATS = 20


def _scan_repeats(x, repeats=SCAN_REPEATS):
    """``scan.max_scan(x)`` ``repeats`` times, each bit-equal to
    ``torch.cummax``, with one launch counted a run."""
    want = torch.cummax(x, 0).values
    before = _launches("max_scan")
    for _ in range(repeats):
        got = scan.max_scan(x)
        assert got.dtype == torch.int64 and got.shape == x.shape
        assert torch.equal(got, want)
    assert _launches("max_scan") == before + repeats


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SCAN_KINDS)
@pytest.mark.parametrize("n", SCAN_LENGTHS)
def test_max_scan_matches_cummax_on_card(cuda, n, kind):
    _scan_repeats(torch.from_numpy(scan_input(kind, n, seed=n)).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SCAN_KINDS)
def test_max_scan_matches_cummax_off_vector_alignment_on_card(cuda, kind):
    """A view 8 bytes into its storage: no 16-byte vectors."""
    n = 5 * scan.TILE + 3
    buf = torch.from_numpy(scan_input(kind, n + 1, seed=3)).to(cuda)
    x = buf[1:]
    assert x.data_ptr() % 16 == 8 and x.is_contiguous()
    _scan_repeats(x)


@pytest.mark.cuda
def test_max_scan_of_nothing_launches_nothing_on_card(cuda):
    before = _launches("max_scan")
    assert scan.max_scan(torch.zeros(0, dtype=torch.int64,
                                     device=cuda)).shape == (0,)
    assert _launches("max_scan") == before


@pytest.mark.cuda
def test_max_scan_in_a_cuda_graph_on_card(cuda):
    """Captured once, replayed ten times on new inputs: the counter and the
    tiles' flags start from zero on every replay."""
    n = 50 * scan.TILE + 17
    static = torch.from_numpy(scan_input("random", n, seed=0)).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        scan.max_scan(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = scan.max_scan(static)
    for replay in range(10):
        kind = SCAN_KINDS[replay % len(SCAN_KINDS)]
        x = torch.from_numpy(scan_input(kind, n, seed=replay + 1)).to(cuda)
        static.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, torch.cummax(x, 0).values), (replay, kind)


@functools.lru_cache(maxsize=None)
def _binning_inputs(n_lat):
    """(bbox, edges, geometry) of the bench sphere ``uv_sphere(n_lat,
    n_lat)`` at 1024 x 1024 on the card under ``suggest_raster_config``'s
    packed caps, as ``tools/prof_torch_binning.py`` bins it."""
    _, clip, colors, faces, _, _ = card_common.bench_scene(1024, "cuda",
                                                           n=n_lat)
    config = dirt_tpu_torch.suggest_raster_config(
        clip, faces, 1024, 1024, clip=False).concrete(1024)
    assert raster.resolve_engine(config, faces.shape[0]) == "packed"
    geom = card_common.Geometry(config, faces.shape[0], 1024)
    _, _, bbox, edges = card_common.setup(clip, colors, faces, 1024)
    return bbox, edges, geom


@pytest.mark.cuda
@pytest.mark.parametrize("n_lat", [72, 708], ids=["10224", "1001112"])
def test_max_scan_matches_cummax_on_binning_inputs_on_card(cuda, n_lat):
    """The five arrays ``bin_faces_packed`` scans, captured from one call on
    the bench sphere and on the 1,001,112-face sphere."""
    bbox, edges, geom = _binning_inputs(n_lat)
    import prof_torch_binning

    seen = prof_torch_binning.capture_cummax(bbox, edges, geom)
    assert len(seen) == 5
    for x in seen:
        _scan_repeats(x)


@pytest.mark.cuda
def test_packed_binning_on_card_scans_five_times_and_equals_cpu(cuda):
    """One eager ``bin_faces_packed`` call of the bench sphere launches the
    max-scan five times; its fields and the ten ``_stage`` checksums equal
    the CPU's from the same inputs."""
    bbox, edges, geom = _binning_inputs(72)
    import prof_torch_binning

    before = _launches("max_scan")
    bins = card_common.bin_faces(bbox, edges, geom)
    torch.cuda.synchronize()
    assert _launches("max_scan") == before + 5
    bbox_cpu = tuple(c.cpu() for c in bbox)
    edges_cpu = [c.cpu() for c in edges]
    want = card_common.bin_faces(bbox_cpu, edges_cpu, geom)
    assert not bool(bins.overflow)
    for field in binning.PackedBins._fields:
        a, b = getattr(bins, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert torch.equal(a.cpu(), b), field
    assert prof_torch_binning.stage_checksums(bbox, edges, geom) == \
        prof_torch_binning.stage_checksums(bbox_cpu, edges_cpu, geom)


# --- the setup VJP -------------------------------------------------------


def _vjp_args(fv, fa, seed, device):
    """(fv, fa, d_geo, d_att) on ``device``, ``d_att`` as the engines hand
    it: a view of [F, 12 + 3C] face rows."""
    d_geo, d_att = setup_vjp_cotangents(len(fv), fa.shape[-1], seed)
    rows = torch.zeros(len(fv), 12 + d_att.shape[1], device=device)
    rows[:, 12:] = torch.as_tensor(d_att, device=device)
    return (torch.as_tensor(fv, device=device),
            torch.as_tensor(fa, device=device),
            torch.as_tensor(d_geo, device=device), rows[:, 12:])


def _check_vjp_kernel(fv, fa, d_geo, d_att, row_shift=0.0, need=(True, True)):
    """The kernel bit-equal to its plain version on the card, twice, with
    one launch a call."""
    want = triangle_setup.setup_planes_vjp_plain(fv, fa, d_geo, d_att,
                                                 row_shift, *need)
    for _ in range(2):
        before = _launches("setup_vjp")
        got = triangle_setup.setup_planes_vjp(fv, fa, d_geo, d_att,
                                              row_shift, *need)
        torch.cuda.synchronize()
        assert _launches("setup_vjp") == before + 1
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("row_shift", [0.0, 1.0])
@pytest.mark.parametrize("name", ["soup C=1", "soup C=3", "soup C=9",
                                  "soup C=16", "invalid", "sphere 10224",
                                  "clipped sphere"])
def test_setup_vjp_kernel_bits_equal_plain_on_card(cuda, name, row_shift):
    """On the CPU tests' scenes: the instances for C = 3 and 9 and the
    general form (C = 1, 16), invalid faces of every kind."""
    fv, fa = setup_vjp_scenes()[name]
    _check_vjp_kernel(*_vjp_args(fv, fa, 3, cuda), row_shift)


@functools.lru_cache(maxsize=None)
def _sphere_faces(n_lat, clip):
    """``card_common.sphere_faces`` on the card, once a process."""
    return card_common.sphere_faces(n_lat, clip, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_lat,clip", [(72, False), (224, True),
                                        (708, False)],
                         ids=["10224", "99904 clipped", "1001112"])
def test_setup_vjp_kernel_on_the_cells_spheres_on_card(cuda, n_lat, clip):
    """The faces ``deferred10k``, ``sphere100k`` and ``sphere1m`` hand the
    raster op (C = 3), random cotangents."""
    fv, fa = _sphere_faces(n_lat, clip)
    gen = torch.Generator(device=cuda).manual_seed(n_lat)
    rows = torch.randn(fv.shape[0], 21, device=cuda, generator=gen)
    d_geo = torch.randn(fv.shape[0], 24, device=cuda, generator=gen)
    _check_vjp_kernel(fv, fa, d_geo, rows[:, 12:])


def _layouts():
    """{name: (channels, d_geo row stride, d_att row stride, offset of
    every input from 16-byte alignment in floats, need)}."""
    return {
        "C=3 contiguous d_att": (3, 24, 9, 0, (True, True)),
        "C=3 off alignment": (3, 24, 21, 1, (True, True)),
        "C=9 odd d_geo stride": (9, 25, 39, 0, (True, True)),
        "C=9 rows too wide to stage": (9, 24, 4096, 0, (True, True)),
        "C=3 d_face_verts only": (3, 24, 21, 0, (True, False)),
        "C=9 d_face_attrs only": (9, 24, 39, 0, (False, True)),
        "C=16 off alignment": (16, 24, 60, 3, (True, True)),
        "C=2 general": (2, 24, 18, 0, (True, True)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(_layouts()))
def test_setup_vjp_kernel_takes_every_layout_on_card(cuda, layout):
    """Row strides, alignment, the outputs asked for; a face count off
    the block size."""
    channels, gs, as_, off, need = _layouts()[layout]
    fv, fa = screen_soup(1000 + 37, 512, 512, seed=channels,
                         channels=channels, spread=40.0)
    rng = np.random.RandomState(off)
    fv[..., 3] = rng.uniform(0.2, 2.0, fv.shape[:2])
    n = len(fv)

    def placed(a, stride=None):
        a = torch.as_tensor(a.reshape(n, -1), device=cuda)
        stride = stride or a.shape[1]
        buf = torch.randn(off + n * stride, device=cuda)
        view = buf[off:].reshape(n, stride)[:, :a.shape[1]]
        view.copy_(a)
        return view

    d_geo = placed(rng.randn(n, 24).astype(np.float32), gs)
    d_att = placed(rng.randn(n, 3 * channels).astype(np.float32), as_)
    face_verts = placed(fv).reshape(n, 3, 4)
    face_attrs = placed(fa).reshape(n, 3, channels)
    assert face_verts.data_ptr() % 16 == (4 * off) % 16
    _check_vjp_kernel(face_verts, face_attrs, d_geo, d_att, 1.0, need)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["packed", "dense", "csr"])
def test_one_setup_vjp_launch_per_backward_on_card(cuda, engine):
    """Each engine's backward chains its plane cotangents to the faces in
    one launch, with the gradients the CPU gives; its forward sets the
    faces up in one launch, and the backward sets none up."""
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
            config=dirt_tpu_torch.RasterConfig(**fields), clip=True)
        leaves = [t.clone().requires_grad_() for t in scene[:3]]
        before = _launches("setup_vjp")
        fwd_before = _launches("setup_fwd")
        pixels = dirt_tpu_torch.rasterise(leaves[0], leaves[1], leaves[2],
                                          scene[3], config=config)
        torch.cuda.synchronize()
        assert _launches("setup_fwd") == fwd_before + launches
        (pixels * torch.tensor(weights, device=device)).sum().backward()
        torch.cuda.synchronize()
        assert _launches("setup_vjp") == before + launches
        assert _launches("setup_fwd") == fwd_before + launches
        grads.append([t.grad.cpu() for t in leaves])
    for g_cpu, g_card in zip(*grads):
        assert card_common.rel_err(g_card, g_cpu) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("path, launches", [("overlap", 8),
                                            ("face_sharded", 4)])
def test_parallel_backwards_launch_setup_vjp_on_card(cuda, path, launches):
    """The overlapped backward pulls its plane cotangents back through the
    setup VJP kernel once per slab and chunk (4 x 2), the face-sharded
    one once per member (4), with the gradients the CPU gives."""
    from dirt_tpu_torch.parallel.face_sharding import rasterise_face_sharded

    verts, colors, faces = sphere_scene(24, 32)
    bg = np.random.RandomState(6).rand(256, 256, 3).astype(np.float32)
    w = np.random.RandomState(7).randn(256, 256, 3).astype(np.float32)
    config = dirt_tpu_torch.RasterConfig(engine="packed")
    grads = []
    for device, want in (("cpu", 0), (cuda, launches)):
        bg_t, v_t, c_t, f_t = convert.scene_from_numpy(bg, verts, colors,
                                                       faces, device)
        leaves = [t.clone().requires_grad_() for t in (v_t, c_t, bg_t)]
        before = _launches("setup_vjp")
        if path == "overlap":
            pixels = rasterise_sharded(leaves[2], leaves[0], leaves[1], f_t,
                                       LocalGroup(4), config=config,
                                       overlap_chunks=2)
        else:
            pixels = rasterise_face_sharded(leaves[2], leaves[0], leaves[1],
                                            f_t, LocalGroup(4), config=config)
        (pixels * torch.tensor(w, device=device)).sum().backward()
        torch.cuda.synchronize()
        assert _launches("setup_vjp") == before + want
        grads.append([t.grad.cpu() for t in leaves])
    for g_cpu, g_card in zip(*grads):
        assert card_common.rel_err(g_card, g_cpu) <= 1e-4


# --- the forward setup ----------------------------------------------------


def _check_setup_kernel(fv, fa, height, width, engine):
    """The kernel bit-equal to its plain version on the card (NaN where it
    is NaN), its columns contiguous, twice, with one launch a call (none
    for no faces)."""
    want = triangle_setup.setup_faces_plain(fv, fa, height, width, engine)
    for _ in range(2):
        before = _launches("setup_fwd")
        got = triangle_setup.setup_faces(fv, fa, height, width, engine)
        torch.cuda.synchronize()
        assert _launches("setup_fwd") == before + (1 if len(fv) else 0)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            pairs = zip(g, w) if isinstance(w, tuple) else [(g, w)]
            assert len(g) == len(w)
            for a, b in pairs:
                assert bits_equal(a, b) and a.is_contiguous()


_SETUP_SCENES = [f"hazards C={c}" for c in (1, 3, 9, 16)] + [
    "sphere 10224", "clipped sphere"]


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["packed", "dense", None])
@pytest.mark.parametrize("name", _SETUP_SCENES)
def test_setup_fwd_kernel_bits_equal_plain_on_card(cuda, name, engine):
    """On the CPU tests' scenes: the instances for C = 3 and 9 and the
    general form (C = 1, 16); the box columns with the edge columns, the
    box rows (the dense and streaming engines'), the planes alone."""
    fv, fa = (torch.as_tensor(a, device=cuda)
              for a in setup_fwd_scenes()[name])
    _check_setup_kernel(fv, fa, *SETUP_IMAGE, engine)


@pytest.mark.cuda
@pytest.mark.parametrize("n_lat,clip,channels,engine",
                         [(72, True, 9, "packed"), (224, True, 3, "csr"),
                          (708, False, 3, "packed")],
                         ids=["10224 clipped C=9", "99904 clipped",
                              "1001112"])
def test_setup_fwd_kernel_on_the_cells_spheres_on_card(cuda, n_lat, clip,
                                                       channels, engine):
    """The faces ``deferred10k`` (with the G-buffer's nine channels),
    ``sphere100k`` and ``sphere1m`` hand the raster op, in their engines'
    layouts at 1024 x 1024."""
    fv, fa = _sphere_faces(n_lat, clip)
    if channels != 3:
        gen = torch.Generator(device=cuda).manual_seed(n_lat)
        fa = torch.rand(fv.shape[0], 3, channels, device=cuda, generator=gen)
    _check_setup_kernel(fv, fa, SIZE, SIZE, engine)


@pytest.mark.cuda
@pytest.mark.parametrize("channels,offset", [(3, 1), (9, 2), (5, 3),
                                             (3, 0)])
def test_setup_fwd_kernel_takes_inputs_off_alignment_on_card(cuda, channels,
                                                             offset):
    """Contiguous inputs ``offset`` floats off 16-byte alignment (the
    staged instances' scalar loads), in both box layouts; no faces."""
    fv, fa = screen_soup(1000 + 37, 384, 512, seed=channels,
                         channels=channels, spread=40.0)

    def placed(a):
        buf = torch.randn(offset + a.size, device=cuda)
        view = buf[offset:].view(a.shape)
        view.copy_(torch.as_tensor(a))
        return view

    fv_t, fa_t = placed(fv), placed(fa)
    assert fv_t.is_contiguous() and fv_t.data_ptr() % 16 == 4 * offset % 16
    for engine in ("packed", "dense"):
        _check_setup_kernel(fv_t, fa_t, 384, 512, engine)
    _check_setup_kernel(fv_t[:0], fa_t[:0], 384, 512, "packed")


# --- the port at the cells' size ------------------------------------------
#
# The bench sphere (10,224 faces), the 99,904-face and the 1,001,112-face
# spheres at 1024 x 1024 under the bench camera (``tools/card_common.py``),
# the sheet's configs, the flagship step and the demos, each as a user runs
# it. Launch expectations count the package's kernels from the registry
# (the tracing markers apart).

SIZE = card_common.SIZE


@contextlib.contextmanager
def _plain_kernels():
    """Every kernel wrapper's plain version in its place: the same path
    with no kernel."""
    def plain_scatter(cot_cf, fid, bins, counts, num_rows, *, tile_h, tile_w,
                      bbox=None, cull=None):
        return scatter.scatter_to_faces_plain(cot_cf, fid, num_rows)

    def plain_scatter_csr(cot_cf, fid, entry_face, start_block, counts,
                          num_faces, *, tile_h, tile_w, bbox=None, cull=None):
        return scatter.scatter_to_faces_csr_plain(cot_cf, fid, num_faces)

    def plain_dense(table, bins, counts, background_chw, *, tile_h, tile_w):
        return (*raster_fwd.raster_forward_plain(
            table, bins, counts, background_chw, tile_h=tile_h,
            tile_w=tile_w), raster_fwd.csr_cull_boxes_plain(
                table, *background_chw.shape[1:]))

    def plain_csr(table, entry_face, start_block, counts, background_chw, *,
                  tile_h, tile_w):
        return (*raster_fwd.raster_forward_csr_plain(
            table, entry_face, start_block, counts, background_chw,
            tile_h=tile_h, tile_w=tile_w), raster_fwd.csr_cull_boxes_plain(
                table, *background_chw.shape[1:]))

    def plain_rows(prep, c_lo=0, c_hi=None):
        return packed_bwd.packed_entry_rows_plain(
            prep, packed_bwd._entry_table(prep), c_lo,
            prep.budget_chunks if c_hi is None else c_hi)

    def plain_fused(geo, bins, counts, fid, bits, sval, pix_cf, grad_cf,
                    num_rows, *, tile_h, tile_w, bbox=None, cull=None):
        return fused_bwd.fused_backward_rows_plain(
            geo, fid, bits, sval, pix_cf, grad_cf, num_rows)

    def plain_fused_csr(geo, entry_face, start_block, counts, fid, bits,
                        sval, pix_cf, grad_cf, num_faces, *, tile_h, tile_w,
                        bbox=None, cull=None):
        return fused_bwd.fused_backward_rows_csr_plain(
            geo, fid, bits, sval, pix_cf, grad_cf, num_faces)

    with contextlib.ExitStack() as stack:
        for module, name, plain in (
                (scatter, "scatter_to_faces", plain_scatter),
                (scatter, "scatter_to_faces_csr", plain_scatter_csr),
                (raster_fwd, "raster_forward", plain_dense),
                (raster_fwd, "raster_forward_csr", plain_csr),
                (raster_fwd, "raster_forward_packed",
                 raster_fwd.raster_forward_packed_plain),
                (raster_fwd, "flat_subtile_swap",
                 lambda arrays: [raster_fwd.flat_subtile_swap_plain(a)
                                 for a in arrays]),
                (packed_bwd, "padded_prologue",
                 packed_bwd.padded_prologue_plain),
                (packed_bwd, "packed_entry_rows", plain_rows),
                (fused_bwd, "fused_backward_rows", plain_fused),
                (fused_bwd, "fused_backward_rows_csr", plain_fused_csr),
                (scan, "max_scan", scan.max_scan_plain),
                (triangle_setup, "setup_planes_vjp",
                 triangle_setup.setup_planes_vjp_plain),
                (triangle_setup, "setup_faces",
                 triangle_setup.setup_faces_plain)):
            stack.enter_context(mock.patch.object(module, name, plain))
        yield


def _bench_scene(n=72):
    return card_common.bench_scene(SIZE, "cuda", n=n)


@functools.lru_cache(maxsize=None)
def _bench_config(n=72, clip=False, **fields):
    _, verts, _, faces, _, _ = _bench_scene(n)
    return dirt_tpu_torch.suggest_raster_config(
        verts, faces, SIZE, SIZE,
        config=dirt_tpu_torch.RasterConfig(**fields), clip=clip)


def _check_padded_prologue(fid, zbuf, pixels, grad, tile_h, tile_w):
    """The prologue on what a backward hands it, its five outputs bit for
    bit against its plain version's; returns them."""
    args = (fid, zbuf, pixels, grad, tile_h, tile_w)
    got = packed_bwd.padded_prologue(*args)
    for g, w in zip(got, packed_bwd.padded_prologue_plain(*args)):
        assert torch.equal(g, w)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [3, 9, 16])
def test_packed_kernels_at_full_size_on_card(cuda, channels):
    """K1, K3 and K2 on the bench sphere's real bins, rows and outputs at
    1024 x 1024 under its packed caps, at the bench's 3 channels, the
    G-buffer's 9 and 16 (two K2 launches' worth): K1 and K3 bit for bit,
    K2's rows within its tolerance and equal on a second run."""
    _, verts, colors, faces, _, weights = _bench_scene()
    if channels != 3:
        colors = card_common.rand(channels, verts.shape[0], channels,
                                  device=cuda)
        weights = card_common.rand(channels + 1, SIZE, SIZE, channels,
                                   device=cuda)
    face_verts = screen_from_clip(verts, SIZE, SIZE)[faces]
    background = torch.zeros((SIZE, SIZE, channels), device=cuda)
    table2, bins, bg_chw, cfg = raster.prepare_packed(
        face_verts, colors[faces], background, _bench_config())
    assert not bool(bins.overflow)
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    pix_k, fid_k, z_k = raster_fwd.raster_forward_packed(
        table2, bins, bg_chw, **geom)
    for got, want in zip((pix_k, fid_k, z_k),
                         raster_fwd.raster_forward_packed_plain(
                             table2, bins, bg_chw, **geom)):
        assert torch.equal(got, want)
    assert (fid_k >= 0).any()
    _check_padded_prologue(fid_k[:SIZE, :SIZE], z_k[:SIZE, :SIZE],
                           pix_k.permute(1, 2, 0)[:SIZE, :SIZE], weights,
                           cfg.tile_h, cfg.tile_w)
    geo, att, _ = setup_planes(face_verts, colors[faces])
    prep = packed_bwd.prepare_backward_packed(
        geo, att, fid_k, z_k, pix_k.permute(1, 2, 0), weights, bins,
        cfg.tile_h, cfg.tile_w)
    rows_k = packed_bwd.packed_entry_rows(prep)
    rows_p = packed_bwd.packed_entry_rows_plain(prep, bins.table, 0,
                                                prep.budget_chunks)
    torch.testing.assert_close(rows_k, rows_p, **TOL_BWD)
    assert (rows_k != 0).any()
    assert torch.equal(rows_k, packed_bwd.packed_entry_rows(prep))


def _tile_case(case, device):
    """(engine, face_verts, face_attrs, size, config, upstream gradient) of
    one whole-tile kernel case: the faces its path's own render hands the
    raster op."""
    if case.startswith("bench"):
        _, verts, colors, faces, _, weights = _bench_scene()
        fields = (dict(engine="dense") if case.endswith("dense")
                  else dict(streaming=True))
        return (fields.get("engine", "csr"),
                screen_from_clip(verts, SIZE, SIZE)[faces], colors[faces],
                SIZE, _bench_config(**fields), weights)
    if case.startswith("99904"):
        channels = 9 if case.endswith("C=9") else 3
        loss_fn, (bg, verts, colors), (faces, config) = \
            card_common.big_sphere_step(device)
        if channels == 9:
            colors = card_common.rand(3, verts.shape[0], 9, device=device)
            bg = torch.zeros((SIZE, SIZE, 9), device=device)
        with torch.no_grad():
            fv, fa, _, cfg = card_common.raster_inputs(
                lambda: dirt_tpu_torch.rasterise(bg, verts, colors, faces,
                                                 config=config))
        return ("csr", fv, fa, SIZE, cfg,
                card_common.rand(channels + 1, SIZE, SIZE, channels,
                                 device=device))
    if case == "config4 512^2":
        config = bench_configs_torch.config4(device)
        run = functools.partial(config.loss, *config.leaves)
        size, weights = 512, card_common.rand(1, 512, 512, 3, device=device)
    else:
        forward_step, args = entry.entry(device)
        run = functools.partial(forward_step, *args)
        size, weights = 256, card_common.rand(5, 256, 256, 9, device=device)
    with torch.no_grad():
        fv, fa, _, cfg = card_common.raster_inputs(run)
    return "dense", fv, fa, size, cfg, weights


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "config4 512^2", "bench 1024^2 dense", "flagship 256^2 C=9",
    "99904 1024^2 C=3", "99904 1024^2 C=9", "bench 1024^2 csr"])
def test_tile_kernels_at_full_size_on_card(cuda, case):
    """K5 or K7, the prologue and K6 or K8 on the faces each path hands
    the raster op (config 4's and the flagship's after the near-plane
    clip, the default API's 99,904 faces at 3 and 9 channels) and on the
    bench sphere under the engine's own caps: the forward against the
    plain (un-culled) walk on the whole padded arrays, its cull boxes, the
    prologue bit for bit, the rows within the row tolerance and equal on
    a second run."""
    engine, fv, fa, size, config, weights = _tile_case(case, cuda)
    background = torch.zeros((size, size, fa.shape[-1]), device=cuda)
    if engine == "csr":
        table, bins, bg_chw, cfg = raster.prepare_csr(fv, fa, background,
                                                      config)
        lists = (bins.entry_face, bins.start_block, bins.counts)
        forward, forward_plain = (raster_fwd.raster_forward_csr,
                                  raster_fwd.raster_forward_csr_plain)
        rows_fn, rows_plain = (fused_bwd.fused_backward_rows_csr,
                               fused_bwd.fused_backward_rows_csr_plain)
        n_rows = fv.shape[0]
    else:
        table, bins, bg_chw, cfg = raster.prepare_dense(fv, fa, background,
                                                        config)
        lists = (bins.bins, bins.counts)
        forward, forward_plain = (raster_fwd.raster_forward,
                                  raster_fwd.raster_forward_plain)
        rows_fn, rows_plain = (fused_bwd.fused_backward_rows,
                               fused_bwd.fused_backward_rows_plain)
        n_rows = fv.shape[0] + 1
    assert not bool(bins.overflow.any())
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    pix_k, fid_k, z_k, cull = forward(table, *lists, bg_chw, **geom)
    pix_p, fid_p, z_p = forward_plain(table, *lists, bg_chw, **geom)
    assert torch.equal(fid_k, fid_p) and torch.equal(z_k, z_p)
    torch.testing.assert_close(pix_k, pix_p, **TOL)
    assert torch.equal(cull, raster_fwd.csr_cull_boxes_plain(
        table, *bg_chw.shape[1:]))
    assert (fid_k >= 0).any()
    fields = _check_padded_prologue(fid_k, z_k, pix_k.permute(1, 2, 0),
                                    weights, cfg.tile_h, cfg.tile_w)
    geo = setup_planes(fv, fa)[0].contiguous()
    rows_k = rows_fn(geo, *lists, *fields, n_rows, bbox=bins.bbox, cull=cull,
                     **geom)
    want = rows_plain(geo, *fields, n_rows)
    scale = want.abs().amax(dim=0, keepdim=True)
    assert ((rows_k - want).abs() <= card_common.TOL_ROWS * scale
            + 1e-6).all()
    assert (rows_k != 0).any()
    assert torch.equal(rows_k, rows_fn(geo, *lists, *fields, n_rows,
                                       bbox=bins.bbox, cull=cull, **geom))


def _demo(name):
    """The module of ``demos/<name>.py``."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "demos" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bench_loss(clip):
    _, verts, colors, faces, background, weights = _bench_scene()
    config = _bench_config(clip=clip)

    def loss_fn(bg, v, c):
        return (dirt_tpu_torch.rasterise(bg, v, c, faces, config=config,
                                         clip=clip) * weights).sum()

    return loss_fn, (background, verts, colors)


def _config_loss(n):
    config = bench_configs_torch.CONFIGS[n - 1]("cuda")
    return config.loss, config.leaves


def _config5_loss():
    config = bench_configs_torch.config5("cuda")
    weights = card_common.rand(1, SIZE, SIZE, 3, device="cuda")
    return (lambda v, p: (config.forward(v, p) * weights).sum(),
            config.leaves)


def _demo_loss(name, *args):
    loss_fn, params = _demo(name).problem(*args, device="cuda")[:2]
    return loss_fn, tuple(params.values())


# (case, (loss_fn, leaves) maker, the kernels one step launches, the
# gradients' tolerance against the plain path's: 1e-4 where torch's own
# scatter-adds (vertex normals, texture and vertex gathers) sum with
# atomics). Every forward sets its faces up once; a packed step bins once
# (five scans); every backward runs the prologue and the setup VJP once.
_STEPS = [
    ("bench packed clip=False", functools.partial(_bench_loss, False),
     {"raster_fwd_packed": 1, "max_scan": 5, "packed_prologue": 1,
      "packed_bwd": 1, "setup_vjp": 1, "setup_fwd": 1}, 1e-5),
    ("bench packed clip=True", functools.partial(_bench_loss, True),
     {"raster_fwd_packed": 1, "max_scan": 5, "packed_prologue": 1,
      "packed_bwd": 1, "setup_vjp": 1, "setup_fwd": 1}, 1e-5),
    ("99904 default API", lambda: card_common.big_sphere_step("cuda")[:2],
     {"raster_fwd_csr": 1, "packed_prologue": 1, "fused_bwd_csr": 1,
      "setup_vjp": 1, "setup_fwd": 1}, 1e-5),
    *((f"config{n}", functools.partial(_config_loss, n),
       {"raster_fwd_dense": 1, "packed_prologue": 1, "fused_bwd": 1,
        "setup_vjp": 1, "setup_fwd": 1}, 1e-4) for n in (1, 2, 3, 4)),
    ("config5", _config5_loss,
     {"raster_fwd_packed": 1, "max_scan": 5, "packed_prologue": 1,
      "packed_bwd": 1, "setup_vjp": 1, "setup_fwd": 1}, 1e-4),
    ("flagship", lambda: entry.entry("cuda"),
     {"raster_fwd_dense": 1, "packed_prologue": 1, "fused_bwd": 1,
      "setup_vjp": 1, "setup_fwd": 1}, 1e-4),
    ("demo3", functools.partial(_demo_loss, "torch_demo3_textured", 512),
     {"raster_fwd_dense": 1, "setup_fwd": 1}, 1e-4),
    ("demo4", functools.partial(_demo_loss, "torch_demo4_lit", 512),
     {"raster_fwd_dense": 1, "packed_prologue": 1, "fused_bwd": 1,
      "setup_vjp": 1, "setup_fwd": 1}, 1e-4),
    ("demo5", functools.partial(_demo_loss, "torch_demo5_deferred", SIZE, 72,
                                72),
     {"raster_fwd_packed": 1, "max_scan": 5, "packed_prologue": 1,
      "packed_bwd": 1, "setup_vjp": 1, "setup_fwd": 1}, 1e-4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [case for case, *_ in _STEPS])
def test_step_matches_plain_path_on_card(cuda, case):
    """One gradient step of each path at its own size against the same
    step with every kernel replaced by its plain version: the loss within
    1e-5, gradients finite, nonzero and within the case's tolerance of max
    |gradient|. The kernel step launches each of its kernels once (the
    packed binning's five scans), the plain step none. (Demo 3 trains the
    texture alone: no gradient reaches the raster op.)"""
    make, launches, tol = next((m, n, t) for c, m, n, t in _STEPS
                               if c == case)
    loss_fn, leaves = make()

    def step():
        fresh = [t.detach().clone().requires_grad_() for t in leaves]
        loss = loss_fn(*fresh)
        loss.backward()
        return loss.detach(), [t.grad for t in fresh]

    step()                              # builds kernels, fills caches
    (loss_k, grads_k), counts = card_common.launched(step)
    assert counts == launches
    with _plain_kernels():
        (loss_p, grads_p), counts = card_common.launched(step)
    assert counts == {}
    assert abs(float(loss_k) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    for g_k, g_p in zip(grads_k, grads_p):
        assert g_k is not None and torch.isfinite(g_k).all()
        assert g_k.abs().sum() > 0
        assert card_common.rel_err(g_k, g_p) <= tol


@pytest.mark.cuda
def test_bench_sphere_renders_and_trains_on_card(cuda):
    """The bench step with the near-plane clip off and on: overflow clear,
    face ids in range and equal both ways, depths in [-1, 1], colors in
    [0, 1], d_background w off the mesh and 0 on it; then 10 Adam steps on
    pose and colors towards the render, whose L2 loss falls."""
    verts_obj, verts, colors, faces, background, weights = _bench_scene()
    fids = []
    for clip in (False, True):
        (pixels, fid, zbuf, overflow), (d_v, d_c, d_bg) = \
            card_common.render_grads(dirt_tpu_torch.rasterise_with_aux,
                                     background, verts, colors, faces,
                                     weights, _bench_config(clip=clip), clip)
        hit = fid >= 0
        assert not bool(overflow) and hit.any()
        assert int(fid.max()) < faces.shape[0]
        assert ((zbuf[hit] >= -1) & (zbuf[hit] <= 1)).all()
        assert ((pixels >= -1e-5) & (pixels <= 1 + 1e-5)).all()
        assert torch.isfinite(d_v).all() and d_v.abs().sum() > 0
        assert torch.isfinite(d_c).all() and d_c.abs().sum() > 0
        assert torch.equal(d_bg[~hit], weights[~hit])
        assert (d_bg[hit] == 0).all()
        fids.append(fid)
    assert torch.equal(*fids)

    config = _bench_config()
    target = dirt_tpu_torch.rasterise(background, verts, colors, faces,
                                      config=config, clip=False)
    rot = torch.tensor(bench_configs_torch.POSE, device=cuda)
    d_rot = torch.tensor([0.03, -0.02, 0.02], device=cuda,
                         requires_grad=True)
    d_col = (0.15 * torch.randn(colors.shape, generator=torch.Generator(
        cuda).manual_seed(2), device=cuda)).requires_grad_()
    opt = torch.optim.Adam([d_rot, d_col], lr=0.01)
    losses = []
    for _ in range(10):
        opt.zero_grad()
        image = dirt_tpu_torch.rasterise(
            background, bench_configs_torch.camera_clip(
                verts_obj, rot + d_rot, cuda),
            colors + d_col, faces, config=config, clip=False)
        loss = ((image - target) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]



@pytest.mark.cuda
def test_deferred_renders_and_the_flagship_trains_on_card(cuda):
    """The deferred pipeline at full width with its G-buffer, config 5
    (10,224 faces, 1024 x 1024, packed) and the flagship's scene (2,208
    faces, 256 x 256, dense): overflow clear, finite, black off the mesh,
    nine G-buffer channels; then 10 Adam steps of the flagship loss over
    vertices and pose, whose first loss is the step's and which falls."""
    config5 = bench_configs_torch.config5(cuda)
    obj, faces, uvs, texture, projection = entry.deferred_scene(device=cuda)
    pose = torch.tensor(bench_configs_torch.POSE, device=cuda)
    for render, leaves, size in (
            (config5.forward, config5.leaves, SIZE),
            (lambda v, p, **kw: entry.deferred_render(
                v, p, faces, uvs, texture, projection, 256, None, **kw),
             (obj, pose), 256)):
        with torch.no_grad():
            image, gbuffer = render(*leaves, with_gbuffer=True)
        covered = gbuffer["fid"] >= 0
        assert not bool(gbuffer["overflow"]) and covered.any()
        assert image.shape == (size, size, 3) and torch.isfinite(image).all()
        assert (image[~covered] == 0).all()
        assert sum(gbuffer[k].shape[-1]
                   for k in ("position", "normal", "uv", "mask")) == 9

    step_fn, (verts, pose) = entry.entry(cuda)
    first = float(step_fn(verts, pose))
    verts = verts.clone().requires_grad_()
    pose = pose.clone().requires_grad_()
    opt = torch.optim.Adam([verts, pose], lr=0.01)
    losses = []
    for _ in range(10):
        opt.zero_grad()
        loss = step_fn(verts, pose)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert abs(losses[0] - first) <= 1e-5 * first
    assert np.isfinite(losses).all() and losses[-1] < losses[0]

@pytest.mark.cuda
def test_default_api_streams_the_99904_face_sphere_on_card(cuda):
    """``suggest_raster_config`` picks the csr engine for the 99,904-face
    sphere (``big_sphere_step`` raises otherwise); its render stays clear
    of overflow, d_background is w off the mesh and 0 on it, and the
    packed engine under its own caps agrees: differing face ids at most
    1e-4 of the covered pixels, gradients within 1e-4 of max |gradient|.
    A two-triangle quad over every tile of 64 x 256 streams whole."""
    _, (bg, verts, colors), (faces, config) = \
        card_common.big_sphere_step(cuda)
    weights = card_common.rand(1, SIZE, SIZE, 3, device=cuda)
    packed = dirt_tpu_torch.suggest_raster_config(
        verts, faces, SIZE, SIZE,
        config=dirt_tpu_torch.RasterConfig(engine="packed"))
    runs = {}
    for engine, cfg in (("csr", config), ("packed", packed)):
        runs[engine] = card_common.render_grads(
            dirt_tpu_torch.rasterise_with_aux, bg, verts, colors, faces,
            weights, cfg, True)
    (pixels, fid, zbuf, overflow), (_, _, d_bg) = runs["csr"]
    hit = fid >= 0
    assert not bool(overflow) and not bool(runs["packed"][0][3])
    assert hit.any() and int(fid.max()) < faces.shape[0]
    assert ((zbuf[hit] >= -1) & (zbuf[hit] <= 1)).all()
    assert torch.equal(d_bg[~hit], weights[~hit]) and (d_bg[hit] == 0).all()
    covered = int(hit.sum())
    assert int((runs["packed"][0][1] != fid).sum()) <= \
        card_common.TOL_ENGINES * covered
    for g_s, g_p in zip(runs["csr"][1], runs["packed"][1]):
        assert card_common.rel_err(g_s, g_p) <= card_common.TOL_ENGINES

    from dirt_tpu_torch.core import mesh

    quad_v, quad_f = mesh.unit_quad()
    quad = dirt_tpu_torch.rasterise(
        None, torch.cat([torch.as_tensor(quad_v, device=cuda) * 2.0,
                         torch.ones((4, 1), device=cuda)], dim=1),
        torch.ones((4, 1), device=cuda),
        torch.as_tensor(quad_f.astype(np.int64), device=cuda),
        height=64, width=256, channels=1,
        config=dirt_tpu_torch.RasterConfig(streaming=True))
    assert float(quad.min()) > 0.99


@pytest.mark.cuda
def test_packed_and_csr_agree_on_the_1001112_face_sphere_on_card(cuda):
    """The 1,001,112-face sphere at 1024 x 1024, clip off, one step under
    the packed engine (``suggest_raster_config``'s pick) and one under the
    streaming engine, each under its own caps and launching its own
    kernels: overflow clear, gradients finite and nonzero, face ids equal,
    pixels within 3e-5 and gradients within 1e-4 of max |gradient|."""
    scene = _bench_scene(708)
    _, verts, colors, faces, background, weights = scene
    runs = {}
    for engine, fields, launches in (
            ("packed", {}, {"raster_fwd_packed": 1, "max_scan": 5,
                            "packed_prologue": 1, "packed_bwd": 1,
                            "setup_vjp": 1, "setup_fwd": 1}),
            ("csr", dict(streaming=True), {"raster_fwd_csr": 1,
                                           "packed_prologue": 1,
                                           "fused_bwd_csr": 1,
                                           "setup_vjp": 1, "setup_fwd": 1})):
        config = _bench_config(708, **fields)
        assert card_common.engine_of(config, faces.shape[0]) == engine
        runs[engine], counts = card_common.launched(
            lambda: card_common.render_grads(
                dirt_tpu_torch.rasterise_with_aux, background, verts, colors,
                faces, weights, config, False))
        assert counts == launches
        (_, _, _, overflow), grads = runs[engine]
        assert not bool(overflow)
        assert all(torch.isfinite(g).all() for g in grads)
        assert grads[0].abs().sum() > 0
    (pix_p, fid_p, _, _), grads_p = runs["packed"]
    (pix_c, fid_c, _, _), grads_c = runs["csr"]
    assert torch.equal(fid_p, fid_c)
    assert float((pix_p - pix_c).detach().abs().max()) <= 3e-5
    for g_c, g_p in zip(grads_c, grads_p):
        assert card_common.rel_err(g_c, g_p) <= card_common.TOL_ENGINES


def _entry_rows_equal_plain(prep, rows, c_lo, c_hi):
    """K2's rows of the chunk slice [c_lo, c_hi) equal its plain
    version's on the card bit for bit, but where the two differ by less
    than the smallest normal float (on the card the plain version's
    ``index_add_`` flushes subnormal sums to zero)."""
    plain = packed_bwd.packed_entry_rows_plain(
        prep, packed_bwd._entry_table(prep), c_lo, c_hi)
    differ = rows.view(torch.int32) != plain.view(torch.int32)
    tiny = torch.finfo(torch.float32).tiny
    return not bool((differ & ((rows - plain).abs() >= tiny)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("path,channels", [("1001112", 3), ("slabs", 3),
                                           ("slabs", 9)])
def test_packed_kernels_read_the_face_table_through_entries_on_card(
        cuda, path, channels):
    """K1 and K2 on what a packed gradient step hands them, each reading
    every budget row's face row from the forward's face table through its
    entry: the 1,001,112-face sphere at 1024 x 1024 (clip off; 9 channels
    at this size are the bench sphere's and config 5's cases above) and
    two slabs of the sharded packed path (flat-subtile fields in K2), at 3
    and 9 channels. K1's pixels, fid and zbuf equal its plain version's bit for
    bit; K2's rows equal its plain version's (see
    ``_entry_rows_equal_plain``) over the whole budget and over the chunk
    slices [0, k) and [k, n), which compose to the whole."""
    n_lat = 708 if path == "1001112" else 72
    _, verts, colors, faces, background, weights = _bench_scene(n_lat)
    if channels != 3:
        colors = card_common.rand(channels, verts.shape[0], channels,
                                  device=cuda)
        weights = card_common.rand(channels + 1, SIZE, SIZE, channels,
                                   device=cuda)
        background = torch.zeros((SIZE, SIZE, channels), device=cuda)
    if path == "slabs":
        def rasterise(bg, v, c, f, config, clip):
            return rasterise_sharded(bg, v, c, f, LocalGroup(2),
                                     config=config, with_aux=True)
    else:
        rasterise = dirt_tpu_torch.rasterise_with_aux
    outs, entry_calls = [], []

    def step():
        entry_calls.extend(card_common.calls(
            packed_bwd, "packed_entry_rows",
            lambda: outs.append(card_common.render_grads(
                rasterise, background, verts, colors, faces, weights,
                _bench_config(n_lat), False))))

    forward_calls = card_common.calls(raster_fwd, "raster_forward_packed",
                                      step)
    (_, _, _, overflow), grads = outs[0]
    assert not bool(overflow) and grads[0].abs().sum() > 0
    slabs = 2 if path == "slabs" else 1
    assert len(forward_calls) == len(entry_calls) == slabs
    for (table2, bins, bg_chw), geom in forward_calls:
        assert bins.table is table2
        assert table2.shape[0] == bins.pool_offs.shape[0]
        got = raster_fwd.raster_forward_packed(table2, bins, bg_chw, **geom)
        want = raster_fwd.raster_forward_packed_plain(table2, bins, bg_chw,
                                                      **geom)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert (got[1] >= 0).any()
    for (prep,), _ in entry_calls:
        assert prep.flat is (path == "slabs")
        n = prep.budget_chunks
        rows = packed_bwd.packed_entry_rows(prep)
        assert (rows != 0).any()
        assert _entry_rows_equal_plain(prep, rows, 0, n)
        k = n // 3
        tail = packed_bwd.packed_entry_rows(prep, k)
        assert _entry_rows_equal_plain(prep, tail, k, n)
        assert torch.equal(
            torch.cat([packed_bwd.packed_entry_rows(prep, 0, k), tail]), rows)


def _packed_grads(render):
    """``card_common.render_grads`` of the bench sphere under its packed
    caps through ``render(background, vertices, colors, faces, config)``."""
    _, verts, colors, faces, background, weights = _bench_scene()
    return card_common.render_grads(
        lambda bg, v, c, f, config, clip: render(bg, v, c, f, config),
        background, verts, colors, faces, weights, _bench_config(), False)


@pytest.mark.cuda
@pytest.mark.parametrize("slabs,chunks", [(1, 1), (1, 2), (1, 4), (4, 1),
                                          (4, 2), (4, 4)])
def test_overlapped_backward_on_card(cuda, slabs, chunks):
    """``rasterise_sharded(overlap_chunks=k)`` on the bench sphere under
    its packed caps: K1 and K4 once a slab, K2 and the setup VJP once a
    slab and chunk, no other kernel; every K2 launch on a chunk slice
    bit-equal to its plain version on the slice (values below the
    smallest normal float apart: on the card the plain version's
    ``index_add_`` flushes those), each slab's slices tiling its budget
    and, concatenated, equal to one launch over all of it; image and face
    ids equal to the non-overlapped render's, gradients within 1e-5 of max
    |gradient| of it and of the single device's."""
    def sharded(k):
        return lambda bg, v, c, f, config: rasterise_sharded(
            bg, v, c, f, LocalGroup(slabs), config=config, overlap_chunks=k,
            with_aux=True)

    (pix_s, fid_s, _, _), grads_s = _packed_grads(sharded(None))
    grads_1 = _packed_grads(
        lambda bg, v, c, f, config: dirt_tpu_torch.rasterise_with_aux(
            bg, v, c, f, config=config, clip=False))[1]
    calls, rows_fn = [], packed_bwd.packed_entry_rows

    def capture(prep, c_lo=0, c_hi=None):
        rows = rows_fn(prep, c_lo, c_hi)
        calls.append((prep, c_lo, prep.budget_chunks if c_hi is None
                      else c_hi, rows))
        return rows

    with mock.patch.object(packed_bwd, "packed_entry_rows", capture):
        ((pix_o, fid_o, _, overflow), grads_o), counts = card_common.launched(
            lambda: _packed_grads(sharded(chunks)))
    assert counts == {"raster_fwd_packed": slabs, "max_scan": 5 * slabs,
                      "subtile_swap": slabs, "packed_bwd": slabs * chunks,
                      "setup_vjp": slabs * chunks, "setup_fwd": slabs}
    assert not bool(overflow)
    assert torch.equal(fid_o, fid_s) and torch.equal(pix_o, pix_s)
    for g, g_s, g_1 in zip(grads_o, grads_s, grads_1):
        assert card_common.rel_err(g, g_s) <= 1e-5
        assert card_common.rel_err(g, g_1) <= 1e-5
    by_prep = {}
    for prep, c_lo, c_hi, rows in calls:
        by_prep.setdefault(id(prep), (prep, []))[1].append((c_lo, c_hi, rows))
    assert len(by_prep) == slabs and len(calls) == slabs * chunks
    tiny = torch.finfo(torch.float32).tiny
    for prep, slices in by_prep.values():
        table = packed_bwd._entry_table(prep)
        for c_lo, c_hi, rows in slices:
            plain = packed_bwd.packed_entry_rows_plain(prep, table, c_lo,
                                                       c_hi)
            differ = rows.view(torch.int32) != plain.view(torch.int32)
            assert not (differ & ((rows - plain).abs() >= tiny)).any()
        bounds = [c for c_lo, c_hi, _ in slices for c in (c_lo, c_hi)]
        assert bounds[0] == 0 and bounds[-1] == prep.budget_chunks
        assert bounds[1:-1:2] == bounds[2::2]
        assert torch.equal(torch.cat([rows for *_, rows in slices]),
                           rows_fn(prep))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bench dense", "99904 packed"])
def test_face_sharded_renderer_on_card(cuda, case):
    """``rasterise_face_sharded`` over four local members, dense on the
    bench sphere and packed on the 99,904-face sphere (clip off), against
    the single device under the same caps: the members' forward kernel and
    the setup VJP once a member and no other kernel, overflow clear, face
    ids equal, pixels within 3e-5, gradients within 1e-4 of max
    |gradient|."""
    from dirt_tpu_torch.parallel.face_sharding import rasterise_face_sharded

    if case == "bench dense":
        n, fields, launches = 72, dict(engine="dense"), {
            "raster_fwd_dense": 4}
    else:
        n, fields, launches = 224, dict(engine="packed"), {
            "raster_fwd_packed": 4, "max_scan": 20}
    _, verts, colors, faces, background, weights = _bench_scene(n)
    config = _bench_config(n, **fields)

    def single(bg, v, c, f, config, clip):
        return dirt_tpu_torch.rasterise_with_aux(bg, v, c, f, config=config,
                                                 clip=False)

    def members(bg, v, c, f, config, clip):
        return rasterise_face_sharded(bg, v, c, f, LocalGroup(4),
                                      config=config, with_aux=True)

    (pix_1, fid_1, _, ovf_1), grads_1 = card_common.render_grads(
        single, background, verts, colors, faces, weights, config, False)
    ((pix_4, fid_4, _, ovf_4), grads_4), counts = card_common.launched(
        lambda: card_common.render_grads(members, background, verts, colors,
                                         faces, weights, config, False))
    assert counts == {**launches, "setup_vjp": 4, "setup_fwd": 4}
    assert not bool(ovf_1) and not bool(ovf_4)
    assert torch.equal(fid_4, fid_1)
    assert float((pix_4 - pix_1).detach().abs().max()) <= 3e-5
    for g_4, g_1 in zip(grads_4, grads_1):
        assert torch.isfinite(g_4).all()
        assert card_common.rel_err(g_4, g_1) <= card_common.TOL_ENGINES


# The row-sharded cases at full size: (sphere's n, caps' fields). The
# bench sphere on each engine, and the 99,904-face sphere streamed.
_SHARDED_SCENES = {"bench dense": (72, dict(engine="dense")),
                   "bench csr": (72, dict(streaming=True)),
                   "bench packed": (72, dict(engine="packed")),
                   "99904 csr": (224, dict(streaming=True))}


def _sharded(slabs):
    """``rasterise_sharded`` over ``slabs`` local slabs, as
    ``card_common.render_grads`` calls a renderer."""
    return lambda bg, v, c, f, config, clip: rasterise_sharded(
        bg, v, c, f, LocalGroup(slabs), config=config, with_aux=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_SHARDED_SCENES))
def test_sharded_renderer_at_full_size_on_card(cuda, case):
    """``rasterise_sharded`` with one and four local slabs at 1024 x 1024
    (clip off) against the single device under the same caps: each slab
    launches the engine's forward kernel, its sharded backward's reduction
    (the scatter kernel, or the layout swap and the packed backward) and
    the setup VJP once, and no other kernel (a packed slab's binning its
    five scans); overflow clear, face ids equal, pixels within 3e-5,
    gradients finite, nonzero and within 1e-4 of max |gradient|. The
    four-slab step against the same step with every kernel replaced by its
    plain version: face ids equal, pixels within the forward's tolerance,
    gradients within 1e-5."""
    n, fields = _SHARDED_SCENES[case]
    engine = case.split()[-1]
    _, verts, colors, faces, background, weights = _bench_scene(n)
    config = _bench_config(n, **fields)
    assert card_common.engine_of(config, faces.shape[0]) == engine

    def step(render):
        return card_common.render_grads(render, background, verts, colors,
                                        faces, weights, config, False)

    (pix_1, fid_1, _, ovf_1), grads_1 = step(dirt_tpu_torch.rasterise_with_aux)
    assert not bool(ovf_1) and (fid_1 >= 0).any()
    for slabs in (1, 4):
        ((pix_n, fid_n, _, ovf_n), grads_n), counts = card_common.launched(
            lambda: step(_sharded(slabs)))
        want = {"dense": {"raster_fwd_dense": slabs, "scatter_faces": slabs},
                "csr": {"raster_fwd_csr": slabs, "scatter_faces_csr": slabs},
                "packed": {"raster_fwd_packed": slabs, "max_scan": 5 * slabs,
                           "subtile_swap": slabs, "packed_bwd": slabs}}
        # The dense and streaming slabs' backwards set their planes up
        # again, one row down.
        assert counts == {**want[engine], "setup_vjp": slabs,
                          "setup_fwd": slabs * (1 if engine == "packed"
                                                else 2)}
        assert not bool(ovf_n)
        assert torch.equal(fid_n, fid_1)
        assert float((pix_n - pix_1).detach().abs().max()) <= 3e-5
        for g_n, g_1 in zip(grads_n, grads_1):
            assert torch.isfinite(g_n).all()
            assert card_common.rel_err(g_n, g_1) <= card_common.TOL_ENGINES
        assert all(g.abs().sum() > 0 for g in grads_n[:2])
    with _plain_kernels():
        ((pix_p, fid_p, _, _), grads_p), counts = card_common.launched(
            lambda: step(_sharded(4)))
    assert counts == {}
    assert torch.equal(fid_p, fid_n)
    torch.testing.assert_close(pix_p.detach(), pix_n.detach(), **TOL)
    for g_n, g_p in zip(grads_n, grads_p):
        assert card_common.rel_err(g_n, g_p) <= 1e-5


def _one_slab_step(n, channels, fields):
    """One step of ``rasterise_sharded`` over one local slab at 1024 x 1024
    (clip off), as a thunk: the sphere of ``n`` under its caps with
    ``fields``, the bench's colors and upstream gradient at 3 channels,
    random ones at ``channels`` otherwise."""
    _, verts, colors, faces, background, weights = _bench_scene(n)
    if channels != 3:
        colors = card_common.rand(channels, verts.shape[0], channels,
                                  device="cuda")
        background = torch.zeros((SIZE, SIZE, channels), device="cuda")
        weights = card_common.rand(channels + 1, SIZE, SIZE, channels,
                                   device="cuda")
    return lambda: card_common.render_grads(
        _sharded(1), background, verts, colors, faces, weights,
        _bench_config(n, **fields), False)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ("dense", 72, 3), ("dense", 72, 9), ("dense", 72, 16), ("csr", 72, 3),
    ("csr", 72, 9), ("csr", 72, 16), ("csr", 224, 3)], ids=_case_id)
def test_scatter_kernels_on_a_slabs_inputs_on_card(cuda, case):
    """K9 (dense) or K10 (csr) on the cotangent planes, owners, lists and
    boxes a row-sharded slab's backward hands it at 1024 x 1024: the bench
    sphere at 3, 9 and 16 channels, the 99,904-face sphere at 3. Rows
    within 1e-5 of the column's largest magnitude plus 1e-6 of the plain
    version, value by value within 1e-5 of the sum of the magnitudes it
    adds up, nonzero, and equal on a second run."""
    engine, n, channels = case
    fields, name, kernel = {
        "dense": (dict(engine="dense"), "scatter_to_faces", "scatter_faces"),
        "csr": (dict(streaming=True), "scatter_to_faces_csr",
                "scatter_faces_csr")}[engine]
    ((args, kwargs),) = card_common.calls(
        scatter, name, _one_slab_step(n, channels, fields))
    cot, fid_p, *_, num_rows = args
    assert cot.shape[0] == 12 + 3 * channels
    plain = getattr(scatter, name + "_plain")
    before = _launches(kernel)
    rows_k = getattr(scatter, name)(*args, **kwargs)
    torch.cuda.synchronize()
    assert _launches(kernel) == before + 1
    _check_scatter_rows(
        rows_k, plain(cot, fid_p, num_rows),
        lambda: getattr(scatter, name)(*args, **kwargs),
        plain(cot.abs(), fid_p, num_rows))


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [3, 9, 16])
def test_swap_kernel_on_a_slabs_inputs_on_card(cuda, channels):
    """K4 on the five fields a packed slab's halo backward hands it (the
    bench sphere at 1024 x 1024, 3, 9 and 16 channels): equal bit for bit
    to its plain version, some words moved, swapped back equal to its
    inputs; the backward got the swapped fields, and K2 on them gives the
    rows it gives on the same fields in image layout, bit for bit and
    nonzero."""
    run = _one_slab_step(72, channels, dict(engine="packed"))
    rows_calls = []
    ((arrays,), _), = card_common.calls(
        raster_fwd, "flat_subtile_swap", lambda: rows_calls.extend(
            card_common.calls(packed_bwd, "packed_entry_rows", run)))
    ((prep, *_), _), = rows_calls
    before = _launches("subtile_swap")
    got = raster_fwd.flat_subtile_swap(arrays)
    torch.cuda.synchronize()
    assert _launches("subtile_swap") == before + 1
    moved = 0
    for a, g in zip(arrays, got):
        want = raster_fwd.flat_subtile_swap_plain(a)
        assert torch.equal(g.view(torch.int32), want.view(torch.int32))
        moved += int((g.view(torch.int32) != a.view(torch.int32)).sum())
    assert moved > 0
    for g, again in zip(got, raster_fwd.flat_subtile_swap(arrays)):
        assert torch.equal(g.view(torch.int32), again.view(torch.int32))
    for a, b in zip(arrays, raster_fwd.flat_subtile_swap(got)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert prep.flat and torch.equal(prep.fid_p, got[0])
    fid, bits, pix_cf, grad_cf, sval = arrays
    image = packed_bwd._PackedBwdPrep(
        fid, bits, sval, pix_cf, grad_cf, prep.bins, prep.geo, prep.att,
        prep.channels, prep.k_cols, prep.tile_h, prep.tile_w)
    rows = packed_bwd.packed_entry_rows(prep)
    assert torch.equal(rows, packed_bwd.packed_entry_rows(image))
    assert (rows != 0).any()


@pytest.mark.cuda
def test_one_rank_nccl_group_matches_local_group_on_card(cuda, tmp_path):
    """One step of the row-sharded (dense), the overlapped (packed, two
    chunks) and the face-sharded (packed) renderer on the bench sphere
    through a ``torch.distributed`` group of one rank over NCCL, eager and
    as a CUDA-graph replay (the capture takes NCCL's collectives), against
    the same step over ``LocalGroup(1)``: gradients within 1e-5 of max
    |gradient|. One NCCL group a process: this test forms the only one."""
    from dirt_tpu_torch.parallel.face_sharding import rasterise_face_sharded
    from dirt_tpu_torch.parallel.group import DistGroup
    from dirt_tpu_torch.utils.graphstep import GraphedStep

    _, verts, colors, faces, background, weights = _bench_scene()
    leaves = (background, verts, colors)
    configs = {"sharded dense": _bench_config(engine="dense"),
               "overlap": _bench_config(), "face-sharded": _bench_config()}

    def step(path, group):
        config = configs[path]

        def render(bg, v, c):
            if path == "face-sharded":
                return rasterise_face_sharded(bg, v, c, faces, group,
                                              config=config, with_aux=True)
            return rasterise_sharded(
                bg, v, c, faces, group, config=config, with_aux=True,
                overlap_chunks=2 if path == "overlap" else None)

        def run(bg, v, c):
            bg, v, c = (t.detach().requires_grad_() for t in (bg, v, c))
            pixels = render(bg, v, c)[0]
            return torch.autograd.grad((pixels * weights).sum(), (v, c, bg))

        return run

    want = {path: step(path, LocalGroup(1))(*leaves) for path in configs}
    torch.distributed.init_process_group(
        "nccl", init_method=f"file://{tmp_path}/store", rank=0, world_size=1,
        device_id=cuda)
    try:
        for path in configs:
            eager = step(path, DistGroup())
            graphed = GraphedStep(eager, leaves)
            for got in (eager(*leaves), graphed(*leaves)):
                for g, w in zip(got, want[path]):
                    assert card_common.rel_err(g, w) <= 1e-5, path
        torch.cuda.synchronize()
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_configstore_keeps_and_replaces_caps_on_card(cuda, tmp_path):
    """A RasterConfig through ``utils.configstore`` on the bench sphere:
    equal after the round trip, kept by ``cached_config`` after one
    overflow-checked render on the card, and a stale entry (caps of 1)
    replaced by caps that do not overflow."""
    from dirt_tpu_torch.utils import configstore

    _, verts, _, faces, _, _ = _bench_scene()
    config = _bench_config()
    store = tmp_path / "configs_torch.json"
    configstore.save_config("bench", config, store)
    assert configstore.load_config("bench", store) == config
    assert configstore.cached_config("bench", verts, faces, SIZE, SIZE,
                                     path=store) == config
    stale = config._replace(bin_cap=1, expand_cap=1)
    configstore.save_config("bench", stale, store)
    fresh = configstore.cached_config("bench", verts, faces, SIZE, SIZE,
                                      path=store)
    assert fresh != stale and configstore.load_config("bench", store) == fresh
    assert not configstore.overflows(verts, faces, SIZE, SIZE, fresh)


@pytest.mark.cuda
def test_obj_mesh_renders_on_card_as_the_plain_path(cuda, tmp_path):
    """A 1,472-face UV sphere written as OBJ, loaded by the native parser
    (equal to the Python one) and rendered at 1024 x 1024 by the packed
    engine on the card: face ids and depths equal to the plain path's,
    pixels within 1e-6."""
    from dirt_tpu_torch.core import mesh
    from dirt_tpu_torch.io import objloader

    verts, tris, uvs = (np.asarray(a) for a in mesh.uv_sphere(n_lat=24,
                                                              n_lon=32))
    path = tmp_path / "sphere.obj"
    path.write_text("\n".join(
        [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
        + [f"vt {u:.6f} {v:.6f}" for u, v in uvs]
        + [f"f {a}/{a} {b}/{b} {c}/{c}" for a, b, c in tris + 1]) + "\n")
    loaded = objloader.load_obj(str(path), native=True)
    python = objloader.load_obj(str(path), native=False)
    assert loaded.has_uv and np.array_equal(loaded.faces, python.faces)
    np.testing.assert_allclose(loaded.vertices, python.vertices, atol=1e-6)
    v_obj, uv_obj, _, f_obj = loaded.to_tensors(cuda)
    clip = bench_configs_torch.posed(v_obj, cuda)
    colors = torch.cat([uv_obj, 0.5 + 0.5 * v_obj[:, :1]], dim=1)
    config = dirt_tpu_torch.suggest_raster_config(
        clip, f_obj, SIZE, SIZE,
        config=dirt_tpu_torch.RasterConfig(engine="packed"), clip=False)
    background = torch.zeros((SIZE, SIZE, 3), device=cuda)

    def render():
        return dirt_tpu_torch.rasterise_with_aux(
            background, clip, colors, f_obj, config=config, clip=False)

    (pixels, fid, zbuf, overflow), counts = card_common.launched(render)
    assert counts == {"raster_fwd_packed": 1, "max_scan": 5, "setup_fwd": 1}
    with _plain_kernels():
        pix_p, fid_p, z_p, _ = render()
    assert not bool(overflow) and (fid >= 0).any()
    assert torch.equal(fid, fid_p) and torch.equal(zbuf, z_p)
    torch.testing.assert_close(pixels, pix_p, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["torch_demo1_square", "torch_demo2_cube"])
def test_demo_render_main_on_card(cuda, tmp_path, name):
    """Demos 1 and 2 through ``main``: the dense forward alone launched,
    face ids and image equal to the same render with every kernel
    replaced by its plain version."""
    module = _demo(name)
    (image, fid), counts = card_common.launched(
        lambda: module.main(cuda, str(tmp_path)))
    assert set(counts) == {"raster_fwd_dense", "setup_fwd"}
    with _plain_kernels():
        image_p, fid_p = module.render(cuda)
    assert torch.equal(fid, fid_p) and torch.equal(image, image_p)


# Demos 3-5 as their ``main`` runs them: (arguments, the kernels of one of
# its loop's steps). Demo 3 trains the texture alone, so no gradient
# reaches the raster op.
_DEMO_FITS = {
    "torch_demo3_textured": (dict(size=512, steps=60),
                             {"raster_fwd_dense": 1, "setup_fwd": 1}),
    "torch_demo4_lit": (dict(size=512, steps=80),
                        {"raster_fwd_dense": 1, "packed_prologue": 1,
                         "fused_bwd": 1, "setup_vjp": 1, "setup_fwd": 1}),
    "torch_demo5_deferred": (dict(size=SIZE, steps=80, n_lat=72, n_lon=72),
                             {"raster_fwd_packed": 1, "max_scan": 5,
                              "packed_prologue": 1, "packed_bwd": 1,
                              "setup_vjp": 1, "setup_fwd": 1}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_DEMO_FITS))
def test_demo_fit_main_on_card(cuda, tmp_path, name):
    """Demos 3-5 through ``main`` (which raises unless the loss falls by
    the demo's own ratio), the loop's launches counted: each kernel of a
    step ``WARMUP + 1`` times in ``trainer`` (the capture's warm-up calls
    and the captured one) and none in ``run``, whose steps are graph
    replays; demo 5's checkpoint loads back equal."""
    from dirt_tpu_torch.utils.checkpoint import load_pytree
    from dirt_tpu_torch.utils.graphstep import WARMUP

    module = _demo(name)
    kwargs, launches = _DEMO_FITS[name]
    counted = {}

    def counting(fn_name):
        inner = getattr(module, fn_name)

        def wrapper(*args):
            torch.cuda.synchronize()
            result, counted[fn_name] = card_common.launched(
                lambda: inner(*args))
            return result

        return mock.patch.object(module, fn_name, wrapper)

    with counting("trainer"), counting("run"):
        result = module.main(device=cuda, out=str(tmp_path), **kwargs)
    assert counted == {"trainer": {k: (WARMUP + 1) * n
                                   for k, n in launches.items()},
                       "run": {}}
    assert result["l1"] < result["l0"]
    if name == "torch_demo5_deferred":
        restored = load_pytree(result["checkpoint"])
        assert sorted(restored) == ["m", "params", "step", "v"]
        assert int(restored["step"]) == result["steps"]
        assert np.array_equal(restored["params"]["pose"],
                              result["pose"].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n_lat", [72, 708], ids=["10224", "1001112"])
def test_profilers_time_the_work_the_api_does_on_card(cuda, n_lat):
    """The stage tool's staged forward (setup, binning, K1) gives pixels,
    face ids and depths equal bit for bit to ``rasterise_with_aux``'s, its
    backward pieces (K3, K2, the pool reduce) the output of
    ``backward_packed``, and ``_stage=0`` the bins of a call without it,
    field by field; on the bench sphere the stage, binning and parallel
    tools' ``run`` goes through on the card (one sample a line, no
    profiler window: the trace tests read a replay's markers from a
    profile later in the same process, and one such profile taken after
    these windows lost its first record)."""
    import prof_torch_binning
    import prof_torch_parallel
    import prof_torch_stages

    scene = _bench_scene(n_lat)
    _, verts, colors, faces, background, weights = scene
    config = _bench_config(n_lat)
    pixels, fid, zbuf, geo, att, bins, geom = \
        prof_torch_stages.staged_forward(scene, config)
    want = dirt_tpu_torch.rasterise_with_aux(background, verts, colors,
                                             faces, config=config, clip=False)
    assert not bool(want[3])
    for got, ref in zip((pixels, fid, zbuf), want):
        assert torch.equal(got, ref)
    for got, ref in zip(
            prof_torch_stages.staged_backward(geo, att, fid, zbuf, pixels,
                                              weights, bins, geom),
            prof_torch_stages.backward_core(geo, att, fid, zbuf, pixels,
                                            weights, bins, geom)):
        assert torch.equal(got, ref)
    _, _, bbox, edges = card_common.setup(verts, colors, faces, SIZE)
    plain = card_common.bin_faces(bbox, edges, geom)
    zero = card_common.bin_faces(bbox, edges, geom, _stage=0)
    for field in binning.PackedBins._fields:
        a, b = getattr(plain, field), getattr(zero, field)
        assert (a is None) == (b is None), field
        assert a is None or torch.equal(a, b), field
    if n_lat == 72:
        prof_torch_stages.run(cuda, SIZE, n_lat, 1, config, 0)
        record = prof_torch_binning.run(cuda, SIZE, n_lat, 1, config, 0)
        assert len(record["cummax"]) == 5
        prof_torch_parallel.run(cuda, SIZE, n_lat, 1, config, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", _build.KERNELS)
def test_every_kernel_builds_on_card(cuda, name):
    """Every library of ``csrc/`` builds (one nvcc each, started together)
    and loads; ptxas reports its registers."""
    _build.build(_build.KERNELS)
    assert _build.load(name)
    assert "registers" in _build.build_log(name)


def test_the_kernel_list_is_the_sources_of_csrc():
    """Each source of ``_build.KERNELS`` has a C entry point, and the
    ``__global__`` names that the tools match in a profile are those the
    benchmark's trace counts as the port's."""
    from benchmark import trace as bench_trace

    assert "packed_prologue" in _build.KERNELS
    for name in _build.KERNELS:
        assert 'extern "C"' in (_build.CSRC_DIR / f"{name}.cu").read_text()
    assert _build.global_names() == bench_trace.program_kernels()
    assert "packed_prologue_kernel" in _build.global_names()
