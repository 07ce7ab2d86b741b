"""dirt_tpu_torch.ops.packed_bwd.padded_prologue (plain version of K3 with
the padding and layout copies taken in) vs dirt_tpu.

The port's call reads the unpadded [H, W] fields and writes the padded
fields, the boundary-pair bits and sval in one pass, as the TPU kernel
(``dirt_tpu.ops.packed_bwd.fused_neighbor_prologue``) does after the JAX
backward pads its inputs. On the CPU the wrapper takes its plain version;
the JAX kernel runs in interpret mode, as the JAX package's own tests run
it, and its flat-subtile outputs are taken back to image layout with
``flat_subtile_swap`` (its own inverse). Tolerances, each with its reason:

* padded fid, padded pixels, padded gradient and bits: equal (copies and
  integer tests);
* sval: allclose(rtol=1e-6, atol=1e-6) against JAX (the same expressions
  in the same order; XLA's CPU code may round a step otherwise), equal
  bit for bit between the port's own paths;
* gradients of the three engines' backwards: equal bit for bit to the
  same backward with the fields padded by copies before the prologue, as
  the port did before the prologue took the copies in.
"""

import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_scene import screen_soup
from dirt_tpu.ops import packed_bwd as jp
from dirt_tpu.ops import raster_fwd as jf
from dirt_tpu_torch.ops import packed_bwd as tp
from dirt_tpu_torch.ops import raster as tr
from dirt_tpu_torch.ops.raster_fwd import BIG_Z

TOL = dict(rtol=1e-6, atol=1e-6)
TILE_H, TILE_W = 32, 128


def _fields(height, width, channels, seed, levels=None):
    """Unpadded fid [H, W] int32, depth [H, W] (BIG_Z off the faces; with
    ``levels``, quantised to that many values, so that many neighbour
    pairs tie), pixels and gradient [H, W, C], as numpy."""
    rng = np.random.RandomState(seed)
    fid = rng.randint(-1, 9, (height, width)).astype(np.int32)
    z = rng.uniform(-1.0, 1.0, (height, width))
    if levels:
        z = np.round(z * levels) / levels
    z = np.where(fid < 0, BIG_Z, z).astype(np.float32)
    pixels = rng.rand(height, width, channels).astype(np.float32)
    grad = rng.randn(height, width, channels).astype(np.float32)
    return fid, z, pixels, grad


@functools.lru_cache(maxsize=None)
def _jax_padded(height, width, channels, seed, levels=None):
    """JAX's backward inputs: the fields padded as its prepare pads them,
    then its prologue kernel, taken back to image layout."""
    fid, z, pixels, grad = _fields(height, width, channels, seed, levels)
    hp = -(-height // TILE_H) * TILE_H
    wp = -(-width // TILE_W) * TILE_W
    pad2 = ((0, hp - height), (0, wp - width))
    args = (np.pad(fid, pad2, constant_values=-2),
            np.pad(z, pad2, constant_values=BIG_Z),
            np.pad(pixels.transpose(2, 0, 1), ((0, 0),) + pad2),
            np.pad(grad.transpose(2, 0, 1), ((0, 0),) + pad2))
    outs = jp.fused_neighbor_prologue(*(jnp.asarray(a) for a in args),
                                      interpret=True)
    fid_f, bits_f, pix_f, grad_f, sval_f = (
        np.asarray(jf.flat_subtile_swap(o)) for o in outs)
    return fid_f, bits_f, sval_f, pix_f, grad_f


def _port(height, width, channels, seed, levels=None):
    fid, z, pixels, grad = (torch.tensor(a) for a in _fields(
        height, width, channels, seed, levels))
    return tp.padded_prologue(fid, z, pixels, grad, TILE_H, TILE_W)


@pytest.mark.parametrize("height,width", [(37, 131), (100, 130)])
@pytest.mark.parametrize("channels", [1, 3, 9])
def test_padded_prologue_matches_jax(height, width, channels):
    got = _port(height, width, channels, seed=channels)
    want = _jax_padded(height, width, channels, seed=channels)
    names = ("fid_p", "bits", "sval", "pix_cf", "grad_cf")
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == w.shape, name
        if name == "sval":
            np.testing.assert_allclose(g.numpy(), w, **TOL)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    fid_p, bits = got[0].numpy(), got[1].numpy()
    assert fid_p.shape == (-(-height // TILE_H) * TILE_H, 256)
    assert (fid_p[height:] == -2).all() and (fid_p[:, width:] == -2).all()
    assert (bits[:height, :width] != 0).mean() > 0.3


def _tie_rule(fid_p, z_p):
    """The bit plane from its definition, pixel by pixel: bit n set where
    the n-th neighbour (right, left, below, above) has another face id,
    is not outside the padded image (-2), and lies behind the pixel,
    strictly for right / below, or at the same depth for left / above."""
    hp, wp = fid_p.shape
    bits = np.zeros((hp, wp), np.int32)
    for n, (dy, dx, strict) in enumerate(((0, 1, True), (0, -1, False),
                                          (1, 0, True), (-1, 0, False))):
        for y in range(hp):
            for x in range(wp):
                ny, nx = y + dy, x + dx
                inside = 0 <= ny < hp and 0 <= nx < wp
                nf = fid_p[ny, nx] if inside else -2
                nz = z_p[ny, nx] if inside else BIG_Z
                front = z_p[y, x] < nz if strict else z_p[y, x] <= nz
                if nf != fid_p[y, x] and nf != -2 and front:
                    bits[y, x] |= 1 << n
    return bits


def test_quantised_depths_keep_the_tie_rule():
    """Depths on a grid of 9 values: about a tenth of the neighbour pairs
    tie, and a tie sets the bit of the left / upper pixel of the pair
    only."""
    height, width, channels = 37, 131, 3
    fid, z, _, _ = _fields(height, width, channels, seed=11, levels=4)
    got = _port(height, width, channels, seed=11, levels=4)
    hp, wp = got[0].shape
    z_p = np.full((hp, wp), BIG_Z, np.float32)
    z_p[:height, :width] = z
    fid_p = got[0].numpy()
    ties = ((fid_p[:, 1:] != fid_p[:, :-1]) & (fid_p[:, 1:] >= 0)
            & (fid_p[:, :-1] >= 0) & (z_p[:, 1:] == z_p[:, :-1]))
    assert ties.sum() > 0.05 * height * width
    np.testing.assert_array_equal(got[1].numpy(), _tie_rule(fid_p, z_p))
    want = _jax_padded(height, width, channels, seed=11, levels=4)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[2].numpy(), want[2], **TOL)


def test_strided_inputs_give_the_contiguous_outputs():
    """The forward's pixels as the backward gets them (a permuted, cropped
    view of a [C, Hp, Wp] array), a contiguous [H, W, C] gradient, and a
    float64 gradient (converted), against contiguous float32 inputs."""
    height, width, channels = 37, 131, 3
    fid, z, pixels, grad = (torch.tensor(a) for a in _fields(
        height, width, channels, seed=5))
    want = tp.padded_prologue(fid, z, pixels.contiguous(), grad, TILE_H,
                              TILE_W)
    chw = torch.zeros((channels, 64, 256))
    chw[:, :height, :width] = pixels.permute(2, 0, 1)
    fid_big = torch.full((64, 256), -1, dtype=torch.int32)
    fid_big[:height, :width] = fid
    z_big = torch.full((64, 256), BIG_Z)
    z_big[:height, :width] = z
    view = chw.permute(1, 2, 0)[:height, :width]
    assert not view.is_contiguous()
    for args in ((fid_big[:height, :width], z_big[:height, :width], view,
                  grad),
                 (fid, z, pixels, grad.double()),
                 (fid, z, view, grad.permute(2, 0, 1).contiguous()
                  .permute(1, 2, 0))):
        got = tp.padded_prologue(*args, TILE_H, TILE_W)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.is_contiguous()
            assert torch.equal(g, w)


def _copy_then_prologue(fid, zbuf, pixels, grad_pixels, tile_h, tile_w):
    """The backward's fields as the port made them before the prologue
    took the copies in: padded by torch copies, then the prologue on the
    padded arrays."""
    fid_p, zbuf_p, pix_cf, grad_cf = tp.pad_fields(
        fid, zbuf, pixels, grad_pixels, tile_h, tile_w)
    bits, sval = tp.fused_neighbor_prologue_plain(fid_p, zbuf_p, pix_cf,
                                                  grad_cf)
    return fid_p, bits, sval, pix_cf, grad_cf


@pytest.mark.parametrize("engine", ["packed", "dense", "csr"])
def test_backwards_give_the_gradients_of_the_copies(engine):
    """backward_packed, backward_fused and backward_fused_csr (through the
    raster op's autograd) give, bit for bit, the gradients of the same
    backward with the fields padded by copies first; each goes through the
    prologue once."""
    height, width, channels = 100, 130, 3
    fv, fa = screen_soup(90, height, width, seed=3, channels=channels,
                         spread=25.0)
    rng = np.random.RandomState(4)
    bg = rng.rand(height, width, channels).astype(np.float32)
    gp = torch.tensor(rng.randn(height, width, channels).astype(np.float32))
    fields = {"packed": dict(engine="packed"),
              "dense": dict(engine="dense", bin_cap=64),
              "csr": dict(streaming=True)}[engine]
    config = tr.RasterConfig(tile_h=TILE_H, tile_w=TILE_W, **fields)
    if engine == "packed":
        config = tr.suggest_config(torch.tensor(fv), height, width, config)
        config = config._replace(budget=2 * config.budget)

    def grads():
        leaves = [torch.tensor(a, requires_grad=True) for a in (fv, fa, bg)]
        pixels, _, _, overflow = tr.rasterize_screen(*leaves, config)
        assert not bool(overflow)
        (pixels * gp).sum().backward()
        return [leaf.grad for leaf in leaves]

    calls = []

    def counted(*args):
        calls.append(args)
        return tp.padded_prologue_plain(*args)

    with mock.patch.object(tp, "padded_prologue", counted):
        new = grads()
    with mock.patch.object(tp, "padded_prologue", _copy_then_prologue):
        old = grads()
    assert len(calls) == 1 and tuple(calls[0][0].shape) == (height, width)
    for g_new, g_old in zip(new, old):
        assert torch.equal(g_new, g_old)
    assert new[0].abs().max() > 0
