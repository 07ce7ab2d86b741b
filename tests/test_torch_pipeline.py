"""End to end: dirt_tpu_torch.rasterise_with_aux vs dirt_tpu's, packed engine
(the dense engine's end-to-end checks are in tests/test_torch_dense.py).

Scenes: the bench camera on a small UV sphere at 128x128 (entirely in
front of the camera), and the same sphere moved so close that faces cross
the near plane (clipping does real work). Caps come from each package's
own ``suggest_raster_config`` and must be equal.

Tolerance (the razor-edge policy of tests/test_sharding.py): fid equal
except on at most 0.5% of pixels, where an f32 edge test lands within
rounding of zero and XLA's fused arithmetic may round differently; where
fids agree, pixels and zbuf within 1e-5 absolute. The overflow flag is
equal.
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

RAZOR = 0.005
ATOL = 1e-5
_DISTANCE = {"sphere": 3.0, "crossing": 0.9}


@functools.lru_cache(maxsize=None)
def _scene(kind):
    clip, colors, faces = sphere_scene(distance=_DISTANCE[kind])
    bg = np.random.RandomState(4).rand(SIZE, SIZE, 3).astype(np.float32)
    return bg, clip, colors, faces


@functools.lru_cache(maxsize=None)
def _configs(kind, clip):
    _, verts, _, faces = _scene(kind)
    want = dirt_tpu.suggest_raster_config(
        verts, faces, SIZE, SIZE, config=JaxConfig(engine="packed"),
        clip=clip)
    got = dirt_tpu_torch.suggest_raster_config(
        torch.tensor(verts), torch.tensor(faces), SIZE, SIZE,
        config=RasterConfig(engine="packed"), clip=clip)
    return want, got


def _render_both(kind, clip, jax_config, torch_config):
    bg, verts, colors, faces = _scene(kind)
    out_j = dirt_tpu.rasterise_with_aux(bg, verts, colors, faces,
                                        config=jax_config, clip=clip)
    out_t = dirt_tpu_torch.rasterise_with_aux(
        *convert.scene_from_numpy(bg, verts, colors, faces, "cpu"),
        config=torch_config, clip=clip)
    return [np.asarray(o) for o in out_j], [o.numpy() for o in out_t]


_CASES = [("sphere", False), ("sphere", True), ("crossing", True),
          ("crossing", False)]


@pytest.mark.parametrize("kind,clip", _CASES)
def test_suggest_raster_config_matches(kind, clip):
    want, got = _configs(kind, clip)
    assert got == convert.config_from_jax(want)


@pytest.mark.parametrize("kind,clip", _CASES)
def test_rasterise_with_aux_matches(kind, clip):
    want, got = _configs(kind, clip)
    (pix_j, fid_j, z_j, ovf_j), (pix_t, fid_t, z_t, ovf_t) = _render_both(
        kind, clip, want, got)
    assert pix_t.shape == (SIZE, SIZE, 3) and fid_t.dtype == np.int32
    assert bool(ovf_t) is bool(ovf_j) is False
    differ = fid_t != fid_j
    assert differ.mean() <= RAZOR, f"{differ.mean():.4%} fids differ"
    agree = ~differ
    np.testing.assert_allclose(pix_t[agree], pix_j[agree], rtol=0, atol=ATOL)
    np.testing.assert_allclose(z_t[agree], z_j[agree], rtol=0, atol=ATOL)
    covered = fid_t >= 0
    assert covered.mean() > 0.2
    if kind == "crossing":
        # Remapped ids name original faces.
        assert fid_t.max() < _scene(kind)[3].shape[0]


def test_undersized_caps_raise_the_flag_in_both():
    want, got = _configs("crossing", True)
    small = dict(expand_cap=2, clip_cap=1)
    (_, _, _, ovf_j), (_, _, _, ovf_t) = _render_both(
        "crossing", True, want._replace(**small), got._replace(**small))
    assert bool(ovf_j) and bool(ovf_t)


def test_rasterise_matches_aux_and_default_background():
    bg, verts, colors, faces = _scene("sphere")
    _, cfg = _configs("sphere", False)
    pix_aux = dirt_tpu_torch.rasterise_with_aux(
        np.zeros_like(bg), verts, colors, faces, config=cfg, clip=False)[0]
    pix = dirt_tpu_torch.rasterise(None, verts, colors, faces, height=SIZE,
                                   width=SIZE, channels=3, config=cfg,
                                   clip=False)
    assert torch.equal(pix, pix_aux)
    with pytest.raises(ValueError, match="height, width and channels"):
        dirt_tpu_torch.rasterise(None, verts, colors, faces)


@pytest.mark.parametrize("config", [
    RasterConfig(engine="csr"),
    RasterConfig(streaming=True),
])
def test_unported_engines_raise(config):
    bg, verts, colors, faces = _scene("sphere")
    with pytest.raises(NotImplementedError, match="later PR"):
        dirt_tpu_torch.rasterise_with_aux(bg, verts, colors, faces,
                                          config=config, clip=False)
