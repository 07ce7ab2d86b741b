"""The row-sharded renderer of dirt_tpu_torch on the CPU: local groups.

``LocalGroup(n)`` renders the n slabs in one process, as the JAX package's
tests run its mesh on virtual CPU devices. The scene is
``tests/test_sharding.py``'s (24 random faces over a random background at
128 x 128) under its caps, on all three engines. The sharded render is held
against the port's own single-device ``rasterise`` (``clip=False``: the
sharded path does not clip), with ``tests/test_sharding.py``'s tolerances:
image atol 3e-5 (slabs evaluate the planes at slab-local row offsets);
gradients to vertices, colors and background rtol = atol = 1e-4.
``tests/test_torch_sharding_jax.py`` holds the same path against
``dirt_tpu.parallel.sharding`` itself, ``tests/test_torch_distributed.py``
runs it over gloo processes.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dirt_tpu_torch
from _torch_port_scene import SHARDING_CAPS, sharding_scene
from dirt_tpu_torch import RasterConfig
from dirt_tpu_torch.parallel.group import LocalGroup
from dirt_tpu_torch.parallel.sharding import rasterise_sharded, slab_render

REPO = Path(__file__).resolve().parents[1]
ENGINES = list(SHARDING_CAPS)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _config(engine):
    return RasterConfig(**SHARDING_CAPS[engine])


def _step(render, scene):
    """(image, [d_vertices, d_colors, d_background]) of
    ``0.5 * sum(render(background, vertices, colors) ** 2)``."""
    verts, colors, _, bg = scene
    leaves = [t.clone().requires_grad_() for t in (verts, colors, bg)]
    image = render(leaves[2], leaves[0], leaves[1])
    (0.5 * (image ** 2).sum()).backward()
    return image.detach(), [t.grad for t in leaves]


def _tensors(arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_forward_matches_single_device(engine, n):
    verts, colors, faces, bg = _tensors(sharding_scene(0))
    config = _config(engine)
    want = dirt_tpu_torch.rasterise_with_aux(bg, verts, colors, faces,
                                             config=config, clip=False)
    got = rasterise_sharded(bg, verts, colors, faces, LocalGroup(n),
                            config=config, with_aux=True)
    assert got[0].shape == (128, 128, 3)
    torch.testing.assert_close(got[0], want[0], atol=3e-5, rtol=0)
    assert torch.equal(got[1], want[1])             # fid
    torch.testing.assert_close(got[2], want[2], atol=3e-5, rtol=0)
    assert not bool(got[3]) and not bool(want[3])
    assert (want[1] >= 0).any() and (want[1] < 0).any()


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_gradients_match_single_device(engine, n):
    """Includes cross-slab silhouette pairs: the halo rows must reproduce
    the single-device boundary gradients."""
    scene = _tensors(sharding_scene(3))
    faces, config = scene[2], _config(engine)
    _, want = _step(lambda b, v, c: dirt_tpu_torch.rasterise(
        b, v, c, faces, config=config, clip=False), scene)
    _, got = _step(lambda b, v, c: rasterise_sharded(
        b, v, c, faces, LocalGroup(n), config=config), scene)
    for g, w, name in zip(got, want, ("verts", "colors", "bg")):
        torch.testing.assert_close(g, w, msg=lambda m: f"{name}: {m}",
                                   **GRAD_TOL)
    assert want[0].abs().max() > 0


def _square_scene():
    """One bright quad on a dark background whose bottom edge lies between
    rows 63 and 64: with two 64-row slabs the silhouette pairs along it
    cross the slab boundary (front pixel in slab 0, back pixel in slab 1),
    and nothing of the quad lies in slab 1."""
    verts = np.array([[-0.5, 0.0, 0.0, 1.0], [0.5, 0.0, 0.0, 1.0],
                      [0.5, 0.7, 0.0, 1.0], [-0.5, 0.7, 0.0, 1.0]],
                     np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    colors = np.ones((4, 3), np.float32)
    bg = np.full((128, 128, 3), 0.2, np.float32)
    return _tensors((verts, colors, faces, bg))


@pytest.mark.parametrize("engine", ENGINES)
def test_silhouette_across_a_slab_boundary_needs_the_halo(engine):
    scene = _square_scene()
    faces, config = scene[2], _config(engine)
    image, want = _step(lambda b, v, c: dirt_tpu_torch.rasterise(
        b, v, c, faces, config=config, clip=False), scene)
    assert (image[63, 40:90] == 1).all() and (image[64] < 1).all()
    _, got = _step(lambda b, v, c: rasterise_sharded(
        b, v, c, faces, LocalGroup(2), config=config), scene)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **GRAD_TOL)

    # Two slabs rendered apart (each a group of its own: sentinel halos at
    # row 64) lose the pairs along the quad's bottom edge: the y gradient of
    # the two bottom vertices.
    def apart(b, v, c):
        return torch.cat([
            slab_render(b[s * 64:(s + 1) * 64], v, c, faces, 128, 128,
                        _OneSlab(s), config) for s in range(2)])

    _, blind = _step(apart, scene)
    assert want[0][:2, 1].abs().min() > 1.0
    assert (blind[0][:2, 1].abs() < 0.1 * want[0][:2, 1].abs()).all()


class _OneSlab(LocalGroup):
    """Slab ``index`` of the image with no neighbours."""

    def __init__(self, index):
        super().__init__(1)
        self.index = index

    @property
    def local(self):
        return (self.index,)


@pytest.mark.parametrize("engine", ENGINES)
def test_slab_render_with_slabs_past_the_image_height(engine):
    """Four 32-row slabs over a 120-row image: the last slab's rows 120..127
    are padding, and take no part in the boundary pairs."""
    verts, colors, faces, bg = _tensors(sharding_scene(4, height=120))
    verts[:, :2] *= 1.3                 # faces reach past the image's edges
    scene = (verts, colors, faces, bg)
    config = _config(engine)
    image, want = _step(lambda b, v, c: dirt_tpu_torch.rasterise(
        b, v, c, faces, config=config, clip=False), scene)

    def sharded(b, v, c):
        rows = torch.cat([b, b.new_zeros((8, 128, 3))])
        return slab_render(rows, v, c, faces, 120, 128, LocalGroup(4),
                           config)[:120]

    got_image, got = _step(sharded, scene)
    torch.testing.assert_close(got_image, image, atol=3e-5, rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **GRAD_TOL)
    assert (image[119] != bg[119]).any()        # the mesh reaches the edge


def test_slab_render_six_channel_gbuffer():
    verts, _, faces, _ = _tensors(sharding_scene(7))
    attrs = torch.tensor(np.random.RandomState(8).rand(30, 6)
                         .astype(np.float32))
    bg = torch.zeros((128, 128, 6))
    config = _config("packed")
    scene = (verts, attrs, faces, bg)
    image, want = _step(lambda b, v, c: dirt_tpu_torch.rasterise(
        b, v, c, faces, config=config, clip=False), scene)
    got_image, got = _step(lambda b, v, c: slab_render(
        b, v, c, faces, 128, 128, LocalGroup(4), config), scene)
    assert got_image.shape == (128, 128, 6)
    torch.testing.assert_close(got_image, image, atol=3e-5, rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **GRAD_TOL)


def test_background_only_gradient_needs_no_halo():
    verts, colors, faces, bg = _tensors(sharding_scene(0))
    bg.requires_grad_()
    image, fid, _, _ = rasterise_sharded(bg, verts, colors, faces,
                                         LocalGroup(4),
                                         config=_config("dense"),
                                         with_aux=True)
    weights = torch.rand(128, 128, 3)
    (image * weights).sum().backward()
    assert torch.equal(bg.grad, torch.where((fid >= 0)[..., None], 0.0,
                                            weights))


def test_rasterise_sharded_rejects_bad_arguments():
    verts, colors, faces, bg = _tensors(sharding_scene(0))
    with pytest.raises(ValueError, match=r"divisible by devices\*tile_h"):
        rasterise_sharded(bg, verts, colors, faces, LocalGroup(3),
                          config=_config("dense"))
    with pytest.raises(ValueError, match="requires the packed engine"):
        rasterise_sharded(bg, verts, colors, faces, LocalGroup(2),
                          config=_config("dense"), overlap_chunks=2)
    with pytest.raises(ValueError, match="do not split"):
        slab_render(bg[:127], verts, colors, faces, 128, 128, LocalGroup(2))
    with pytest.raises(ValueError, match="at least one slab"):
        LocalGroup(0)


def test_default_config_resolves_tile_height_from_the_slab():
    verts, colors, faces, bg = _tensors(sharding_scene(0))
    want = dirt_tpu_torch.rasterise(bg, verts, colors, faces, clip=False)
    got = rasterise_sharded(bg, verts, colors, faces, LocalGroup(2))
    torch.testing.assert_close(got, want, atol=3e-5, rtol=0)


# --- the port stands without jax ------------------------------------------------


def _port_sources():
    """Every file of the port: the package, the sheet, the demos and the
    card tools with the module they share."""
    tools = ("card_common", "prof_torch_steps", "prof_torch_stages",
             "prof_torch_binning", "prof_torch_parallel", "prof_torch_repeat",
             "bench_scatter", "bench_raster_ab")
    return (sorted((REPO / "dirt_tpu_torch").rglob("*.py"))
            + sorted((REPO / "demos").glob("torch_demo*.py"))
            + [REPO / "bench_configs_torch.py"]
            + [REPO / "tools" / f"{name}.py" for name in tools])


def test_no_port_source_imports_jax_or_the_jax_package():
    assert len(_port_sources()) >= 55
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "dirt_tpu"), (path, name)


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, dirt_tpu_torch\n"
        "sys.path.insert(0, 'tools')\n"
        "import card_common, prof_torch_stages, prof_torch_binning\n"
        "import prof_torch_parallel\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "dirt_tpu_torch.__path__, 'dirt_tpu_torch.')]\n"
        "assert 'dirt_tpu_torch.parallel.sharding' in names, names\n"
        "for name in names: importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dirt_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
