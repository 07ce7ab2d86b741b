"""The boxes the backward kernels scan, on needle-thin faces, on the CPU.

The fused backwards (``csrc/fused_bwd.cu``, ``csrc/fused_bwd_csr.cu``) and
the face scatters (``csrc/scatter_faces.cu``, ``csrc/scatter_faces_csr.cu``)
sum a list entry's pixels over a box of the face clipped to its tile, so a
pixel its owner's box leaves out is dropped from the face gradients. The
box must hold every pixel the face owns. The boxes binning made from the
face's corners (``bins.bbox``) do not: a needle whose far corners lie 1e3
to 1e6 pixels off the image owns, by float32 rounding, pixels past them
(``tests/test_torch_cull.py``). So the op hands the kernels the forward's
cull boxes (``bins.cull``, ``raster_fwd.csr_cull_boxes``), which bound every
pixel where a face can pass the edge tests.

These tests run the op on the needle scenes of ``tests/test_torch_cull.py``
through the dense and the streaming engine and the row-sharded renderer,
record what the backward hands the kernel wrappers (on the CPU the wrappers
take their plain versions, which read no box), and check that every covered
pixel lies inside the box handed for its owner. They need no card and no
JAX. (Against ``dirt_tpu`` these scenes do not hold: XLA rounds the
needles' edge values otherwise than PyTorch's CPU kernels, and the two
disagree on the owner of 26 to 42 of the ~100 covered pixels of each
far-needle scene, so the kernels are held against the port's plain
versions on the card, ``tests/test_torch_cuda.py``.)
"""

import functools
from unittest import mock

import pytest
import torch

from dirt_tpu_torch.ops import fused_bwd, raster, scatter
from dirt_tpu_torch.parallel.group import LocalGroup
from dirt_tpu_torch.parallel.sharding import rasterise_sharded
from test_torch_cull import _scene

NEEDLES = ["needles-0", "needles-1", "far-needles-0", "far-needles-1",
           "far-needles-5"]
FAR = NEEDLES[2:]
# The engine's config on a needle scene: the scene's tiles and caps.
ENGINES = {
    "dense": dict(engine="dense", streaming=False),
    "csr": dict(streaming=True),
}
WRAPPERS = {"dense": "fused_backward_rows", "csr": "fused_backward_rows_csr"}


def _config(name, engine):
    fv, fa, bg, config = _scene(name)
    return fv, fa, bg, config._replace(**ENGINES[engine])


def _recorded(module, names, run):
    """Run ``run()`` with the wrappers ``names`` of ``module`` recording the
    keyword arguments of each call; returns [(args, kwargs)]."""
    seen = []
    patches = []
    for name in names:
        inner = getattr(module, name)

        def record(*args, inner=inner, **kwargs):
            seen.append((args, kwargs))
            return inner(*args, **kwargs)

        patches.append(mock.patch.object(module, name, record))
    for patch in patches:
        patch.start()
    try:
        run()
    finally:
        for patch in patches:
            patch.stop()
    return seen


@functools.lru_cache(maxsize=None)
def _handed(name, engine):
    """(fid [H, W] of the forward, the ``bbox`` and ``cull`` boxes the op's
    backward hands the fused kernel's wrapper) on one needle scene."""
    fv, fa, bg, config = _config(name, engine)
    leaves = [fv.clone().requires_grad_(), fa.clone().requires_grad_()]
    out = []

    def run():
        out.extend(raster.rasterize_screen(*leaves, bg, config))
        (out[0] * torch.rand(out[0].shape, generator=torch.Generator()
                             .manual_seed(3))).sum().backward()

    ((_, kwargs),) = _recorded(fused_bwd, [WRAPPERS[engine]], run)
    assert not bool(out[3])
    return out[1], kwargs["bbox"], kwargs["cull"]


def _outside(fid, boxes, margin=0):
    """Covered pixels of ``fid`` outside their owner's box, grown by
    ``margin`` pixels on each side."""
    ys, xs = torch.nonzero(fid >= 0, as_tuple=True)
    box = boxes.long()[fid[ys, xs].long()]
    return int(((xs < box[:, 0] - margin) | (xs > box[:, 1] + margin)
                | (ys < box[:, 2] - margin) | (ys > box[:, 3] + margin))
               .sum())


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("name", NEEDLES)
def test_every_covered_pixel_lies_in_the_box_handed_for_its_owner(name,
                                                                  engine):
    fid, bbox, cull = _handed(name, engine)
    assert int((fid >= 0).sum()) > 50
    assert cull.dtype == torch.int32 and cull.shape[0] > bbox.shape[0]
    assert _outside(fid, cull) == 0


@pytest.mark.parametrize("name", FAR)
def test_binning_boxes_miss_pixels_far_needles_own(name):
    """Why the op hands the kernels the cull boxes: on these scenes the
    streaming forward draws pixels outside their owner's binning box grown
    by the one pixel the fused kernels scanned past it."""
    fid, bbox, _ = _handed(name, "csr")
    assert _outside(fid, bbox, margin=1) > 0


def _clip_scene(name):
    """One needle scene as clip-space vertices (w = 1, three a face) for
    the row-sharded renderer: (background, vertices, colors, faces,
    config)."""
    fv, fa, bg, config = _scene(name)
    height, width, _ = bg.shape
    xs, ys = fv[..., 0].double(), fv[..., 1].double()
    verts = torch.stack([2.0 * xs / width - 1.0, 1.0 - 2.0 * ys / height,
                         fv[..., 2].double(), torch.ones_like(xs)], -1)
    faces = torch.arange(3 * fv.shape[0]).reshape(-1, 3)
    return (bg, verts.float().reshape(-1, 4), fa.reshape(-1, fa.shape[-1]),
            faces, config)


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("name", FAR)
def test_sharded_slabs_hand_the_scatter_boxes_in_their_own_rows(name,
                                                                engine):
    """Two slabs of 64 rows: each slab's backward hands the scatter wrapper
    the owners of its own rows (halo rows cut off) and the cull boxes of
    its own forward's table, in those rows' coordinates."""
    bg, verts, colors, faces, config = _clip_scene(name)
    config = config._replace(**ENGINES[engine])
    wrapper = {"dense": "scatter_to_faces",
               "csr": "scatter_to_faces_csr"}[engine]
    leaves = [verts.clone().requires_grad_(), colors.clone().requires_grad_()]

    def run():
        pixels, _, _, overflow = rasterise_sharded(
            bg, leaves[0], leaves[1], faces, LocalGroup(2), config=config,
            with_aux=True)
        assert not bool(overflow)
        pixels.sum().backward()

    calls = _recorded(scatter, [wrapper], run)
    assert len(calls) == 2
    covered = 0
    for args, kwargs in calls:
        fid_p = args[1]
        assert fid_p.shape[0] == bg.shape[0] // 2
        covered += int((fid_p >= 0).sum())
        assert _outside(fid_p, kwargs["cull"]) == 0
    assert covered > 50
