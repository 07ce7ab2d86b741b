"""The compiled step (``dirt_tpu_torch.utils.graphstep``) and the glue it needs.

1. A capture-safety scan. A CUDA graph refuses a copy between host and
   card inside its capture, and a read of a card value on the host. So
   one fwd+bwd step of each path the port graphs (the packed, dense and
   CSR engines through ``rasterise_with_aux`` with ``clip`` off and on,
   ``entry()``'s flagship step, and one step of demo 5's loss) runs here
   under a ``TorchDispatchMode`` that records every operator that reads a
   tensor's value on the host (``aten._local_scalar_dense``: ``.item()``,
   ``int()``, ``bool()``), that sizes its output by the data (``nonzero``,
   ``masked_select``, ``unique``, ``bincount``, ``repeat_interleave``
   without an output size, indexing with a boolean mask), or that makes a
   tensor from Python data (``aten.lift_fresh``: ``torch.tensor([...])``,
   and also a Python number assigned by indexing, ``t[0, 4] = -1.0``; on
   the card both are copies from pageable host memory, which the capture
   refused on the H100). Frames inside a function named ``*_plain`` are
   exempt: the plain versions run only on the CPU. None may be
   recorded. The glue rewritten for the capture is held bit for bit to
   its earlier form.
2. ``GraphedStep`` on the CPU, where it calls its function: bit-equal to
   the direct call, new results for new inputs; and its bookkeeping with
   the capture replaced by a stand-in: one graph per signature (shapes,
   dtypes, devices, the values of non-tensor arguments), a failed capture
   raised with no eager call in its place.
   Since the parallel paths are graphed too, the scan also covers one
   step of the row-sharded renderer (dense, CSR, packed; four local
   slabs), the overlapped one (k = 2), the face-sharded one (four
   members), the dry run's training loss, demos 3 and 4 and configs 1-5
   of the sheet; and the parallel glue rewritten for the capture is held
   bit for bit to its earlier form.
3. The bench step (``bench.py``'s ``sum(image * w)`` gradient, here at
   128 x 128 on the small sphere) through ``GraphedStep`` against
   ``jax.jit(jax.value_and_grad(...))`` of ``dirt_tpu``'s on the packed,
   dense and CSR engines, with the tolerances and razor-edge policy of
   ``tests/test_torch_raster_bwd.py`` (one JAX compile per engine, cached
   with ``lru_cache``). Demo 5's ``fit``, which now runs its steps through
   ``GraphedStep``, keeps its trajectory against ``dirt_tpu``'s in
   ``tests/test_torch_demos.py``; here, that it makes one ``GraphedStep``
   and calls it once a step with the bump rate switched at the midpoint;
   demos 3 and 4 likewise, with the plain descent's losses bit for bit.
4. On the card (``cuda`` marker, skipped here): graphed against eager on
   the three engines, the flagship step, demo 5's fit, the sharded,
   overlapped and face-sharded steps, the dry run, demos 3 and 4 and the
   sheet's five configs (fid, overflow
   and pixels equal, gradients within 1e-5 of max |gradient| of the eager
   step's; the demo fits' losses and parameters within 1e-4, two eager
   fits of demos 4 and 5 equal bit for bit), a second replay
   with other inputs against eager on those, and a capture that fails
   raising.
"""

import functools
import importlib.util
import traceback
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import dirt_tpu
import dirt_tpu_torch
from _torch_port_oracle import (jax_planes, oracle_vertex_grads, port_slots,
                                vertex_keep)
from _torch_port_scene import SIZE, sphere_scene
from dirt_tpu.ops.raster import RasterConfig as JaxConfig
from dirt_tpu_torch import convert, entry
from dirt_tpu_torch.ops import raster_fwd
from dirt_tpu_torch.ops.raster import RasterConfig
from dirt_tpu_torch.utils import graphstep
from dirt_tpu_torch.utils.graphstep import GraphedStep, value_and_grad

DEMOS = Path(__file__).resolve().parents[1] / "demos"
RAZOR = 0.005
# Graphed against eager on the card: the same kernels in the same order,
# but autograd's scatter-adds (the vertex gather's backward) sum with
# atomics.
TOL_GRAD = 1e-5
TOL_DEFERRED = 1e-4
ENGINES = {"packed": dict(engine="packed"), "dense": dict(engine="dense"),
           "csr": dict(streaming=True)}


def _demo(n):
    name = {3: "torch_demo3_textured", 4: "torch_demo4_lit",
            5: "torch_demo5_deferred"}[n]
    spec = importlib.util.spec_from_file_location(f"_graphstep_demo{n}",
                                                  DEMOS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _demo5():
    return _demo(5)


def _rel_err(got, want):
    """max |got - want| / max |want| (the difference itself where want is
    0, as a background gradient is when the mesh covers the image)."""
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    return diff / scale if scale else diff


# --- 1. the capture-safety scan ---------------------------------------------

_SIZED_BY_DATA = {"nonzero", "masked_select", "unique", "_unique",
                  "_unique2", "unique_consecutive", "unique_dim", "bincount"}


class _HostScan(TorchDispatchMode):
    """Records the operators a CUDA-graph capture refuses, with the
    port's frames that called them."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.__name__.split(".")[0]
        refused = (
            name == "_local_scalar_dense"
            or name in _SIZED_BY_DATA
            or name == "lift_fresh"
            or (name == "repeat_interleave"
                and kwargs.get("output_size") is None)
            or (name == "index" and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1] if i is not None)))
        if refused:
            frames = traceback.extract_stack()
            if not any(f.name.endswith("_plain") for f in frames):
                self.found.append((name, [
                    f"{Path(f.filename).name}:{f.lineno} {f.name}"
                    for f in frames if "dirt_tpu_torch" in f.filename
                    or "demos" in f.filename
                    or "bench_configs_torch" in f.filename][-4:]))
        return out


def _api_step(engine, clip):
    """One fwd+bwd of ``rasterise_with_aux`` on the small sphere at SIZE
    (so close with ``clip`` that faces cross the near plane), under the
    engine's own ``suggest_raster_config`` caps, which count on the host
    before the step."""
    verts, colors, faces = sphere_scene(distance=0.9 if clip else 3.0)
    bg, verts, colors, faces = convert.scene_from_numpy(
        np.zeros((SIZE, SIZE, 3), np.float32), verts, colors, faces, "cpu")
    weights = torch.rand(SIZE, SIZE, 3,
                         generator=torch.Generator().manual_seed(1))
    config = dirt_tpu_torch.suggest_raster_config(
        verts, faces, SIZE, SIZE, config=RasterConfig(**ENGINES[engine]),
        clip=clip)

    def step():
        v = verts.clone().requires_grad_()
        c = colors.clone().requires_grad_()
        pixels = dirt_tpu_torch.rasterise_with_aux(
            bg, v, c, faces, config=config, clip=clip)[0]
        (pixels * weights).sum().backward()

    return step


def _flagship_step():
    forward_step, args = entry.entry("cpu", size=64, n_lat=8, n_lon=12)
    return lambda: value_and_grad(forward_step)(*args)


def _demo5_step():
    loss_fn, params = _demo5().problem(64, 12, 12, "cpu")[:2]
    return lambda: value_and_grad(loss_fn)(*params.values())


def _parallel_step(path, engine):
    """One fwd+bwd of ``sum(image * w)`` through a parallel renderer on the
    small sphere at SIZE over a local group: "sharded" (four slabs),
    "overlap" (``overlap_chunks=2``, four slabs) or "face-sharded" (four
    members), under the engine's ``suggest_raster_config`` caps with
    8-row tiles."""
    from dirt_tpu_torch.parallel.face_sharding import rasterise_face_sharded
    from dirt_tpu_torch.parallel.group import LocalGroup
    from dirt_tpu_torch.parallel.sharding import rasterise_sharded

    verts, colors, faces = sphere_scene()
    bg, verts, colors, faces = convert.scene_from_numpy(
        np.zeros((SIZE, SIZE, 3), np.float32), verts, colors, faces, "cpu")
    weights = torch.rand(SIZE, SIZE, 3,
                         generator=torch.Generator().manual_seed(1))
    config = dirt_tpu_torch.suggest_raster_config(
        verts, faces, SIZE, SIZE,
        config=RasterConfig(tile_h=8, **ENGINES[engine]), clip=False)
    render = {
        "sharded": lambda b, v, c: rasterise_sharded(
            b, v, c, faces, LocalGroup(4), config=config),
        "overlap": lambda b, v, c: rasterise_sharded(
            b, v, c, faces, LocalGroup(4), config=config, overlap_chunks=2),
        "face-sharded": lambda b, v, c: rasterise_face_sharded(
            b, v, c, faces, LocalGroup(4), config=config),
    }[path]
    loss = value_and_grad(lambda b, v, c: (render(b, v, c) * weights).sum())
    return lambda: loss(bg, verts, colors)


def _dryrun_step():
    """The dry run's data x tiles training loss and its gradient over four
    local slabs (the Adam update is torch's, capturable on the card)."""
    loss_fn, args, _ = entry.dryrun_train_loss(4, "cpu")
    return lambda: value_and_grad(loss_fn)(*args)


def _demo_step(n):
    loss_fn, params = _demo(n).problem(64, "cpu")[:2]
    return lambda: value_and_grad(loss_fn)(*params.values())


def _config_step(n):
    import bench_configs_torch

    make = bench_configs_torch.CONFIGS[n - 1]
    config = (make("cpu", 64, 12, 12) if n == 5 else make("cpu"))
    return lambda: value_and_grad(config.loss)(*config.leaves)


_SCAN_CASES = {
    **{f"{engine} clip={clip}": functools.partial(_api_step, engine, clip)
       for engine in ENGINES for clip in (False, True)},
    "flagship": _flagship_step,
    "demo5": _demo5_step,
    **{f"sharded {engine}": functools.partial(_parallel_step, "sharded",
                                              engine)
       for engine in ENGINES},
    "overlap packed k=2": functools.partial(_parallel_step, "overlap",
                                            "packed"),
    "face-sharded dense": functools.partial(_parallel_step, "face-sharded",
                                            "dense"),
    "dryrun train step": _dryrun_step,
    "demo3": functools.partial(_demo_step, 3),
    "demo4": functools.partial(_demo_step, 4),
    **{f"config{n}": functools.partial(_config_step, n)
       for n in range(1, 6)},
}


@pytest.mark.parametrize("case", list(_SCAN_CASES))
def test_step_is_capture_safe(case):
    step = _SCAN_CASES[case]()
    step()                              # first calls may build caches
    with _HostScan() as scan:
        step()
    assert not scan.found, "\n".join(
        f"{name} at {' <- '.join(reversed(where))}"
        for name, where in scan.found)


def _anchor_by_index(geo, att, d_geo, d_att):
    """``raster_bwd.anchor_cotangents`` as it was written before the
    capture: an index tensor of the five planes' ``a`` columns."""
    from dirt_tpu_torch.ops.triangle_setup import (GEO_AX, GEO_AY, GEO_DEN,
                                                   GEO_EDGE, GEO_Z)
    a_cols = torch.tensor([GEO_EDGE, GEO_EDGE + 3, GEO_EDGE + 6, GEO_Z,
                           GEO_DEN])
    d_c0 = d_geo[:, a_cols + 2]
    d_ax = -torch.sum(geo[:, a_cols] * d_c0, dim=1)
    d_ay = -torch.sum(geo[:, a_cols + 1] * d_c0, dim=1)
    d_ax = d_ax - torch.sum(att[:, 0::3] * d_att[:, 2::3], dim=1)
    d_ay = d_ay - torch.sum(att[:, 1::3] * d_att[:, 2::3], dim=1)
    out = d_geo.clone()
    out[:, GEO_AX] = d_ax
    out[:, GEO_AY] = d_ay
    return out


def _table_by_assignment(pack, geo, att):
    """A face table with its sentinel written by assignment, as before the
    capture: the rows from the sentinel on rewritten in place."""
    from dirt_tpu_torch.ops.raster_fwd import COL_ID

    table = pack(geo, att).clone()
    sentinel = torch.zeros_like(table[geo.shape[0]:])
    sentinel[:, 4] = -1.0
    sentinel[:, 7] = -1.0
    sentinel[:, 10] = -1.0
    sentinel[:, 16] = 1.0
    if pack is raster_fwd.pack_face_table_v2:
        sentinel[:, COL_ID] = float(geo.shape[0])
    table[geo.shape[0]:] = sentinel
    return table


@pytest.mark.parametrize("channels", [1, 3, 9])
def test_capture_safe_glue_is_bit_equal(channels):
    """The glue rewritten for the capture gives the bits it gave before:
    the anchor cotangents from strided slices, the face tables' sentinel
    rows from ``fill_``."""
    from dirt_tpu_torch.ops import raster_bwd

    gen = torch.Generator().manual_seed(channels)
    for faces in (1, 7, 5000):
        geo = torch.randn(faces, 24, generator=gen) * 100
        att = torch.randn(faces, 3 * channels, generator=gen)
        d_geo = torch.randn(faces, 24, generator=gen)
        d_att = torch.randn(faces, 3 * channels, generator=gen)
        assert torch.equal(
            raster_bwd.anchor_cotangents(geo, att, d_geo, d_att),
            _anchor_by_index(geo, att, d_geo, d_att))
        for pack in (raster_fwd.pack_face_table,
                     raster_fwd.pack_face_table_v2):
            assert torch.equal(pack(geo, att),
                               _table_by_assignment(pack, geo, att))


def _shift_rows_by_offset(face_verts, rows):
    """``sharding._shift_rows`` as it was before the capture: an offset
    tensor made from Python data."""
    return face_verts - face_verts.new_tensor([0.0, float(rows), 0.0, 0.0])


def _slab_rows_by_repeat(slabs, slab_h):
    """The image rows of the held slabs in ``_SlabOp.backward`` as they
    were made before the capture: the slabs' first rows from a list."""
    first = torch.as_tensor([s * slab_h for s in slabs]).repeat_interleave(
        slab_h)
    return first + torch.arange(slab_h).repeat(len(slabs))


def _shift_by_tensor(arr, axis, offset, fill):
    """``raster_bwd._shift`` as it was before the capture: the fill as a
    0-dim tensor made from the Python value."""
    rolled = torch.roll(arr, -offset, dims=axis)
    idx = torch.arange(arr.shape[axis])
    valid = (idx + offset >= 0) & (idx + offset <= arr.shape[axis] - 1)
    shape = [1] * arr.ndim
    shape[axis] = arr.shape[axis]
    return torch.where(valid.reshape(shape), rolled,
                       torch.as_tensor(fill, dtype=arr.dtype))


@pytest.mark.parametrize("seed", [0, 1])
def test_capture_safe_parallel_glue_is_bit_equal(seed):
    """The parallel renderers' glue rewritten for the capture gives the bits
    it gave before: faces shifted into a slab's rows (column 1 alone, no
    offset tensor; values from the scenes' range and beyond, negative
    zeros included), the held slabs' image rows, the halo's own-rows mask
    (``fill_`` on a slice, not a Python bool assigned by indexing) and the
    neighbour shifts' fill (a Python scalar, not a 0-dim tensor)."""
    from dirt_tpu_torch.ops import raster, raster_bwd
    from dirt_tpu_torch.parallel import sharding

    gen = torch.Generator().manual_seed(seed)
    fv = torch.randn(300, 3, 4, generator=gen) * 10.0 ** torch.randint(
        -3, 6, (300, 3, 4), generator=gen)
    fv[::7] = -0.0
    for rows in (0, 1, 7, 256, 768, 4095):
        assert torch.equal(sharding._shift_rows(fv, rows),
                           _shift_rows_by_offset(fv, rows))
        assert torch.equal(
            sharding._shift_rows(fv, rows).view(torch.int32),
            _shift_rows_by_offset(fv, rows).view(torch.int32))
    # chain_through_setup's move one row down: the earlier form added 0.0
    # to x, z and invw, which keeps every value but turns -0.0 into 0.0.
    no_neg_zero = fv + 0.0
    assert torch.equal(
        raster.move_rows(no_neg_zero, 1.0).view(torch.int32),
        (no_neg_zero + no_neg_zero.new_tensor([0.0, 1.0, 0.0, 0.0]))
        .view(torch.int32))
    for slabs, slab_h in ((range(4), 256), (range(1), 64), ((2,), 32),
                          (range(8), 8)):
        rows = torch.cat([torch.arange(s * slab_h, (s + 1) * slab_h)
                          for s in slabs])
        assert torch.equal(rows, _slab_rows_by_repeat(slabs, slab_h))
    mask = torch.zeros((34, 128), dtype=torch.bool)
    mask[1:-1].fill_(True)
    want = torch.zeros((34, 128), dtype=torch.bool)
    want[1:-1] = True
    assert torch.equal(mask, want)
    fid = torch.randint(-2, 50, (33, 130), generator=gen, dtype=torch.int32)
    zbuf = torch.randn(33, 130, generator=gen)
    for arr, fill in ((fid, -2), (zbuf, raster_bwd.BIG_Z), (zbuf, 0.0)):
        for axis, offset in ((0, 1), (0, -1), (1, 1), (1, -1)):
            got = raster_bwd._shift(arr, axis, offset, fill)
            assert got.dtype == arr.dtype
            assert torch.equal(got, _shift_by_tensor(arr, axis, offset,
                                                     fill))


def test_scan_finds_a_host_read_and_a_copy():
    x = torch.arange(4.0)
    with _HostScan() as scan:
        int(x.sum())
        torch.tensor([1.0, 2.0])
        x[0] = 3.0
        x[x > 1]
        x[1:2].fill_(3.0)
        torch.where(x > 1, x, 0.0)
    assert [name for name, _ in scan.found] == [
        "_local_scalar_dense", "lift_fresh", "lift_fresh", "index"]


# --- 2. GraphedStep on the CPU ------------------------------------------------


def test_graphed_step_on_the_cpu_is_the_call():
    fn = value_and_grad(lambda v, c: (v * c[:, :1]).sum() ** 2)
    gen = torch.Generator().manual_seed(0)
    v, c = torch.randn(50, 4, generator=gen), torch.randn(50, 3,
                                                          generator=gen)
    graphed = GraphedStep(fn, (v, c))
    assert graphed.graphs == {}
    for got, want in zip(graphed(v, c), fn(v, c)):
        assert torch.equal(got, want)
    other = graphed(v * 2, c)
    assert not torch.equal(other[0], fn(v, c)[0])
    for got, want in zip(other, fn(v * 2, c)):
        assert torch.equal(got, want)
    assert graphed.graphs == {}


def test_value_and_grad_is_autograd():
    gen = torch.Generator().manual_seed(3)
    x, y = torch.randn(7, generator=gen), torch.randn(7, generator=gen)
    value, dx, dy = value_and_grad(lambda a, b: (a * a * b).sum())(x, y)
    assert torch.equal(value, (x * x * y).sum())
    assert torch.equal(dx, 2 * x * y) and torch.equal(dy, x * x)
    assert not value.requires_grad


class _EagerGraph:
    """Stands in for a capture: runs the function once at 'capture' and
    once a 'replay', and counts both."""

    made = 0

    def __init__(self, fn, args):
        type(self).made += 1
        self.fn = fn

    def __call__(self, args, entry):
        return self.fn(*args)


def test_one_graph_per_signature(monkeypatch):
    monkeypatch.setattr(graphstep, "_Graph", _EagerGraph)
    monkeypatch.setattr(graphstep, "_on_card", lambda args: True)
    _EagerGraph.made = 0
    calls = []

    def fn(x, scale):
        calls.append(scale)
        return x * scale

    x = torch.ones(3)
    graphed = GraphedStep(fn, (x, 2.0))
    assert _EagerGraph.made == 1 and calls == []
    assert torch.equal(graphed(x + 1, 2.0), (x + 1) * 2)
    assert _EagerGraph.made == 1                 # same signature
    graphed(x, 3.0)                              # a static value
    graphed(torch.ones(4), 2.0)                  # a shape
    graphed(torch.ones(3, dtype=torch.float64), 2.0)   # a dtype
    graphed(x.clone().requires_grad_(), 2.0)     # requires_grad
    graphed(x * 5, 3.0)
    assert _EagerGraph.made == 5 and len(graphed.graphs) == 5
    assert calls == [2.0, 3.0, 2.0, 2.0, 2.0, 3.0]


def test_failed_capture_raises_without_an_eager_call(monkeypatch):
    class _Refused:
        def __init__(self, fn, args):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    monkeypatch.setattr(graphstep, "_Graph", _Refused)
    monkeypatch.setattr(graphstep, "_on_card", lambda args: True)
    calls = []
    with pytest.raises(RuntimeError, match="capturing"):
        GraphedStep(lambda x: calls.append(x) or x, (torch.ones(2),))
    assert calls == []


# --- 3. the graphed bench step against dirt_tpu -------------------------------


@functools.lru_cache(maxsize=None)
def _bench_inputs(engine):
    verts, colors, faces = sphere_scene()
    bg = np.zeros((SIZE, SIZE, 3), np.float32)
    w = np.random.RandomState(1).rand(SIZE, SIZE, 3).astype(np.float32)
    fields = dict(ENGINES[engine])
    config = dirt_tpu.suggest_raster_config(
        verts, faces, SIZE, SIZE, config=JaxConfig(**fields), clip=False)
    return bg, verts, colors, faces, w, config


@functools.lru_cache(maxsize=None)
def _jax_bench_step(engine):
    bg, verts, colors, faces, w, config = _bench_inputs(engine)

    def loss(v, c):
        return jax.numpy.sum(dirt_tpu.rasterise(
            bg, v, c, faces, config=config, clip=False) * w)

    value, (d_v, d_c) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        verts, colors)
    pixels, fid, zbuf, overflow = dirt_tpu.rasterise_with_aux(
        bg, verts, colors, faces, config=config, clip=False)
    return (float(value), np.asarray(d_v), np.asarray(d_c), np.asarray(fid),
            np.asarray(zbuf), bool(overflow))


@pytest.mark.parametrize("engine", list(ENGINES))
def test_graphed_bench_step_matches_jax(engine):
    bg, verts, colors, faces, w, jax_config = _bench_inputs(engine)
    config = convert.config_from_jax(jax_config)
    bg_t, v_t, c_t, f_t = convert.scene_from_numpy(bg, verts, colors, faces,
                                                   "cpu")
    w_t = torch.tensor(w)

    def loss(v, c):
        return (dirt_tpu_torch.rasterise(bg_t, v, c, f_t, config=config,
                                         clip=False) * w_t).sum()

    value, d_v, d_c = GraphedStep(value_and_grad(loss), (v_t, c_t))(v_t, c_t)
    fid_t = dirt_tpu_torch.rasterise_with_aux(
        bg_t, v_t, c_t, f_t, config=config, clip=False)[1].numpy()
    value_j, d_v_j, d_c_j, fid_j, z_j, overflow_j = _jax_bench_step(engine)
    assert overflow_j is False
    assert (fid_t != fid_j).mean() <= RAZOR
    np.testing.assert_allclose(float(value), value_j, rtol=1e-4)
    d_v, d_c = d_v.numpy(), d_c.numpy()
    slots = port_slots(bg, verts, colors, faces, config, False)
    geo_j = jax_planes(bg, verts, colors, faces, config, False)
    keep = vertex_keep(faces, d_v.shape[0], fid_t, fid_j, slots, z_j, geo_j)
    assert keep.mean() > 0.9
    np.testing.assert_allclose(d_c[keep], d_c_j[keep], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(d_v[keep], d_v_j[keep], rtol=1e-3, atol=1e-3)
    if not keep.all():
        d_v_o, d_c_o = oracle_vertex_grads(bg, verts, colors, faces, w,
                                           slots, config, False)
        np.testing.assert_allclose(d_c[~keep], d_c_o[~keep], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(d_v[~keep], d_v_o[~keep], rtol=1e-3,
                                   atol=1e-3)
    assert np.abs(d_v).max() > 0 and np.abs(d_c).max() > 0


def test_demo5_fit_steps_through_one_graphed_step(monkeypatch):
    demo = _demo5()
    made = []

    class Recorded(GraphedStep):
        def __init__(self, fn, example_args):
            super().__init__(fn, example_args)
            self.rates = []
            made.append(self)

        def __call__(self, *args):
            self.rates.append(float(args[0]))
            return super().__call__(*args)

    monkeypatch.setattr(demo, "GraphedStep", Recorded)
    loss_fn, params = demo.problem(48, 8, 8, "cpu")[:2]
    final, opt, losses = demo.fit(loss_fn, params, 4)
    assert len(made) == 1
    rate = float(np.float32(demo.LR_BUMP))      # a float32 tensor's value
    assert made[0].rates == [0.0, 0.0, rate, rate]
    assert losses.shape == (4,) and bool(torch.isfinite(losses).all())
    # The bump moved in the last two steps only, about one rate a step.
    assert 1.5 * demo.LR_BUMP < float(final["bump"].abs().max()) \
        < 2.5 * demo.LR_BUMP


@pytest.mark.parametrize("n", [3, 4])
def test_demo_fit_steps_through_one_graphed_step(monkeypatch, n):
    """Demos 3 and 4: ``fit`` makes one ``GraphedStep`` and calls it once a
    step, and its losses and final parameters are those of the plain
    descent (here, on the CPU, the same ops: bit for bit); the parameters
    handed in stay as they were."""
    demo = _demo(n)
    made = []

    class Recorded(GraphedStep):
        def __init__(self, fn, example_args):
            super().__init__(fn, example_args)
            self.calls = 0
            made.append(self)

        def __call__(self, *args):
            self.calls += 1
            return super().__call__(*args)

    monkeypatch.setattr(demo, "GraphedStep", Recorded)
    loss_fn, params = demo.problem(48, "cpu")[:2]
    start = {k: v.clone() for k, v in params.items()}
    final, losses = demo.fit(loss_fn, params, 4)
    assert len(made) == 1 and made[0].calls == 4
    rates = ({"texture": demo.LR} if n == 3 else demo.LR)
    values, want = dict(start), []
    for _ in range(4):
        leaves = {k: v.detach().requires_grad_() for k, v in values.items()}
        loss = loss_fn(**leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        want.append(loss.detach())
        values = {k: v - rates[k] * g
                  for (k, v), g in zip(values.items(), grads)}
    assert torch.equal(losses, torch.stack(want))
    assert float(losses[-1]) < float(losses[0])
    assert all(torch.equal(final[k], values[k].detach()) for k in values)
    assert all(torch.equal(params[k], start[k]) for k in start)


# --- 4. on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_step(engine, clip, device):
    """(step, args): the bench step on the 24 x 32 sphere at 128 x 256,
    ``step(bg, verts, colors) -> (pixels, fid, overflow, d_verts,
    d_colors, d_bg)``."""
    verts, colors, faces = sphere_scene(24, 32, distance=0.9 if clip
                                        else 3.0)
    bg, verts, colors, faces = convert.scene_from_numpy(
        np.random.RandomState(4).rand(128, 256, 3).astype(np.float32), verts,
        colors, faces, device)
    weights = torch.rand(128, 256, 3, generator=torch.Generator()
                         .manual_seed(1)).to(device)
    config = dirt_tpu_torch.suggest_raster_config(
        verts, faces, 128, 256, config=RasterConfig(**ENGINES[engine]),
        clip=clip)

    def step(b, v, c):
        b, v, c = (t.detach().requires_grad_() for t in (b, v, c))
        pixels, fid, _, overflow = dirt_tpu_torch.rasterise_with_aux(
            b, v, c, faces, config=config, clip=clip)
        grads = torch.autograd.grad((pixels * weights).sum(), (v, c, b))
        return (pixels.detach(), fid, overflow, *grads)

    return step, (bg, verts, colors)


def _assert_same_step(got, want):
    pixels, fid, overflow, *grads = got
    pixels_e, fid_e, overflow_e, *grads_e = want
    assert torch.equal(fid, fid_e) and torch.equal(overflow, overflow_e)
    assert torch.equal(pixels, pixels_e)
    for g, g_e in zip(grads, grads_e):
        assert _rel_err(g, g_e) <= TOL_GRAD


@pytest.mark.cuda
@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("clip", [False, True])
def test_graphed_step_equals_eager_on_card(cuda, engine, clip):
    step, args = _card_step(engine, clip, cuda)
    graphed = GraphedStep(step, args)
    _assert_same_step(graphed(*args), step(*args))
    moved = (args[0], args[1] * 1.02, args[2].flip(0))
    _assert_same_step(graphed(*moved), step(*moved))
    assert len(graphed.graphs) == 1 and graphed.pool_bytes() > 0


@pytest.mark.cuda
def test_graphed_flagship_equals_eager_on_card(cuda):
    graphed, (verts, pose) = entry.entry_step(cuda)
    forward_step, _ = entry.entry(cuda)
    eager = value_and_grad(forward_step)
    for args in ((verts, pose), (verts * 1.01, pose + 0.05)):
        got = [t.clone() for t in graphed(*args)]
        want = eager(*args)
        assert torch.allclose(got[0], want[0], rtol=1e-6, atol=0)
        for g, g_e in zip(got[1:], want[1:]):
            assert _rel_err(g, g_e) <= TOL_DEFERRED


@pytest.mark.cuda
def test_graphed_demo5_fit_equals_eager_on_card(cuda, monkeypatch):
    """Losses, pose and bump of the graphed fit against the eager fit
    within 1e-4, and two eager fits equal bit for bit (the vertex normals
    sum in a sorted order; with atomics there, Adam took full steps on
    gradients that were rounding noise and two fits parted)."""
    demo = _demo5()
    loss_fn, params = demo.problem(128, 12, 12, cuda)[:2]

    def fit():
        final, _, losses = demo.fit(loss_fn, params, 6)
        return [losses, final["pose"], final["bump"]]

    graphed = fit()
    monkeypatch.setattr(demo, "GraphedStep", lambda fn, args: fn)
    eager, again = fit(), fit()
    for got, want, other in zip(graphed, eager, again):
        assert torch.equal(other, want)
        assert _rel_err(got, want) <= TOL_DEFERRED


def _card_parallel_step(path, engine, device):
    """(step, args): ``_parallel_step``'s renderers on the 24 x 32 sphere at
    128 x 256 on the card, ``step(bg, verts, colors) -> (pixels, fid,
    overflow, d_verts, d_colors, d_bg)``."""
    from dirt_tpu_torch.parallel.face_sharding import rasterise_face_sharded
    from dirt_tpu_torch.parallel.group import LocalGroup
    from dirt_tpu_torch.parallel.sharding import rasterise_sharded

    verts, colors, faces = sphere_scene(24, 32)
    bg, verts, colors, faces = convert.scene_from_numpy(
        np.random.RandomState(4).rand(128, 256, 3).astype(np.float32), verts,
        colors, faces, device)
    weights = torch.rand(128, 256, 3, generator=torch.Generator()
                         .manual_seed(1)).to(device)
    config = dirt_tpu_torch.suggest_raster_config(
        verts, faces, 128, 256,
        config=RasterConfig(tile_h=8, **ENGINES[engine]), clip=False)
    render = {
        "sharded": lambda b, v, c: rasterise_sharded(
            b, v, c, faces, LocalGroup(4), config=config, with_aux=True),
        "overlap": lambda b, v, c: rasterise_sharded(
            b, v, c, faces, LocalGroup(4), config=config, overlap_chunks=2,
            with_aux=True),
        "face-sharded": lambda b, v, c: rasterise_face_sharded(
            b, v, c, faces, LocalGroup(4), config=config, with_aux=True),
    }[path]

    def step(b, v, c):
        b, v, c = (t.detach().requires_grad_() for t in (b, v, c))
        pixels, fid, _, overflow = render(b, v, c)
        grads = torch.autograd.grad((pixels * weights).sum(), (v, c, b))
        return (pixels.detach(), fid, overflow, *grads)

    return step, (bg, verts, colors)


@pytest.mark.cuda
@pytest.mark.parametrize("path, engine", [
    ("sharded", "dense"), ("sharded", "csr"), ("sharded", "packed"),
    ("overlap", "packed"), ("face-sharded", "dense")])
def test_graphed_parallel_step_equals_eager_on_card(cuda, path, engine):
    step, args = _card_parallel_step(path, engine, cuda)
    graphed = GraphedStep(step, args)
    _assert_same_step(graphed(*args), step(*args))
    moved = (args[0], args[1] * 1.02, args[2].flip(0))
    _assert_same_step(graphed(*moved), step(*moved))
    assert len(graphed.graphs) == 1 and graphed.pool_bytes() > 0


@pytest.mark.cuda
def test_graphed_dryrun_equals_eager_on_card(cuda):
    """``dryrun_multichip(4)``'s graphed Adam steps and variants against
    the eager ones: the losses within TOL_DEFERRED (torch's atomics in the
    vertex normals), variants 2-4 at 2128.7512 +- 1e-3."""
    graphed = entry.dryrun_multichip(4, cuda, steps=3)
    eager = entry.dryrun_multichip(4, cuda, steps=3, graphed=False)
    assert graphed["losses"][-1] < graphed["losses"][0]
    np.testing.assert_allclose(graphed["losses"], eager["losses"],
                               rtol=TOL_DEFERRED)
    for key in ("two_level", "overlap", "face_sharded"):
        assert abs(graphed[f"loss_{key}"] - 2128.7512) <= 1e-3
        assert graphed[f"grad_{key}"] == pytest.approx(eager[f"grad_{key}"],
                                                       rel=TOL_GRAD)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 4])
def test_graphed_demo_fit_equals_eager_on_card(cuda, monkeypatch, n):
    """Demos 3 and 4, as demo 5's test: losses and final parameters of the
    graphed fit within 1e-4 of the eager fit's; two eager fits of demo 4
    equal bit for bit (demo 3's texture gather sums its backward with
    atomics)."""
    demo = _demo(n)
    loss_fn, params = demo.problem(128, cuda)[:2]

    def fit():
        final, losses = demo.fit(loss_fn, params, 6)
        return [losses, *final.values()]

    graphed = fit()
    monkeypatch.setattr(demo, "GraphedStep", lambda fn, args: fn)
    eager, again = fit(), fit()
    for got, want, other in zip(graphed, eager, again):
        assert n == 3 or torch.equal(other, want)
        assert _rel_err(got, want) <= TOL_DEFERRED


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_graphed_config_step_equals_eager_on_card(cuda, n):
    """The sheet's graphed forward and gradient step against the eager
    ones: images equal bit for bit (configs 4-5, whose vertex normals sum
    with atomics in the forward too: within 1e-4), gradients within 1e-5
    of max |gradient| (configs 3-5, whose texture gathers and vertex
    normals sum with atomics: 1e-4)."""
    import bench_configs_torch

    make = bench_configs_torch.CONFIGS[n - 1]
    config = make(cuda, 256, 24, 24) if n == 5 else make(cuda)
    forward, step = bench_configs_torch.graphed_steps(config)
    eager = value_and_grad(config.loss)
    tol = TOL_GRAD if n < 3 else TOL_DEFERRED
    for leaves in (config.leaves, tuple(t * 1.01 for t in config.leaves)):
        image = forward(*leaves)
        want = bench_configs_torch.forward_step(config)(*leaves)
        assert (torch.equal(image, want) if n < 4
                else _rel_err(image, want) <= TOL_DEFERRED)
        got = [t.clone() for t in step(*leaves)]
        for g, g_e in zip(got, eager(*leaves)):
            assert _rel_err(g, g_e) <= tol


@pytest.mark.cuda
def test_failed_capture_raises_on_card(cuda):
    calls = []

    def reads_the_card(x):
        calls.append(1)
        return x * float(x.sum())               # a host read: no capture

    with pytest.raises(RuntimeError):
        GraphedStep(reads_the_card, (torch.ones(8, device=cuda),))
    assert len(calls) == graphstep.WARMUP + 1
    torch.cuda.synchronize()
