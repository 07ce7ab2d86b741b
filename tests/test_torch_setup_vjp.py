"""The setup's vector-Jacobian product (``ops/triangle_setup.setup_planes_vjp``)
on the CPU, where the wrapper takes its plain version.

``setup_planes_vjp_plain`` writes out the chain rule of ``setup_planes``
that autograd used to apply in the raster op's backward. It is held, on
the scenes of ``_torch_port_scene.setup_vjp_scenes`` (random faces at C =
1, 3, 9 and 16 in both orientations, invalid faces of every kind, the
10,224-face sphere's pole slivers at 1024 x 1024, the clipped crossing
sphere), each with ``row_shift`` 0 and 1 and random cotangents in all 24
columns of ``d_geo``, against three others:

* the float64 reference: ``torch.autograd.grad`` through the port's own
  ``setup_planes`` run in float64 (the module's ``torch.float32`` read as
  ``torch.float64``);
* the float32 path it replaces, ``torch.autograd.grad`` through
  ``setup_planes``;
* ``jax.vjp`` of ``dirt_tpu``'s ``setup_planes`` (float32).

Tolerance: none of its own. Scene by scene, its error against the float64
reference (the 2-norm of the difference over the 2-norm of the reference,
``d_face_verts`` and ``d_face_attrs`` apart) must be no larger than twice
the error of the float32 autograd path, which computes the same function
with other roundings; and its distance from ``jax.vjp``'s, over the same
norm, no larger than that bound plus the JAX path's own error. Both are
taken over the faces the float32 setup holds valid, which the float64
setup holds valid with the same orientation (asserted), so the branches
compared are the same; on the others every float32 path gives zeros,
exactly (float64 holds the faces at ``AREA_EPS`` valid). The
errors are those of float32 inputs (up to 1.3e-4 on the sphere's pole
slivers, 1.4e-3 on the faces at ``AREA_EPS`` moved a row down) and equal
in the three paths to about a percent.

Besides: the cotangents asked for (``need_fv`` / ``need_fa``) and no
others; ``d_geo``'s padding columns never read; the wrapper's plain
version on the CPU with no launch counted, through strided cotangents
too; its ``ValueError`` on a dtype, shape or device the kernel does not
take; ``chain_through_setup`` as the setup VJP of the untracked planes
it hands the engine; the raster op on each engine setting the planes up
once a step, in the forward, and pulling back once in the backward.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_scene import setup_vjp_cotangents, setup_vjp_scenes
from dirt_tpu.ops import triangle_setup as jt
from dirt_tpu_torch.ops import raster
from dirt_tpu_torch.ops import triangle_setup as tt
from dirt_tpu_torch.utils import trace

SCENES = ("soup C=1", "soup C=3", "soup C=9", "soup C=16", "invalid",
          "sphere 10224", "clipped sphere")
ROW_SHIFTS = (0.0, 1.0)
# The VJP's error against float64 may be at most this multiple of either
# float32 path's.
ERR_RATIO = 2.0


@functools.lru_cache(maxsize=None)
def _scenes():
    return setup_vjp_scenes()


def _inputs(name):
    fv, fa = _scenes()[name]
    seed = sorted(_scenes()).index(name)
    d_geo, d_att = setup_vjp_cotangents(len(fv), fa.shape[-1], seed)
    return tuple(torch.tensor(a) for a in (fv, fa, d_geo, d_att))


class _Float64:
    """``torch`` with ``float32`` read as ``float64``, for the module's
    global name: ``setup_planes`` then runs in float64 throughout."""

    float32 = torch.float64

    def __getattr__(self, name):
        return getattr(torch, name)


def _moved(fv, row_shift):
    return raster.move_rows(fv, row_shift) if row_shift else fv


def _autograd(fv, fa, d_geo, d_att, row_shift):
    """(d_fv, d_fa) of ``setup_planes`` by autograd, in the inputs'
    dtype."""
    x = fv.clone().requires_grad_()
    y = fa.clone().requires_grad_()
    geo, att, _ = tt.setup_planes(_moved(x, row_shift), y)
    return torch.autograd.grad([geo, att], [x, y],
                               [d_geo.to(geo.dtype), d_att.to(att.dtype)])


def _float64(fv, fa, d_geo, d_att, row_shift):
    with mock.patch.object(tt, "torch", _Float64()):
        return _autograd(fv.double(), fa.double(), d_geo.double(),
                         d_att.double(), row_shift)


def _decisions(fv, row_shift):
    """(valid, orient) as the setup decides them in ``fv``'s dtype."""
    xs, ys, _, ws = tt._corners(_moved(fv, row_shift))
    return tt._oriented_edges(xs, ys, ws)[:2]


def _jax(fv, fa, d_geo, d_att, row_shift):
    def setup(v, a):
        v = v.at[..., 1].add(row_shift) if row_shift else v
        return jt.setup_planes(v, a)[:2]

    _, pull = jax.vjp(setup, jnp.asarray(fv.numpy()),
                      jnp.asarray(fa.numpy()))
    return tuple(torch.tensor(np.asarray(g)) for g in pull(
        (jnp.asarray(d_geo.numpy()), jnp.asarray(d_att.numpy()))))


def _rel(got, want):
    scale = float(torch.linalg.vector_norm(want))
    diff = float(torch.linalg.vector_norm(got.double() - want))
    return diff / scale if scale else diff


@pytest.mark.parametrize("row_shift", ROW_SHIFTS)
@pytest.mark.parametrize("name", SCENES)
def test_plain_vjp_against_float64(name, row_shift):
    fv, fa, d_geo, d_att = _inputs(name)
    plain = tt.setup_planes_vjp_plain(fv, fa, d_geo, d_att, row_shift)
    ref = _float64(fv, fa, d_geo, d_att, row_shift)
    ag = _autograd(fv, fa, d_geo, d_att, row_shift)
    jx = _jax(fv, fa, d_geo, d_att, row_shift)
    valid, orient = _decisions(fv, row_shift)
    valid64, orient64 = _decisions(fv.double(), row_shift)
    # The faces the float32 setup holds valid take the same branches in
    # float64; it holds invalid the faces at AREA_EPS, which float64 does
    # not, and every float32 path gives those zeros.
    assert torch.equal(valid & valid64, valid)
    assert torch.equal(orient[valid], orient64[valid].float())
    for got in (plain, ag, jx):
        for g in got:
            assert torch.equal(g[~valid], torch.zeros_like(g[~valid]))
    for mine, want, g_ag, g_jax in zip(*(
            [g[valid] for g in got] for got in (plain, ref, ag, jx))):
        err, err_ag, err_jax = (_rel(g, want) for g in (mine, g_ag, g_jax))
        assert err <= ERR_RATIO * err_ag, (err, err_ag)
        # Apart from jax.vjp by no more than the two roundings allow.
        apart = float(torch.linalg.vector_norm(
            mine.double() - g_jax.double()) / torch.linalg.vector_norm(want))
        assert apart <= ERR_RATIO * err_ag + err_jax, (apart, err_ag,
                                                       err_jax)


@pytest.mark.parametrize("need_fv,need_fa", [(True, True), (True, False),
                                             (False, True), (False, False)])
def test_plain_vjp_returns_what_is_asked(need_fv, need_fa):
    """Each cotangent asked for, bit-equal to the full call's; None for
    one not asked for."""
    fv, fa, d_geo, d_att = _inputs("soup C=3")
    full = tt.setup_planes_vjp_plain(fv, fa, d_geo, d_att)
    got = tt.setup_planes_vjp_plain(fv, fa, d_geo, d_att, 0.0, need_fv,
                                    need_fa)
    for need, g, want in zip((need_fv, need_fa), got, full):
        assert (g is None) is not need
        if need:
            assert torch.equal(g, want)


def test_plain_vjp_ignores_the_padding_columns():
    fv, fa, d_geo, d_att = _inputs("soup C=3")
    cut = d_geo.clone()
    cut[:, tt.GEO_USED:] = float("nan")
    for a, b in zip(tt.setup_planes_vjp_plain(fv, fa, d_geo, d_att),
                    tt.setup_planes_vjp_plain(fv, fa, cut, d_att)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("row_shift", ROW_SHIFTS)
def test_wrapper_takes_the_plain_version_on_the_cpu(row_shift):
    """Bit for bit, with no launch counted, also through strided
    cotangents: ``d_att`` as the engines hand it (a view of their [F, 12
    + 3C] face rows) and ``d_geo`` a view of wider rows."""
    fv, fa, d_geo, d_att = _inputs("soup C=9")
    rows = torch.randn(len(fv), 12 + d_att.shape[1])
    rows[:, 12:] = d_att
    wide = torch.randn(len(fv), 40)
    wide[:, :24] = d_geo
    before = trace.counters().get("launch.setup_vjp", 0)
    want = tt.setup_planes_vjp_plain(fv, fa, d_geo, d_att, row_shift)
    for geo_in, att_in in ((d_geo, d_att), (wide[:, :24], rows[:, 12:])):
        got = tt.setup_planes_vjp(fv, fa, geo_in, att_in, row_shift)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert trace.counters().get("launch.setup_vjp", 0) == before


def _bad_args():
    fv, fa, d_geo, d_att = _inputs("soup C=3")
    meta = {k: t.to("meta") for k, t in dict(
        fv=fv, fa=fa, d_geo=d_geo, d_att=d_att).items()}
    return {
        "float64 faces": (fv.double(), fa, d_geo, d_att),
        "float64 d_att": (fv, fa, d_geo, d_att.double()),
        "corners of 3": (fv[..., :3], fa, d_geo, d_att),
        "fewer attribute rows": (fv, fa[1:], d_geo, d_att),
        "no channels": (fv, fa[..., :0], d_geo, d_att[:, :0]),
        "d_att of another C": (fv, fa, d_geo, d_att[:, :6]),
        "d_geo of 16 columns": (fv, fa, d_geo[:, :16], d_att),
        "d_geo of another F": (fv, fa, d_geo[1:], d_att),
        "attributes on another device": (fv, meta["fa"], d_geo, d_att),
        "all on a device with no kernel": tuple(meta.values()),
    }


@pytest.mark.parametrize("case", list(_bad_args()))
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError, match="setup_planes_vjp"):
        tt.setup_planes_vjp(*_bad_args()[case])


@pytest.mark.parametrize("row_shift", ROW_SHIFTS)
def test_chain_through_setup_is_the_vjp_of_the_moved_planes(row_shift):
    """``chain_through_setup`` hands the engine the planes of the faces
    moved ``row_shift`` rows down, untracked, and returns the setup VJP
    of the engine's cotangents with its background gradient."""
    fv, fa, d_geo, d_att = _inputs("clipped sphere")
    seen = []

    def plane_cotangents(geo, att):
        seen.append((geo, att))
        return d_geo, d_att, "background"

    d_fv, d_fa, d_bg = raster.chain_through_setup(
        fv, fa, True, True, plane_cotangents, row_shift=row_shift)
    (geo, att), = seen
    want_geo, want_att, _ = tt.setup_planes(_moved(fv, row_shift), fa)
    assert not (geo.requires_grad or att.requires_grad)
    assert torch.equal(geo, want_geo) and torch.equal(att, want_att)
    assert d_bg == "background"
    want = tt.setup_planes_vjp_plain(fv, fa, d_geo, d_att, row_shift)
    assert torch.equal(d_fv, want[0]) and torch.equal(d_fa, want[1])


@pytest.mark.parametrize("fields", [dict(engine="packed"),
                                    dict(engine="dense"),
                                    dict(streaming=True)])
def test_the_raster_op_sets_the_planes_up_once_a_step(fields):
    """The forward sets the faces up once (``setup_faces``, for its
    engine) and its bins carry the planes; the backward hands them to the
    engine and the setup VJP (one call), and sets up none again."""
    import dirt_tpu_torch
    from _torch_port_scene import sphere_scene
    from dirt_tpu_torch import convert

    verts, colors, faces = sphere_scene(12, 16)
    bg = np.random.RandomState(6).rand(64, 80, 3).astype(np.float32)
    w = torch.tensor(np.random.RandomState(7).randn(64, 80, 3),
                     dtype=torch.float32)
    bg_t, v_t, c_t, f_t = convert.scene_from_numpy(bg, verts, colors, faces,
                                                   "cpu")
    leaves = [t.clone().requires_grad_() for t in (v_t, c_t, bg_t)]
    calls = {"setup": [], "vjp": []}

    def counted(name, inner):
        def wrapper(*args, **kwargs):
            calls[name].append(args[4:] + tuple(kwargs.values()))
            return inner(*args, **kwargs)
        return wrapper

    with mock.patch.object(tt, "setup_faces",
                           counted("setup", tt.setup_faces)), \
            mock.patch.object(tt, "setup_planes_vjp",
                              counted("vjp", tt.setup_planes_vjp)):
        pixels = dirt_tpu_torch.rasterise(
            leaves[2], leaves[0], leaves[1], f_t,
            config=dirt_tpu_torch.RasterConfig(**fields))
        assert (len(calls["setup"]), len(calls["vjp"])) == (1, 0)
        (pixels * w).sum().backward()
    assert (len(calls["setup"]), len(calls["vjp"])) == (1, 1)
    # The forward's one setup is its engine's: boxes and edge columns in
    # the layout that engine's binning reads.
    assert calls["setup"][0] == (fields.get("engine", "csr"),)
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0)
               for t in leaves)
