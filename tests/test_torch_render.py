"""dirt_tpu_torch's render stack vs dirt_tpu's, values and gradients, on the CPU.

``core.lighting``, ``core.texture``, ``render.gbuffer``, ``render.deferred``
and the flagship step (``dirt_tpu_torch.entry``, the counterpart of
``__graft_entry__.entry()``). The same numpy inputs go through both
packages. Tolerances:

* lighting and texture: values and gradients allclose(rtol=1e-5,
  atol=1e-6): the same expressions; sums over faces and samples are taken
  in other orders (``index_add_`` against XLA's scatter, and against the
  JAX package's sorted segment sum in the texture's gradient);
* ``render_gbuffer``: fid equal except on at most 0.5% of pixels (razor
  edges, the policy of test_torch_pipeline.py); buffers within 1e-5 where
  fids agree;
* ``shade_deferred`` on one G-buffer given to both: values 1e-5, gradients
  allclose(rtol=1e-4, atol=1e-5) (the JAX texture gradient, a difference of
  prefix sums, leaves ~4e-6 on texels no sample touches; the highlight's
  24th power amplifies one rounding step to ~4e-6 on a few pixels);
* the flagship loss at 96 px: loss within 1e-6 relative; gradients to the
  vertices and the pose within 1e-4 of the gradient's largest magnitude
  (both packages run their dense engine; the rasterizer's sums differ in
  order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dirt_tpu.core import lighting as jl
from dirt_tpu.core import texture as jtex
from dirt_tpu.ops.raster import RasterConfig as JaxConfig
from dirt_tpu.render.deferred import shade_deferred as jax_shade
from dirt_tpu.render.gbuffer import render_gbuffer as jax_gbuffer
from dirt_tpu_torch import convert, entry
from dirt_tpu_torch.core import lighting as tl
from dirt_tpu_torch.core import mesh
from dirt_tpu_torch.core import texture as ttex
from dirt_tpu_torch.ops.raster import RasterConfig
from dirt_tpu_torch.render.deferred import shade_deferred
from dirt_tpu_torch.render.gbuffer import render_gbuffer

TOL = dict(rtol=1e-5, atol=1e-6)
RAZOR = 0.005


def _t(a, grad=False):
    t = torch.tensor(np.asarray(a))
    return t.requires_grad_() if grad else t


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _both_grads(jax_fn, torch_fn, arrays, weight_seed=0):
    """Values and gradients of sum(f(*arrays) * w) through both packages."""
    out_j = jax_fn(*(jnp.asarray(a) for a in arrays))
    w = np.random.RandomState(weight_seed).randn(*out_j.shape)
    w = w.astype(np.float32)
    grads_j = jax.grad(
        lambda *xs: jnp.sum(jax_fn(*xs) * w),
        argnums=tuple(range(len(arrays))))(*(jnp.asarray(a) for a in arrays))
    leaves = [_t(a, grad=True) for a in arrays]
    out_t = torch_fn(*leaves)
    (out_t * torch.tensor(w)).sum().backward()
    grads_t = [torch.zeros_like(x) if x.grad is None else x.grad
               for x in leaves]
    return (out_t.detach(), grads_t), (out_j, grads_j)


# --- lighting --------------------------------------------------------------------


def _bumpy_sphere(seed=0):
    verts, faces, _ = mesh.uv_sphere(6, 8)
    rng = np.random.RandomState(seed)
    verts = verts * (1.0 + 0.1 * rng.rand(len(verts), 1)).astype(np.float32)
    return verts.astype(np.float32), faces


def test_vertex_normals_match_jax_with_gradients():
    verts, faces = _bumpy_sphere()
    (out_t, (g_t,)), (out_j, (g_j,)) = _both_grads(
        lambda v: jl.vertex_normals(v, faces),
        lambda v: tl.vertex_normals(v, torch.tensor(faces)), [verts])
    _close(out_t, out_j)
    _close(g_t, g_j, rtol=1e-4, atol=1e-5)
    cube_v, cube_f = mesh.cube()
    normals = tl.vertex_normals(torch.tensor(cube_v), cube_f)
    assert (torch.sum(normals * torch.tensor(cube_v), dim=-1) > 0).all()


def test_vertex_normals_batched_match_jax():
    verts, faces = _bumpy_sphere(1)
    batch = np.stack([verts, verts[:, [1, 2, 0]] * 1.5])
    want = jl.vertex_normals(jnp.asarray(batch), faces)
    got = tl.vertex_normals(torch.tensor(batch), faces)
    assert got.shape == (2, len(verts), 3)
    _close(got, want)


def test_split_and_pre_split_normals_match_jax():
    verts, faces = _bumpy_sphere(2)
    sv_j, sf_j = jl.split_vertices_by_face(jnp.asarray(verts), faces)
    sv_t, sf_t = tl.split_vertices_by_face(torch.tensor(verts), faces)
    np.testing.assert_array_equal(sv_t.numpy(), np.asarray(sv_j))
    np.testing.assert_array_equal(sf_t.numpy(), np.asarray(sf_j))
    assert sf_t.dtype == torch.int32
    (out_t, (g_t,)), (out_j, (g_j,)) = _both_grads(
        lambda v: jl.vertex_normals_pre_split(v, sf_j),
        lambda v: tl.vertex_normals_pre_split(v, sf_t), [np.asarray(sv_j)])
    _close(out_t, out_j)
    _close(g_t, g_j, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("double_sided", [False, True])
def test_diffuse_and_specular_match_jax_with_gradients(double_sided):
    verts, faces = _bumpy_sphere(3)
    rng = np.random.RandomState(4)
    colors = rng.rand(len(verts), 3).astype(np.float32)
    light = np.array([0.3, 0.8, 0.52], np.float32)
    cam = np.array([0.2, 0.1, 3.0], np.float32)

    def shade(mod, asarray):
        def fn(v, c, l):
            n = mod.vertex_normals(v, asarray(faces))
            l_unit = l / (l * l).sum() ** 0.5
            return mod.diffuse_directional(
                n, c, l_unit, asarray(np.ones(3, np.float32)),
                double_sided=double_sided,
            ) + mod.specular_directional(
                v, n, c, asarray(cam), l_unit,
                asarray(np.ones(3, np.float32)), 24.0,
                double_sided=double_sided)
        return fn

    (out_t, g_t), (out_j, g_j) = _both_grads(
        shade(jl, jnp.asarray), shade(tl, torch.tensor),
        [verts, colors, light])
    _close(out_t, out_j)
    for got, want in zip(g_t, g_j):
        _close(got, want, rtol=1e-4, atol=1e-5)
    assert float(out_t.max()) > 0.5


# --- texture -----------------------------------------------------------------------

_WRAPS = ["clamp", "repeat", ("clamp", "repeat"), ("repeat", "clamp")]


def _texture_inputs(seed=0, n=400):
    rng = np.random.RandomState(seed)
    tex = rng.rand(7, 5, 3).astype(np.float32)
    # In range, out of range on both sides, and a few exact edges.
    uv = rng.uniform(-0.6, 1.6, (n, 2)).astype(np.float32)
    uv[:4] = [[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [0.5, 0.5]]
    return tex, uv


@pytest.mark.parametrize("wrap", _WRAPS, ids=str)
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_sample_texture_values_match_jax(mode, wrap):
    tex, uv = _texture_inputs()
    want = jtex.sample_texture(jnp.asarray(tex), jnp.asarray(uv), mode=mode,
                               wrap=wrap)
    got = ttex.sample_texture(torch.tensor(tex), torch.tensor(uv), mode=mode,
                              wrap=wrap)
    _close(got, want)
    got_cf = ttex.sample_texture(torch.tensor(tex), torch.tensor(uv),
                                 mode=mode, wrap=wrap, channels_first=True)
    assert torch.equal(got_cf, got.movedim(-1, 0))


@pytest.mark.parametrize("wrap", _WRAPS, ids=str)
def test_sample_texture_gradients_match_jax(wrap):
    """Texture and UV gradients against the JAX package's hand-written
    gradient (its default) for every wrap mode; the uv batch is an image
    grid, as the deferred pipeline samples."""
    tex, uv = _texture_inputs(1, n=24 * 16)
    uv = uv.reshape(24, 16, 2)
    (out_t, g_t), (out_j, g_j) = _both_grads(
        lambda t, u: jtex.sample_texture(t, u, wrap=wrap),
        lambda t, u: ttex.sample_texture(t, u, wrap=wrap), [tex, uv])
    _close(out_t, out_j)
    _close(g_t[0], g_j[0], rtol=1e-4, atol=1e-5)
    _close(g_t[1], g_j[1], rtol=1e-4, atol=1e-5)
    assert float(g_t[0].abs().max()) > 0 and float(g_t[1].abs().max()) > 0


def test_sample_texture_semantics():
    """Texel centers are exact, midpoints average, out-of-range UVs under
    clamp get no UV gradient (counterparts of tests/test_texture.py)."""
    tex = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3)
    centers = torch.tensor([[(x + 0.5) / 4, 1 - (y + 0.5) / 2]
                            for y in range(2) for x in range(4)])
    for mode in ("bilinear", "nearest"):
        got = ttex.sample_texture(tex, centers, mode=mode)
        assert torch.allclose(got, tex.reshape(8, 3), atol=1e-5)
    mid = ttex.sample_texture(tex, torch.tensor([[0.25, 0.5]]))
    assert torch.allclose(mid[0], tex[:, 0:2].mean(dim=(0, 1)), atol=1e-5)
    uv = torch.tensor([[-0.3, 0.4], [1.4, 0.6]], requires_grad=True)
    ttex.sample_texture(tex, uv, wrap=("clamp", "repeat")).sum().backward()
    assert (uv.grad[:, 0] == 0).all() and (uv.grad[:, 1] != 0).all()
    with pytest.raises(ValueError, match="wrap mode"):
        ttex.sample_texture(tex, uv, wrap="mirror")
    with pytest.raises(ValueError, match="sampling mode"):
        ttex.sample_texture(tex, uv, mode="cubic")


# --- G-buffer and deferred shading ----------------------------------------------------

SIZE = 96


@functools.lru_cache(maxsize=None)
def _deferred_scene():
    """The flagship scene at test size (a 176-face sphere, 96 px), numpy."""
    verts, faces, uvs, texture, projection, _ = graft._scene(8, 12, SIZE)
    return tuple(np.asarray(a) for a in (verts, faces, uvs, texture,
                                         projection))


@functools.lru_cache(maxsize=None)
def _world(kind):
    """Clip-space vertices, world positions and normals (numpy) of the
    flagship scene, 3 units away or so close that faces cross the near
    plane."""
    from dirt_tpu.core import matrices as jm

    verts, faces, _, _, projection = _deferred_scene()
    model = jm.compose(
        jm.rodrigues(jnp.array([0.4, 0.3, 0.0])),
        jm.translation(jnp.array([0.0, 0.0, -3.0 if kind == "far" else -0.9])))
    world = jm.transform_homogeneous(jnp.asarray(verts), model)[..., :3]
    normals = jl.vertex_normals(world, faces)
    clip = jnp.concatenate([world, jnp.ones((len(verts), 1))], -1) @ projection
    return tuple(np.asarray(a) for a in (clip, world, normals))


@pytest.mark.parametrize("kind,clip", [("far", True), ("far", False),
                                       ("near", True)])
def test_render_gbuffer_matches_jax(kind, clip):
    _, faces, uvs, _, _ = _deferred_scene()
    clip_v, world, normals = _world(kind)
    attrs = {"position": world, "normal": normals, "uv": uvs}
    want = jax_gbuffer(jnp.asarray(clip_v), jnp.asarray(faces),
                       {k: jnp.asarray(v) for k, v in attrs.items()},
                       SIZE, SIZE, config=JaxConfig(), clip=clip)
    got = render_gbuffer(torch.tensor(clip_v), torch.tensor(faces),
                         {k: torch.tensor(v) for k, v in attrs.items()},
                         SIZE, SIZE, config=RasterConfig(), clip=clip)
    assert set(got) == set(want)
    assert not bool(got["overflow"]) and not bool(want["overflow"])
    fid_t, fid_j = got["fid"].numpy(), np.asarray(want["fid"])
    differ = fid_t != fid_j
    assert differ.mean() <= RAZOR
    assert fid_t.max() < len(faces) and (fid_t >= 0).mean() > 0.1
    for name, width in (("position", 3), ("normal", 3), ("uv", 2),
                        ("mask", 1)):
        assert got[name].shape == (SIZE, SIZE, width)
        np.testing.assert_allclose(got[name].numpy()[~differ],
                                   np.asarray(want[name])[~differ],
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["mask"].numpy()[..., 0] > 0.5,
                                  fid_t >= 0)
    no_mask = render_gbuffer(torch.tensor(clip_v), torch.tensor(faces),
                             {"uv": torch.tensor(uvs)}, SIZE, SIZE,
                             include_mask=False, clip=clip)
    assert "mask" not in no_mask and no_mask["uv"].shape == (SIZE, SIZE, 2)


@pytest.mark.parametrize("specular,textured", [(True, True), (False, True),
                                               (True, False)])
def test_shade_deferred_matches_jax_with_gradients(specular, textured):
    """One G-buffer (from the JAX package) shaded by both, gradients to the
    buffers, the texture and the light; background pixels included (zero
    normals, mask 0), where the gradients must be finite and equal."""
    _, faces, uvs, texture, _ = _deferred_scene()
    clip_v, world, normals = _world("far")
    gb = jax_gbuffer(jnp.asarray(clip_v), jnp.asarray(faces),
                     {"position": jnp.asarray(world),
                      "normal": jnp.asarray(normals), "uv": jnp.asarray(uvs)},
                     SIZE, SIZE, config=JaxConfig())
    names = ("position", "normal", "uv", "mask")
    rng = np.random.RandomState(3)
    extra = dict(
        albedo=rng.rand(SIZE, SIZE, 3).astype(np.float32),
        background=rng.rand(SIZE, SIZE, 3).astype(np.float32),
        specular_color=np.array([0.9, 0.8, 0.7], np.float32),
        ambient=np.array([0.1, 0.12, 0.14], np.float32),
    )

    def make(shade, asarray):
        def fn(position, normal, uv, mask, tex, light):
            buffers = dict(zip(names, (position, normal, uv, mask)))
            return shade(
                buffers, light / (light * light).sum() ** 0.5,
                asarray(np.ones(3, np.float32)),
                texture=tex if textured else None,
                camera_position=(asarray(np.zeros(3, np.float32))
                                 if specular else None),
                shininess=24.0,
                **{k: asarray(v) for k, v in extra.items()})
        return fn

    arrays = [np.asarray(gb[n]) for n in names] + [
        texture, np.array([0.35, 0.75, 0.56], np.float32)]
    (out_t, g_t), (out_j, g_j) = _both_grads(
        make(jax_shade, jnp.asarray), make(shade_deferred, torch.tensor),
        arrays)
    _close(out_t, out_j, rtol=0, atol=1e-5)
    for name, got, want in zip(names + ("texture", "light"), g_t, g_j):
        assert torch.isfinite(got).all(), name
        _close(got, want, rtol=1e-4, atol=1e-5)
    assert (np.asarray(gb["mask"]) == 0).any()


def _jax_entry_loss(size, n_lat, n_lon):
    verts, faces, uvs, texture, projection, _ = graft._scene(n_lat, n_lon,
                                                             size)

    def loss(v, pose):
        img = graft._deferred_render(v, pose, faces, uvs, texture,
                                     projection, size, JaxConfig())
        return jnp.mean(img ** 2)

    return loss, verts


@pytest.mark.parametrize("size,n_lat,n_lon", [(96, 8, 12), (128, 12, 16)])
def test_entry_loss_and_gradients_match_jax(size, n_lat, n_lon):
    loss_j, verts = _jax_entry_loss(size, n_lat, n_lon)
    pose = np.array([0.4, 0.3, 0.0], np.float32)
    want, (dv_j, dp_j) = jax.value_and_grad(loss_j, argnums=(0, 1))(
        verts, jnp.asarray(pose))

    step, (verts_t, pose_t) = entry.entry(device="cpu", size=size,
                                          n_lat=n_lat, n_lon=n_lon)
    np.testing.assert_array_equal(verts_t.numpy(), np.asarray(verts))
    np.testing.assert_array_equal(pose_t.numpy(), pose)
    verts_t = verts_t.clone().requires_grad_()
    pose_t = pose_t.clone().requires_grad_()
    got = step(verts_t, pose_t)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6 * float(want)
    for g_t, g_j in ((verts_t.grad, dv_j), (pose_t.grad, dp_j)):
        g_j = np.asarray(g_j)
        assert torch.isfinite(g_t).all()
        assert np.abs(g_t.numpy() - g_j).max() <= 1e-4 * np.abs(g_j).max()
    assert float(verts_t.grad.abs().max()) > 0


def test_deferred_scene_from_numpy_and_entry_defaults():
    scene = _deferred_scene()
    verts, faces, uvs, texture, projection = \
        convert.deferred_scene_from_numpy(*scene, "cpu")
    assert faces.dtype == torch.int64
    assert all(t.dtype == torch.float32
               for t in (verts, uvs, texture, projection))
    assert projection.shape == (4, 4) and texture.shape == (64, 64, 3)
    full = entry.deferred_scene(device="cpu")
    want = graft._scene()
    for got, ref in zip(full, (want[0], want[1], want[2], want[3], want[4])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-7)
    assert full[1].shape == (2208, 3)
    # The G-buffer rides along on request, with its overflow flag.
    small = entry.deferred_scene(6, 8, device="cpu")
    image, gb = entry.deferred_render(
        small[0], torch.tensor([0.4, 0.3, 0.0]), *small[1:], 64,
        with_gbuffer=True)
    assert image.shape == (64, 64, 3) and not bool(gb["overflow"])
    assert {"position", "normal", "uv", "mask", "fid", "zbuf"} <= set(gb)
