"""Shared inputs for the tests/test_torch_*.py parity tests.

Every scene is made with numpy from a seed and handed to both packages as
numpy arrays: ``dirt_tpu`` (JAX on the CPU, Pallas in interpret mode, as
the root conftest arranges) and ``dirt_tpu_torch`` (CPU tensors, so every
kernel wrapper takes its plain PyTorch version).
"""

import numpy as np

from dirt_tpu_torch.core import matrices, mesh

SIZE = 128


def sphere_scene(n_lat=12, n_lon=16, distance=3.0, seed=0, channels=3):
    """The bench camera (``bench.py``) on a small UV sphere.

    Returns numpy (clip-space vertices [V, 4] f32, colors [V, C] f32,
    faces [F, 3] int32). ``distance`` < ~1.1 puts part of the sphere
    behind the near plane, so clipping has work to do.
    """
    verts, faces, _ = mesh.uv_sphere(n_lat, n_lon)
    mv = matrices.compose(
        matrices.rodrigues([0.4, 0.3, 0.0]),
        matrices.translation([0.0, 0.0, -distance]),
    )
    proj = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)
    clip = matrices.transform_homogeneous(verts, matrices.compose(mv, proj))
    colors = np.random.RandomState(seed).rand(len(verts), channels)
    return clip.numpy(), colors.astype(np.float32), faces


def screen_soup(num_faces, height, width, seed, channels=3, spread=25.0):
    """Random screen-space faces [F, 3, 4] (x_s, y_s, z_ndc, invw = 1) and
    attributes [F, 3, C], as numpy f32."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform([5, 5], [width - 5, height - 5], (num_faces, 1, 2))
    xy = centers + rng.uniform(-spread, spread, (num_faces, 3, 2))
    z = rng.uniform(-0.9, 0.9, (num_faces, 1, 1)) + np.zeros((1, 3, 1))
    fv = np.concatenate([xy, z, np.ones((num_faces, 3, 1))], axis=-1)
    attrs = rng.rand(num_faces, 3, channels)
    return fv.astype(np.float32), attrs.astype(np.float32)


def needle_soup(num_faces, height, width, seed, log_length, log_width,
                channels=3):
    """Needle-thin screen-space faces, as ``screen_soup`` returns them: the
    tip on a pixel centre inside the image, the base 10**U(log_length)
    pixels away in a random direction and 10**U(log_width) pixels wide, the
    three corners in a random order (so the table's anchor, corner 0, is
    the tip or a far corner)."""
    rng = np.random.RandomState(seed)
    tip = np.floor(rng.uniform([8, 8], [width - 8, height - 8],
                               (num_faces, 2))) + 0.5
    angle = rng.uniform(0.0, 2.0 * np.pi, num_faces)
    length = 10.0 ** rng.uniform(*log_length, num_faces)
    across = 10.0 ** rng.uniform(*log_width, num_faces)
    along = np.stack([np.cos(angle), np.sin(angle)], 1)
    normal = np.stack([-along[:, 1], along[:, 0]], 1)
    base = (tip + length[:, None] * along)[:, None] + (
        np.array([-0.5, 0.5])[None, :, None] * across[:, None, None]
        * normal[:, None])
    xy = np.concatenate([tip[:, None], base], 1)              # [F, 3, 2]
    order = np.argsort(rng.rand(num_faces, 3), axis=1)
    xy = np.take_along_axis(xy, order[:, :, None], 1)
    z = rng.uniform(-0.9, 0.9, (num_faces, 1, 1)) + np.zeros((1, 3, 1))
    fv = np.concatenate([xy, z, np.ones((num_faces, 3, 1))], axis=-1)
    attrs = rng.rand(num_faces, 3, channels)
    return fv.astype(np.float32), attrs.astype(np.float32)


def clip_soup(num_faces, size, seed, channels=3):
    """Random unconnected triangles in clip space (w = 1), many of them
    larger than a tile, as ``tests/test_streaming.py`` makes them.

    Returns numpy (vertices [3F, 4] f32, colors [3F, C] f32, faces [F, 3]
    int32, background [size, size, C] f32).
    """
    rng = np.random.RandomState(seed)
    verts = rng.uniform(-1.2, 1.2, (3 * num_faces, 4)).astype(np.float32)
    verts[:, 2] = rng.uniform(-0.9, 0.9, 3 * num_faces)
    verts[:, 3] = 1.0
    faces = np.arange(3 * num_faces, dtype=np.int32).reshape(num_faces, 3)
    colors = rng.rand(3 * num_faces, channels).astype(np.float32)
    bg = rng.rand(size, size, channels).astype(np.float32)
    return verts, colors, faces, bg


def sharding_scene(seed=0, num_faces=24, num_verts=30, height=128, width=128):
    """The scene of ``tests/test_sharding.py``: random clip-space triangles
    (w = 1) over a random background. Returns numpy (vertices [V, 4] f32,
    colors [V, 3] f32, faces [F, 3] int32, background [H, W, 3] f32)."""
    rng = np.random.RandomState(seed)
    verts = np.zeros((num_verts, 4), np.float32)
    verts[:, :2] = rng.uniform(-0.9, 0.9, (num_verts, 2))
    verts[:, 2] = rng.uniform(-0.5, 0.5, num_verts)
    verts[:, 3] = 1.0
    faces = rng.randint(0, num_verts, (num_faces, 3)).astype(np.int32)
    colors = rng.uniform(0, 1, (num_verts, 3)).astype(np.float32)
    bg = rng.uniform(0, 1, (height, width, 3)).astype(np.float32)
    return verts, colors, faces, bg


# The caps of tests/test_sharding.py (CFG, CFG_PACKED) and the same dense
# caps under streaming=True, as keyword dicts for either package's
# RasterConfig. The scene's triangles are huge next to the 8 x 16 subtile
# grid, so the packed engine gets explicit caps.
SHARDING_CAPS = {
    "dense": dict(tile_h=8, tile_w=128, bin_cap=64),
    "csr": dict(tile_h=8, tile_w=128, bin_cap=64, streaming=True),
    "packed": dict(tile_h=8, tile_w=128, engine="packed", expand_cap=128,
                   budget=2048),
}


# Lengths of ``ops/scan.max_scan``'s cases: one and two elements, a tile
# (4,096) and its neighbours, three tiles and a ragged end, and the
# 1,001,112-face sphere's pool (``sphere1m_1024``'s ``pool_cap``).
SCAN_LENGTHS = (1, 2, 4095, 4096, 4097, 3 * 4096 + 5, 4_993_724)
# What fills them: int64 values over the whole range, INT64_MIN and
# INT64_MAX planted; one value throughout; a strictly decreasing run, whose
# every running maximum is the first element (on the card it reaches every
# tile from tile 0 through the look-back).
SCAN_KINDS = ("random", "constant", "decreasing")


def scan_input(kind, n, seed=0):
    """A 1-D int64 numpy array of ``n`` elements for the max-scan tests."""
    rng = np.random.RandomState(seed)
    if kind == "random":
        info = np.iinfo(np.int64)
        x = rng.randint(info.min, info.max, n, dtype=np.int64)
        x[rng.randint(0, n, max(n // 1000, 1))] = info.min
        x[rng.randint(0, n, max(n // 100_000, 1))] = info.max
        return x
    if kind == "constant":
        return np.full(n, rng.randint(-2**62, 2**62, dtype=np.int64),
                       np.int64)
    if kind == "decreasing":
        return np.int64(2**40) - np.arange(n, dtype=np.int64) * 3
    raise ValueError(f"no scan input {kind!r}")


# --- the setup VJP (``ops/triangle_setup.setup_planes_vjp``) ----------------

def _area_eps_legs():
    """Legs (u, v) of two right triangles at the origin whose float32
    area2 = u * v is ``float32(AREA_EPS)`` itself (invalid: the test is a
    strict >) and the next float above it (valid, 1 / |area2| ~ 1e10)."""
    from dirt_tpu_torch.ops.triangle_setup import AREA_EPS

    eps = np.float32(AREA_EPS)
    u = np.float32(1e-5)
    v = u + np.arange(-64, 65, dtype=np.float32) * np.spacing(u)
    area = u * v
    return (u, v[area == eps][0]), (u, v[area > eps][0])


def setup_vjp_scenes():
    """{name: (screen-space faces [F, 3, 4], attributes [F, 3, C])}, numpy
    f32, for the setup VJP's tests: random faces at C = 1, 3, 9 and 16
    (both orientations, corners' depths and 1/w apart); invalid faces (zero
    area, three corners on a line, |area2| at ``AREA_EPS`` and the next
    float above it, a corner with invw 0 or below) among valid ones; the
    10,224-face sphere at 1024 x 1024 with its pole slivers; the crossing
    sphere's faces after the near-plane clip at 256 x 256."""
    import torch

    from dirt_tpu_torch.ops.clipping import clip_compact_screen
    from dirt_tpu_torch.ops.triangle_setup import screen_from_clip

    scenes = {}
    for channels in (1, 3, 9, 16):
        fv, fa = screen_soup(256, 1024, 1024, seed=40 + channels,
                             channels=channels, spread=60.0)
        rng = np.random.RandomState(channels)
        fv[..., 2] = rng.uniform(-0.9, 0.9, fv.shape[:2])
        fv[..., 3] = rng.uniform(0.2, 2.0, fv.shape[:2])
        flip = rng.rand(len(fv)) < 0.5
        fv[flip] = fv[flip][:, [0, 2, 1]]
        fa[flip] = fa[flip][:, [0, 2, 1]]
        scenes[f"soup C={channels}"] = (fv, fa)
    fv, fa = screen_soup(16, 256, 256, seed=7)
    fv[0, 2] = fv[0, 0]                                 # zero area
    fv[1, 2, :2] = 2 * fv[1, 1, :2] - fv[1, 0, :2]      # on a line
    at, above = _area_eps_legs()
    for i, (legs, turn) in enumerate(((at, 1), (above, 1), (at, -1),
                                      (above, -1)), start=2):
        fv[i, :, :2] = 0.0
        fv[i, 1, 0], fv[i, 2, 1] = legs                 # x1, y2
        if turn < 0:
            fv[i] = fv[i][[0, 2, 1]]
    fv[6, 1, 3] = 0.0                                   # invw 0
    fv[7, 2, 3] = -0.5                                  # behind the eye
    scenes["invalid"] = (fv, fa)
    clip, colors, faces = sphere_scene(72, 72)
    fv = screen_from_clip(torch.tensor(clip), 1024, 1024).numpy()[faces]
    scenes["sphere 10224"] = (fv, colors[faces])
    clip, colors, faces = sphere_scene(distance=0.9)
    fv, fa, _, _ = clip_compact_screen(torch.tensor(clip)[faces],
                                       torch.tensor(colors)[faces],
                                       len(faces), 256, 256)
    scenes["clipped sphere"] = (fv.numpy(), fa.numpy())
    return scenes


def setup_vjp_cotangents(num_faces, channels, seed):
    """Random cotangents (d_geo [F, 24], d_att [F, 3C]) numpy f32 for the
    setup VJP, every column of d_geo filled (its padding too, which the VJP
    must not read)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(num_faces, 24).astype(np.float32),
            rng.randn(num_faces, 3 * channels).astype(np.float32))


# --- the forward setup (``ops/triangle_setup.setup_faces``) -----------------

# The image the forward setup's scenes are culled and clipped to: not
# square, so a swapped height and width shows.
SETUP_IMAGE = (200, 312)


def setup_fwd_scenes():
    """{name: (screen-space faces [F, 3, 4], attributes [F, 3, C])}, numpy
    f32, for the forward setup's tests. ``hazards C=...``: 301 random faces
    over and around the ``SETUP_IMAGE`` (both orientations, every corner's
    depth in [-1.5, 1.5] and 1/w in [-0.2, 2]), then the faces each rule of
    the setup singles out: zero area, three corners on a line, |area2| at
    ``AREA_EPS`` and the next float above it, invw 0 and below, a NaN in
    each corner field, corners far off the image (beyond the int32 range,
    infinite) that the saturating convert keeps, z wholly beyond either
    plane and straddling both, faces just off each side of the image, an
    infinite attribute; at C = 1, 3, 9 and 16. Also the VJP's spheres
    (``setup_vjp_scenes``)."""
    height, width = SETUP_IMAGE
    scenes = {}
    for channels in (1, 3, 9, 16):
        rng = np.random.RandomState(60 + channels)
        n = 301
        centers = rng.uniform([-40, -40], [width + 40, height + 40],
                              (n, 1, 2))
        xy = centers + rng.uniform(-30, 30, (n, 3, 2))
        z = rng.uniform(-1.5, 1.5, (n, 3, 1))
        w = rng.uniform(-0.2, 2.0, (n, 3, 1))
        fv = np.concatenate([xy, z, w], axis=-1).astype(np.float32)
        fa = rng.rand(n, 3, channels).astype(np.float32)
        flip = rng.rand(n) < 0.5
        fv[flip] = fv[flip][:, [0, 2, 1]]
        base = np.float32([[40.0, 30.0, 0.1, 1.0], [90.0, 50.0, 0.2, 1.5],
                           [60.0, 110.0, 0.3, 0.8]])
        hazards = []

        def face(changes):
            f = base.copy()
            for (corner, field), value in changes.items():
                f[corner, field] = value
            hazards.append(f)

        face({(2, 0): 40.0, (2, 1): 30.0})             # zero area
        face({(2, 0): 140.0, (2, 1): 70.0})            # on a line
        for legs, turn in zip(_area_eps_legs(), (1, -1)):
            f = np.zeros((3, 4), np.float32)
            f[:, 3] = 1.0
            f[1, 0], f[2, 1] = legs
            hazards.append(f if turn > 0 else f[[0, 2, 1]])
        face({(1, 3): 0.0})                            # invw 0
        face({(2, 3): -0.5})                           # behind the eye
        for corner, field in ((1, 0), (2, 1), (0, 2), (1, 3), (0, 0)):
            face({(corner, field): np.nan})
        for corner, field, value in ((2, 0, 3e9), (2, 1, 5e9),
                                     (0, 0, -3e9), (1, 1, -4e9),
                                     (2, 0, np.inf), (1, 1, -np.inf),
                                     (0, 1, 2.5e9)):
            face({(corner, field): value})
        face({(k, 2): 1.5 for k in range(3)})          # beyond far
        face({(k, 2): -1.5 for k in range(3)})         # before near
        face({(0, 2): -2.0, (1, 2): 0.0, (2, 2): 2.0})  # straddling
        for dx, dy in ((-120.5, 0), (width - 39.5, 0), (0, -140.5),
                       (0, height - 29.5)):
            f = base.copy()
            f[:, 0] += dx
            f[:, 1] += dy
            hazards.append(f)
        fv = np.concatenate([fv, np.stack(hazards)])
        extra = rng.rand(len(hazards), 3, channels).astype(np.float32)
        extra[-1, 1, 0] = np.inf
        scenes[f"hazards C={channels}"] = (fv, np.concatenate([fa, extra]))
    vjp = setup_vjp_scenes()
    for name in ("sphere 10224", "clipped sphere"):
        scenes[name] = vjp[name]
    return scenes


def bits_equal(a, b):
    """Tensors ``a`` and ``b`` alike in shape and dtype and equal bit for
    bit, where a float is NaN in one exactly where it is in the other
    (NaN payloads aside)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = a.isnan()
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return torch.equal(nan, b.isnan()) and torch.equal(
        a[~nan].view(bits), b[~nan].view(bits))


def budget_row_gathers(run, budget_rows):
    """The gathers ``run()`` makes whose output is a 2-D array of
    ``budget_rows`` rows (a row per packed job, as a copy of the face
    table in budget-row order is): [(operator, shape)], from every
    operator's outputs under a dispatch mode, forward and backward
    alike."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    found = []

    class Outputs(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.__name__.split(".")[0]
            if name in ("index", "index_select", "gather", "take"):
                found.extend(
                    (name, tuple(t.shape)) for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor) and t.ndim == 2
                    and t.shape[0] == budget_rows)
            return out

    with Outputs():
        run()
    return found
