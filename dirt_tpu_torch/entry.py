"""The flagship step: deferred G-buffer render + shading + L2 loss.

Counterpart of ``__graft_entry__.entry()`` of the JAX package (its
single-device half): a textured, Phong-lit UV sphere rendered through
``render_gbuffer`` (9 channels: position, normal, uv, mask) and
``shade_deferred``, and the mean squared error against a black target.
The loss is differentiable w.r.t. the object-space vertices and the pose.
:func:`entry_step` is its value and gradient as one CUDA-graph replay.
:func:`dryrun_multichip` is the counterpart of its multi-device half: one
training step over a data x rows layout, and renders over a two-level row
group, with the overlapped backward and over a face group.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dirt_tpu_torch.core import lighting, matrices, mesh
from dirt_tpu_torch.ops.raster import RasterConfig
from dirt_tpu_torch.render.deferred import shade_deferred
from dirt_tpu_torch.render.gbuffer import render_gbuffer
from dirt_tpu_torch.utils.graphstep import GraphedStep, value_and_grad


def deferred_scene(n_lat: int = 24, n_lon: int = 48, device="cuda",
                   checker: tuple[int, int] = (64, 8)):
    """(verts_obj [V, 3], faces [F, 3], uvs [V, 2], texture, projection)
    of the flagship scene, as tensors on ``device``. ``checker`` is the
    texture's (size, squares): the flagship's 64 / 8, or demo 5's 128 / 10."""
    from dirt_tpu_torch.convert import deferred_scene_from_numpy

    verts_obj, faces, uvs = mesh.uv_sphere(n_lat=n_lat, n_lon=n_lon)
    texture = mesh.checkerboard_texture(*checker, 3)
    projection = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)
    return deferred_scene_from_numpy(verts_obj, faces, uvs, texture,
                                     projection.numpy(), device)


@functools.cache
def _light_and_offset(device: torch.device):
    """(unit light direction, the world offset 3 units down -z) on
    ``device``, made once per device: a tensor made from Python data is a
    copy from the host, which a CUDA-graph capture refuses (a graphed step's
    warm-up calls make these before its capture)."""
    light_dir = torch.tensor([0.35, 0.75, 0.56], device=device)
    return (light_dir / torch.linalg.norm(light_dir),
            torch.tensor([0.0, 0.0, -3.0], device=device))


def deferred_render(verts_obj, pose, faces, uvs, texture, projection,
                    size: int, config: RasterConfig | None = None,
                    with_gbuffer: bool = False):
    """[size, size, 3] image of the posed, textured, lit mesh.

    World transform (Rodrigues ``pose``, 3 units down -z), smooth normals,
    projection, G-buffer (position | normal | uv | mask), deferred shading
    with ambient 0.12 and a Phong highlight (shininess 24) seen from the
    origin. Runs on the device of ``verts_obj``. ``with_gbuffer`` also
    returns the G-buffer dict (whose "overflow" flag says whether a raster
    cap truncated the render).
    """
    device = verts_obj.device
    light_dir, offset = _light_and_offset(device)
    model = matrices.compose(
        matrices.rodrigues(torch.as_tensor(pose, dtype=torch.float32,
                                           device=device)),
        matrices.translation(offset),
    )
    world = matrices.transform_homogeneous(verts_obj, model)[..., :3]
    normals = lighting.vertex_normals(world, faces)
    ones = torch.ones(world.shape[:-1] + (1,), dtype=world.dtype,
                      device=device)
    clip = torch.cat([world, ones], dim=-1) @ projection
    gb = render_gbuffer(
        clip, faces, {"position": world, "normal": normals, "uv": uvs},
        size, size, config=config,
    )
    image = shade_deferred(
        gb, light_dir, torch.ones(3, device=device), ambient=0.12,
        texture=texture, camera_position=torch.zeros(3, device=device),
        shininess=24.0,
    )
    return (image, gb) if with_gbuffer else image


def entry(device="cuda", size: int = 256, n_lat: int = 24, n_lon: int = 48):
    """(forward_step, example_args): the flagship loss on one device.

    ``forward_step(verts, pose)`` renders the default scene (a 2,208-face
    sphere at 256 x 256, auto config: the dense engine) and returns the mean
    squared error against a black target. Runs on the card unless
    ``device`` says otherwise.
    """
    verts_obj, faces, uvs, texture, projection = deferred_scene(
        n_lat, n_lon, device=device)
    config = RasterConfig()

    def forward_step(verts, pose):
        img = deferred_render(verts, pose, faces, uvs, texture, projection,
                              size, config)
        return torch.mean(img ** 2)

    pose = torch.tensor([0.4, 0.3, 0.0], device=verts_obj.device)
    return forward_step, (verts_obj, pose)


def entry_step(device="cuda", size: int = 256, n_lat: int = 24,
               n_lon: int = 48):
    """(step, example_args): the flagship step as one CUDA-graph replay.

    ``step(verts, pose)`` returns (loss, d_verts, d_pose) of
    :func:`entry`'s ``forward_step`` (``graphstep.value_and_grad``) through
    a ``GraphedStep`` captured here on the example arguments, the
    counterpart of ``jax.jit`` of the flagship loss and of the gradient that
    ``__graft_entry__``'s train step takes. The outputs are the graph's own
    tensors, overwritten by the next call. On the CPU (``device="cpu"``) the
    step runs eagerly.
    """
    forward_step, args = entry(device, size, n_lat, n_lon)
    return GraphedStep(value_and_grad(forward_step), args), args


def dryrun_multichip(n_devices: int, device="cuda", steps: int = 1):
    """Sharded training steps over ``n_devices`` slabs (tiny shapes).

    Counterpart of ``__graft_entry__.dryrun_multichip`` (its four
    variants). The layout is ``parallel.multihost.make_render_mesh``'s: the
    ranks of ``torch.distributed`` where it is initialised (``n_devices``
    must then be its world size), else local groups that play all
    ``n_devices`` slabs in this process on ``device``.

    1. A data x tiles training step: each scene of the batch (data axis)
       renders a 6-channel G-buffer (normal | uv | mask) of a 64-face sphere
       at 64 x 64 through ``slab_render`` on the packed engine, rows sharded
       over the tiles axis with halo-exchanged silhouette gradients;
       ``shade_deferred``; the squared error summed over both axes; one Adam
       update of the per-vertex bump field (``steps`` of them; the JAX
       dry run takes one).
    2. For ``n_devices >= 4`` and even: ``rasterise_sharded`` of a 24-face
       random scene at 64 x 128 on the dense engine over a two-level (dcn=2
       x tiles) row group, value and vertex gradient.
    3. For ``n_devices >= 2``: the same scene through
       ``rasterise_sharded(overlap_chunks=2)`` over a row group of the first
       two members, packed engine (``parallel.overlap``).
    4. For ``n_devices >= 4``: the same scene through
       ``rasterise_face_sharded`` over a face group of the first four
       members, dense engine (``parallel.face_sharding``).

    Variants 2-4 render one image, so their values agree. Under
    ``torch.distributed`` every rank makes the groups of variants 3 and 4,
    and a rank outside a group takes no part in its variant.

    Prints one line per variant run and returns their numbers:
    ``{"loss", "losses", "step", "loss_two_level", "grad_two_level",
    "loss_overlap", "grad_overlap", "loss_face_sharded",
    "grad_face_sharded"}``: the first step's loss, every step's, the
    largest bump after the last step, and variants 2-4's value and largest
    vertex gradient (None when the variant does not run, or runs without
    this rank). Runs on the card unless ``device`` says otherwise.
    """
    import torch.distributed as dist

    from dirt_tpu_torch.parallel.face_sharding import rasterise_face_sharded
    from dirt_tpu_torch.parallel.group import DistGroup, LocalGroup
    from dirt_tpu_torch.parallel.multihost import make_render_mesh
    from dirt_tpu_torch.parallel.sharding import rasterise_sharded, slab_render

    device = torch.device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    data = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    tiles = n_devices // data
    layout = make_render_mesh(tiles_per_host=tiles, data=data,
                              local_size=n_devices)

    size = 64
    # Explicit caps: the dense-mesh auto heuristics assume bigger scenes.
    config = RasterConfig(tile_h=8, tile_w=128, engine="packed",
                          expand_cap=16, budget=1024)
    verts_np, faces_np, uvs_np = mesh.uv_sphere(n_lat=6, n_lon=8)
    verts_obj, uvs = f32(verts_np), f32(uvs_np)
    faces = torch.as_tensor(faces_np.astype(np.int64), device=device)
    texture = f32(mesh.checkerboard_texture(16, 4, 3))
    projection = matrices.perspective_projection(0.1, 20.0, 0.045,
                                                 1.0).to(device)
    light_dir = f32([0.35, 0.75, 0.56])
    light_dir = light_dir / torch.linalg.norm(light_dir)
    poses = f32([[0.4, 0.3, 0.0], [0.1, 0.6, 0.2]][:data])
    held = len(layout.rows.local) * (size // tiles)

    def scene_error(bump, pose):
        """Squared error of one scene over the rows this process holds."""
        verts = verts_obj * (1.0 + bump[:, None])
        model = matrices.compose(
            matrices.rodrigues(pose),
            matrices.translation(f32([0.0, 0.0, -3.0])),
        )
        world = matrices.transform_homogeneous(verts, model)[..., :3]
        normals = lighting.vertex_normals(world, faces)
        ones = torch.ones_like(world[:, :1])
        clip = torch.cat([world, ones], dim=-1) @ projection
        # G-buffer channels: normal(3) | uv(2) | mask(1), slab-sharded.
        attrs = torch.cat([normals, uvs, ones], dim=-1)
        gbuf = slab_render(torch.zeros((held, size, 6), device=device), clip,
                           attrs, faces, size, size, layout.rows, config)
        gb = {"normal": gbuf[..., 0:3], "uv": gbuf[..., 3:5],
              "mask": gbuf[..., 5:6]}
        img = shade_deferred(gb, light_dir, torch.ones(3, device=device),
                             ambient=0.12, texture=texture)
        return torch.sum(img ** 2)                  # the target is black

    params = torch.zeros(verts_obj.shape[0], device=device,
                         requires_grad=True)        # per-vertex bump field
    opt = torch.optim.Adam([params], lr=1e-2)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        bump = layout.data.replicated(params)
        total = sum(scene_error(bump, poses[d]) for d in layout.data.local)
        total = layout.data.all_reduce_sum(layout.rows.all_reduce_sum(total))
        loss = total / (data * size * size * 3)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    out = {"loss": losses[0], "losses": losses,
           "step": float(params.detach().abs().max()),
           "loss_two_level": None, "grad_two_level": None,
           "loss_overlap": None, "grad_overlap": None,
           "loss_face_sharded": None, "grad_face_sharded": None}
    print(f"dryrun_multichip OK: {n_devices} devices (data={data} x "
          f"tiles={tiles}), loss={out['loss']:.5f}, "
          f"|grad step|={out['step']:.2e}")

    # Small random scene shared by the remaining variants.
    rng = np.random.RandomState(0)
    verts2 = f32(np.concatenate(
        [rng.uniform(-0.8, 0.8, (30, 2)),
         rng.uniform(-0.5, 0.5, (30, 1)), np.ones((30, 1))], axis=1))
    faces2 = torch.as_tensor(rng.randint(0, 30, (24, 3)), device=device)
    colors2 = f32(rng.rand(30, 3))
    bg2 = torch.zeros((64, 128, 3), device=device)
    cfg2 = RasterConfig(tile_h=8, tile_w=128, bin_cap=64)

    def value_and_grad(render, group):
        """sum(image ** 2) over the whole image and its largest vertex
        gradient, or (None, None) on a rank outside ``group``."""
        if group is None:
            return None, None
        verts = verts2.clone().requires_grad_()
        img = render(verts, group)
        value = group.all_reduce_sum(torch.sum(img * img))
        value.backward()
        return float(value.detach()), float(verts.grad.abs().max())

    def first(count):
        """A group of the first ``count`` members (None on a rank outside
        it); every rank makes each group, in one order."""
        if not dist.is_initialized():
            return LocalGroup(count)
        ranks = list(range(count))
        made = dist.new_group(ranks)
        return DistGroup(ranks, made) if dist.get_rank() in ranks else None

    if n_devices >= 4 and n_devices % 2 == 0:
        # Two-level variant: rows shard dcn-major over the flattened (dcn,
        # tiles) group, so each host owns a contiguous band.
        layout2 = make_render_mesh(tiles_per_host=n_devices // 2, data=1,
                                   local_size=n_devices)
        out["loss_two_level"], out["grad_two_level"] = value_and_grad(
            lambda v, group: rasterise_sharded(bg2, v, colors2, faces2, group,
                                               config=cfg2), layout2.rows)
        print(f"dryrun_multichip two-level mesh OK: data=1 x dcn=2 x "
              f"tiles={n_devices // 2}, loss={out['loss_two_level']:.4f}, "
              f"|d verts|={out['grad_two_level']:.2e}")

    if n_devices >= 2:
        # The overlapped backward: the packed backward in budget-chunk
        # slices, each slice's parameter gradients summed at once.
        # expand_cap covers the worst slab-local span (8 x 4 subtiles on a
        # 32 x 128 slab): a cut would change the image.
        cfg3 = RasterConfig(tile_h=8, tile_w=128, engine="packed",
                            expand_cap=32, budget=1024)
        out["loss_overlap"], out["grad_overlap"] = value_and_grad(
            lambda v, group: rasterise_sharded(bg2, v, colors2, faces2, group,
                                               config=cfg3, overlap_chunks=2),
            first(2))
        if out["loss_overlap"] is not None:
            print(f"dryrun_multichip overlap_chunks=2 OK: tiles=2, "
                  f"loss={out['loss_overlap']:.4f}, "
                  f"|d verts|={out['grad_overlap']:.2e}")

    if n_devices >= 4:
        # Face-list sharding: faces split over the group, min-depth
        # composite, rows x faces backward.
        out["loss_face_sharded"], out["grad_face_sharded"] = value_and_grad(
            lambda v, group: rasterise_face_sharded(bg2, v, colors2, faces2,
                                                    group, config=cfg2),
            first(4))
        if out["loss_face_sharded"] is not None:
            print(f"dryrun_multichip face-sharded OK: faces=4, "
                  f"loss={out['loss_face_sharded']:.4f}, "
                  f"|d verts|={out['grad_face_sharded']:.2e}")
    return out
