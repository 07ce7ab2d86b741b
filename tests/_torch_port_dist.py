"""Worker functions of tests/test_torch_distributed.py.

Each runs in a process started by ``torch.multiprocessing.spawn``, which
imports this module anew: it imports torch and the port only, so no child
loads jax. A worker joins a gloo group through a ``file://`` store, runs
its part of the row-sharded renderer (or of the overlapped or the
face-sharded one) and saves what it ends with to ``<out_dir>/rank<r>.pt``
for the parent to compare.
"""

import datetime
from pathlib import Path

import torch
import torch.distributed as dist

from _torch_port_scene import SHARDING_CAPS, sharding_scene
from dirt_tpu_torch import RasterConfig, entry
from dirt_tpu_torch.parallel.face_sharding import rasterise_face_sharded
from dirt_tpu_torch.parallel.group import DistGroup
from dirt_tpu_torch.parallel.multihost import make_render_mesh
from dirt_tpu_torch.parallel.sharding import rasterise_sharded

# The renderers a worker can run, by name.
PATHS = {
    "sharded": rasterise_sharded,
    "overlap": lambda *args, **kwargs: rasterise_sharded(
        *args, overlap_chunks=2, **kwargs),
    "face_sharded": rasterise_face_sharded,
}


def _join(rank, world, store):
    # One thread per rank: the suite's other workers share the cores.
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))


def scene_step(group, engine, seed=3, path="sharded"):
    """Image rows and gradients of ``0.5 * sum(image ** 2)`` through the
    renderer ``PATHS[path]`` on ``sharding_scene(seed)``; the loss is the
    held rows' part, as each rank of a group computes it."""
    verts, colors, faces, bg = (torch.tensor(a)
                                for a in sharding_scene(seed))
    leaves = [t.clone().requires_grad_() for t in (verts, colors, bg)]
    image = PATHS[path](leaves[2], leaves[0], leaves[1], faces, group,
                        config=RasterConfig(**SHARDING_CAPS[engine]))
    (0.5 * (image ** 2).sum()).backward()
    return {"image": image.detach(), "verts": leaves[0].grad,
            "colors": leaves[1].grad, "background": leaves[2].grad}


def sharded_worker(rank, world, store, out_dir, engine, path="sharded"):
    _join(rank, world, store)
    out = scene_step(DistGroup(), engine, path=path)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def two_level_worker(rank, world, store, out_dir, tiles_per_host, data):
    """The (data, dcn, tiles) layout: each data index renders its own scene
    (seed 3 + d) over its flattened row group."""
    _join(rank, world, store)
    layout = make_render_mesh(tiles_per_host=tiles_per_host, data=data)
    out = scene_step(layout.rows, "dense", seed=3 + layout.data.local[0])
    out.update(shape=layout.shape, row_ranks=layout.rows.ranks,
               data_index=layout.data.local[0],
               data_size=layout.data.size)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def dryrun_worker(rank, world, store, out_dir):
    _join(rank, world, store)
    torch.save(entry.dryrun_multichip(world, "cpu"),
               Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()
