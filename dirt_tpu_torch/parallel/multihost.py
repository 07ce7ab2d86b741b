"""Multi-process rendering groups (host-major row bands).

Counterpart of ``dirt_tpu/parallel/multihost.py``:

* :func:`init_distributed` starts ``torch.distributed`` from arguments or
  the ``DIRT_COORDINATOR`` / ``DIRT_NUM_PROCESSES`` / ``DIRT_PROCESS_ID``
  environment variables, and is a no-op returning False when the program
  runs as a single process.
* :func:`make_render_mesh` lays the processes out as (data, dcn, tiles),
  rank = (d * dcn + h) * tiles + t, as the JAX mesh lays out its host-major
  device list. Image rows shard over the COMBINED (dcn, tiles) pair,
  dcn-major: one flattened row group per data index, in rank order, so each
  host owns one contiguous band of rows, subdivided into per-card slabs,
  and the backward's one-row halo crosses hosts only at band boundaries.
  That group is what ``rasterise_sharded`` takes where the JAX function
  takes ``axis=("dcn", "tiles")``. Parameter gradients are summed over the
  row group and, by the caller, over the data group.

Without ``torch.distributed`` the same layout is built from local groups
(``group.LocalGroup``): one process plays every slab, so the code path is
the one a multi-process deployment runs.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from dirt_tpu_torch.parallel.group import DistGroup, LocalGroup


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialise ``torch.distributed`` from args or the DIRT_* variables.

    Returns True if a multi-process runtime was initialised, False when
    running single-process (no-op), so it is safe to call unconditionally
    at program start. ``coordinator_address`` is ``host:port`` of rank 0.
    The backend is NCCL where a CUDA device is present, else gloo.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "DIRT_COORDINATOR")
    num = num_processes if num_processes is not None else int(
        os.environ.get("DIRT_NUM_PROCESSES", "0"))
    pid = process_id if process_id is not None else int(
        os.environ.get("DIRT_PROCESS_ID", "-1"))
    if coordinator_address is None and num <= 1:
        return False
    if coordinator_address is None or num < 1 or pid < 0:
        raise ValueError(
            "init_distributed needs the coordinator's address, the number "
            "of processes and this process's id (arguments, or "
            "DIRT_COORDINATOR, DIRT_NUM_PROCESSES and DIRT_PROCESS_ID); got "
            f"{coordinator_address!r}, {num}, {pid}")
    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo", world_size=num,
        rank=pid, init_method=f"tcp://{coordinator_address}")
    return True


class RenderMesh(NamedTuple):
    """The groups this process belongs to, and the layout's shape."""

    rows: object        # the flattened (dcn, tiles) row group, host-major
    data: object        # the data (scene batch) group
    shape: tuple        # (data, dcn, tiles)


def make_render_mesh(tiles_per_host: int | None = None, data: int = 1,
                     local_size: int | None = None) -> RenderMesh:
    """A (data, dcn, tiles) layout of the processes, host-major on dcn.

    Args:
        tiles_per_host: slabs per host band (default: all processes after
            the data axis, one band).
        data: data-parallel axis size (scene batching).
        local_size: without ``torch.distributed``, the number of slabs and
            scenes this one process plays (default 1).
    Returns:
        RenderMesh. With ``torch.distributed`` initialised its groups are
        ``DistGroup``s over ``dist.new_group`` (every process must make this
        call, with the same arguments); otherwise ``LocalGroup``s.
    """
    distributed = dist.is_initialized()
    world = dist.get_world_size() if distributed else (local_size or 1)
    if tiles_per_host is None:
        tiles_per_host = max(world // data, 1)
    dcn = world // (data * tiles_per_host)
    if data * dcn * tiles_per_host != world:
        raise ValueError(
            f"{world} processes do not factor into data={data} x dcn={dcn} "
            f"x tiles={tiles_per_host}")
    band = dcn * tiles_per_host
    shape = (data, dcn, tiles_per_host)
    if not distributed:
        return RenderMesh(LocalGroup(band), LocalGroup(data), shape)
    if data == 1:
        return RenderMesh(DistGroup(), LocalGroup(1), shape)
    rank = dist.get_rank()
    rows = data_group = None
    # Every process creates every group, in one order.
    for d in range(data):
        ranks = [d * band + r for r in range(band)]
        made = dist.new_group(ranks)
        if rank in ranks:
            rows = DistGroup(ranks, made)
    for r in range(band):
        ranks = [d * band + r for d in range(data)]
        made = dist.new_group(ranks)
        if rank in ranks:
            data_group = DistGroup(ranks, made)
    return RenderMesh(rows, data_group, shape)
