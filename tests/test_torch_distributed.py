"""The sharded renderers over ``torch.distributed`` (gloo, CPU).

Each test starts 2 or 4 processes with ``torch.multiprocessing.spawn`` (the
workers live in ``_torch_port_dist.py``, which imports no jax); they join a
gloo group through a ``file://`` store in ``tmp_path``, render their slab
with halo rows sent by ``batch_isend_irecv`` and sum the parameter
gradients with ``all_reduce``. What the ranks end with is held against the
local group's result for the same number of slabs. The overlapped backward
(``rasterise_sharded(overlap_chunks=2)``) sums the parameter gradients in
its own op, chunk by chunk, and the face-sharded renderer composites with
``all_reduce(MIN)`` and routes face rows with ``all_gather`` and
``reduce_scatter_tensor``: on a local group every sum over members is a sum
in one process, so these runs are where a gradient summed twice, or not at
all, shows.

Tolerances: image rows and background gradients equal (the same ops on the
same inputs); vertex and color gradients within 1e-5 of the largest
magnitude (the group sums the slabs' gradients after the vertex chain, the
local group before it, and in another order).
"""

import time

import pytest
import torch
import torch.multiprocessing as mp

import _torch_port_dist as workers
from dirt_tpu_torch import entry
from dirt_tpu_torch.parallel import multihost
from dirt_tpu_torch.parallel.group import LocalGroup

JOIN_SECONDS = 120


def _run(worker, world, tmp_path, *args):
    """Spawn ``world`` ranks of ``worker`` and return what each saved. A
    rank that hangs fails the test at ``JOIN_SECONDS``."""
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    context = mp.spawn(worker, args=(world, str(tmp_path / "store"),
                                     str(out_dir), *args),
                       nprocs=world, join=False)
    deadline = time.monotonic() + JOIN_SECONDS
    try:
        while not context.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"{worker.__name__}: ranks still running after "
                            f"{JOIN_SECONDS} s")
    finally:
        for process in context.processes:
            if process.is_alive():
                process.kill()
    return [torch.load(out_dir / f"rank{r}.pt") for r in range(world)]


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _check_against_local(ranks, want):
    """Rows concatenated over the ranks give the local group's image and
    background gradient; every rank holds the summed parameter gradients."""
    assert torch.equal(torch.cat([r["image"] for r in ranks]), want["image"])
    assert torch.equal(sum(r["background"] for r in ranks),
                       want["background"])
    slab_h = want["image"].shape[0] // len(ranks)
    for i, r in enumerate(ranks):
        outside = r["background"].clone()
        outside[i * slab_h:(i + 1) * slab_h] = 0
        assert not outside.any()            # nonzero on the held rows only
        for name in ("verts", "colors"):
            assert _rel(r[name], want[name]) <= 1e-5, (i, name)
    assert want["verts"].abs().max() > 0


@pytest.mark.parametrize("world,engine", [
    (2, "dense"), (4, "dense"), (2, "csr"), (4, "csr"), (2, "packed"),
    (4, "packed")])
def test_gloo_ranks_match_local_group(tmp_path, world, engine):
    ranks = _run(workers.sharded_worker, world, tmp_path, engine)
    _check_against_local(ranks, workers.scene_step(LocalGroup(world),
                                                   engine))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("path,engine", [("overlap", "packed"),
                                         ("face_sharded", "dense")])
def test_gloo_ranks_match_local_group_new_paths(tmp_path, path, engine,
                                                world):
    ranks = _run(workers.sharded_worker, world, tmp_path, engine, path)
    _check_against_local(ranks, workers.scene_step(LocalGroup(world), engine,
                                                   path=path))


def test_two_level_mesh_groups_and_gradients(tmp_path):
    """data=2 x dcn=1 x tiles=2 over four ranks: rank = d * 2 + t, each data
    index renders its own scene over its own row group."""
    ranks = _run(workers.two_level_worker, 4, tmp_path, 2, 2)
    for rank, r in enumerate(ranks):
        assert r["shape"] == (2, 1, 2)
        assert r["row_ranks"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
        assert (r["data_index"], r["data_size"]) == (rank // 2, 2)
    for d in range(2):
        _check_against_local(ranks[2 * d:2 * d + 2], workers.scene_step(
            LocalGroup(2), "dense", seed=3 + d))


def test_two_level_rows_shard_host_major(tmp_path):
    """data=1 x dcn=2 x tiles=2: one flattened row group in rank order."""
    ranks = _run(workers.two_level_worker, 4, tmp_path, 2, 1)
    for r in ranks:
        assert r["shape"] == (1, 2, 2) and r["row_ranks"] == [0, 1, 2, 3]
    _check_against_local(ranks, workers.scene_step(LocalGroup(4), "dense"))


def test_dryrun_multichip_over_gloo_matches_local(tmp_path):
    """All four variants; ranks 2 and 3 are outside the overlap variant's
    group of the first two."""
    want = entry.dryrun_multichip(4, "cpu")
    assert want["loss_overlap"] is not None
    for rank, got in enumerate(_run(workers.dryrun_worker, 4, tmp_path)):
        for key, value in want.items():
            if rank >= 2 and key in ("loss_overlap", "grad_overlap"):
                assert got[key] is None, key
            else:
                assert got[key] == pytest.approx(value, rel=1e-5), key


def test_init_distributed_single_process(monkeypatch):
    for name in ("DIRT_COORDINATOR", "DIRT_NUM_PROCESSES",
                 "DIRT_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.init_distributed() is False
    assert not torch.distributed.is_initialized()
    layout = multihost.make_render_mesh(tiles_per_host=2, local_size=4)
    assert layout.shape == (1, 2, 2)
    assert isinstance(layout.rows, LocalGroup) and layout.rows.size == 4
    with pytest.raises(ValueError, match="do not factor"):
        multihost.make_render_mesh(tiles_per_host=3, local_size=4)
    with pytest.raises(ValueError, match="coordinator"):
        multihost.init_distributed(num_processes=2, process_id=0)
