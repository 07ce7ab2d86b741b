"""The port's profilers (``tools/prof_torch_*.py``) and the binning's
``_stage`` hook, on the CPU at small sizes.

``bin_faces_packed(..., _stage=k)`` of the port against ``dirt_tpu``'s on
the same inputs (a 12 x 16 UV sphere at 128 x 128 with the edge filter, its
suggested packed caps), for all ten stages, with ``work_cap=None`` and with
the suggested ``work_cap``: checksums equal modulo 2**32 (``dirt_tpu``
sums in int32, which wraps; the port in int64). ``_stage=0`` gives the bins
of the call without it, field by field. The stage tool's staged forward
(setup, binning, the raster kernel's plain version) equals
``rasterise_with_aux`` bit for bit, and its backward pieces (prologue,
entry rows, pool reduce) ``backward_packed``; the binning tool times
``binning._cummax`` beside ``torch.cummax``; the parallel tool's
variants over one member give the plain step's fid and gradients within
1e-4 of max |gradient| (its ``run`` raises otherwise). Each tool's ``run``
goes through at 64 x 64 with the profiler off, and its ``main`` exits
non-zero without a card. Each JAX program is compiled once per file
(``lru_cache``).
"""

import functools
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_scene import SIZE, sphere_scene
from dirt_tpu.ops import binning as jb
from dirt_tpu.ops import triangle_setup as jt
import dirt_tpu_torch
from dirt_tpu_torch.ops import binning as tb
from dirt_tpu_torch.ops import raster as tr
from dirt_tpu_torch.ops import triangle_setup as tt

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import prof_torch_binning  # noqa: E402
import prof_torch_parallel  # noqa: E402
import prof_torch_stages  # noqa: E402
from card_common import bench_scene  # noqa: E402

STAGES = (11, 12, 13, 1, 2, 3, 4, 5, 6, 7)
# The tools' scene on the CPU: a 1,104-face bench sphere at 64 x 64 under
# the packed engine (the auto engine would pick dense below 4,096 faces).
TOOL_SIZE = 64
TOOL_LAT = 24


@functools.lru_cache(maxsize=None)
def _bin_inputs():
    """(bbox, edges, caps) of the sphere: bbox and edges as numpy, caps
    the packed config ``suggest_config`` measures."""
    clip, _, faces = sphere_scene()
    fv = np.asarray(jt.screen_from_clip(clip, SIZE, SIZE))[faces]
    fa = np.zeros(fv.shape[:2] + (1,), np.float32)
    valid = tt.setup_planes(torch.tensor(fv), torch.tensor(fa))[2]
    bbox = [c.numpy() for c in tt.face_bbox_cols(torch.tensor(fv), valid,
                                                 SIZE, SIZE)]
    edges = [c.numpy() for c in tt.edge_filter_cols(torch.tensor(fv))]
    config = tr.suggest_config(torch.tensor(fv), SIZE, SIZE,
                               config=tr.RasterConfig(engine="packed"))
    return bbox, edges, config


def _args(config, work_cap):
    return ((SIZE, SIZE, config.tile_h, config.tile_w, config.budget,
             config.expand_cap),
            dict(pool_cap=config.pool_cap, work_cap=work_cap))


@functools.lru_cache(maxsize=None)
def _jax_checksum(stage, work_cap):
    bbox, edges, config = _bin_inputs()
    args, kw = _args(config, work_cap)
    fn = jax.jit(lambda b, e: jb.bin_faces_packed(b, *args, edges=e,
                                                  _stage=stage, **kw))
    return int(fn(tuple(jnp.asarray(c) for c in bbox),
                  [jnp.asarray(c) for c in edges]))


def _port_bins(stage, work_cap):
    bbox, edges, config = _bin_inputs()
    args, kw = _args(config, work_cap)
    return tb.bin_faces_packed(
        tuple(torch.tensor(c) for c in bbox), *args,
        edges=[torch.tensor(c) for c in edges], _stage=stage, **kw)


@pytest.mark.parametrize("stage", STAGES)
def test_stage_checksum_matches_dirt_tpu(stage):
    _, _, config = _bin_inputs()
    assert config.work_cap is not None
    for work_cap in (None, config.work_cap):
        got = _port_bins(stage, work_cap)
        assert got.dtype == torch.int64 and got.dim() == 0
        assert int(got) % 2**32 == _jax_checksum(stage, work_cap) % 2**32, \
            (stage, work_cap)


def test_stage_zero_is_the_default_call():
    bbox, edges, config = _bin_inputs()
    args, kw = _args(config, config.work_cap)
    default = tb.bin_faces_packed(
        tuple(torch.tensor(c) for c in bbox), *args,
        edges=[torch.tensor(c) for c in edges], **kw)
    zero = _port_bins(0, config.work_cap)
    for field in tb.PackedBins._fields:
        a, b = getattr(default, field), getattr(zero, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert torch.equal(a, b), field


@functools.lru_cache(maxsize=None)
def _tool_scene():
    scene = bench_scene(TOOL_SIZE, "cpu", n=TOOL_LAT)
    _, clip, _, faces, _, _ = scene
    config = dirt_tpu_torch.suggest_raster_config(
        clip, faces, TOOL_SIZE, TOOL_SIZE,
        config=dirt_tpu_torch.RasterConfig(engine="packed"), clip=False)
    return scene, config


@functools.lru_cache(maxsize=None)
def _staged():
    scene, config = _tool_scene()
    return prof_torch_stages.staged_forward(scene, config)


def test_staged_forward_equals_the_api():
    scene, config = _tool_scene()
    _, clip, colors, faces, background, _ = scene
    pixels, fid, zbuf, *_ = _staged()
    want = dirt_tpu_torch.rasterise_with_aux(background, clip, colors, faces,
                                             config=config, clip=False)
    assert not bool(want[3]) and int((want[1] >= 0).sum()) > 0
    for got, ref in zip((pixels, fid, zbuf), want):
        assert torch.equal(got, ref)


def test_staged_backward_equals_backward_packed():
    scene, _ = _tool_scene()
    weights = scene[5]
    pixels, fid, zbuf, geo, att, bins, geom = _staged()
    got = prof_torch_stages.staged_backward(geo, att, fid, zbuf, pixels,
                                            weights, bins, geom)
    want = prof_torch_stages.backward_core(geo, att, fid, zbuf, pixels,
                                           weights, bins, geom)
    assert float(got[0].abs().sum()) > 0
    for a, b in zip(got, want[:2]):
        assert torch.equal(a, b)


def test_parallel_variants_match_the_plain_step():
    _, config = _tool_scene()
    record = prof_torch_parallel.run("cpu", TOOL_SIZE, TOOL_LAT, samples=1,
                                     config=config, profile=0)
    labels = [r["variant"] for r in record["variants"]]
    assert labels == ["plain", "sharded n=1", "overlap chunks=1",
                      "overlap chunks=2", "overlap chunks=4", "face n=1"]
    assert all(r["grad_err"] <= 1e-4 and r["median_ms"] > 0
               for r in record["variants"])


def test_stage_tool_runs_on_the_cpu():
    _, config = _tool_scene()
    record = prof_torch_stages.run("cpu", TOOL_SIZE, TOOL_LAT, samples=1,
                                   config=config, profile=0)
    assert [r["stage"] for r in record["stages"]] == [
        "setup", "setup+binning", "forward kernel", "forward total",
        "fwd+bwd total", "backward core", "prologue (K3)",
        "entry rows (K2)", "pool reduce", "chain", "setup vjp"]
    assert all(r["min_ms"] > 0 for r in record["stages"])


def test_binning_tool_runs_on_the_cpu():
    _, config = _tool_scene()
    record = prof_torch_binning.run("cpu", TOOL_SIZE, TOOL_LAT, samples=1,
                                    config=config, profile=0)
    assert [r["stage"] for r in record["stages"]] == list(STAGES)
    assert sorted(record["checksums"]) == sorted(STAGES)
    assert [r["call"] for r in record["cummax"]] == [
        "face_of", "s0_of", "run_start", "x8_run", "lim8_run"]
    n = record["sizes"]
    assert [r["elements"] for r in record["cummax"]] == [
        n["pool"], n["pool"], n["live"], n["live"], n["live"]]
    assert all(r["library_median_ms"] > 0 for r in record["cummax"])


@pytest.mark.parametrize("tool", [prof_torch_stages, prof_torch_binning,
                                  prof_torch_parallel])
def test_main_exits_non_zero_without_a_card(tool):
    with mock.patch.object(torch.cuda, "is_available", lambda: False), \
            mock.patch.object(sys, "argv", [tool.__file__]), \
            pytest.raises(SystemExit) as exit_info:
        tool.main()
    assert exit_info.value.code not in (0, None)
