"""dirt_tpu_torch.utils against dirt_tpu.utils, on the CPU.

Mirrors tests/test_utils.py on the port (checkpoint round trip, unknown
nodes rejected, ``None`` leaves, the CSV logger) and adds: ``save_ppm`` /
``load_ppm`` byte for byte against the reference's; ``benchtime``'s CPU
path and its raise on an invalid sample; ``configstore`` round trips and
its re-validation of a stale entry; and checkpoints across the two
packages (``demos/out/demo5_ckpt.npz``, written by ``dirt_tpu``'s demo 5,
and a file each package writes for the other).
"""

import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_scene import sphere_scene
from dirt_tpu.utils import checkpoint as jckpt
from dirt_tpu.utils import image as jimage
from dirt_tpu.utils import metrics as jmetrics
from dirt_tpu_torch import RasterConfig, suggest_raster_config
from dirt_tpu_torch.utils import benchtime, configstore
from dirt_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from dirt_tpu_torch.utils.image import load_ppm, save_ppm, to_uint8
from dirt_tpu_torch.utils.metrics import MetricsLogger

DEMO5_CKPT = Path(__file__).resolve().parents[1] / "demos/out/demo5_ckpt.npz"


def _assert_trees_equal(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            _assert_trees_equal(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    elif want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# --- checkpoint ----------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "params": {"pose": torch.arange(3.0), "bump": torch.ones(7)},
        "opt": (torch.zeros(2, 2), torch.tensor(5, dtype=torch.int32)),
        "steps": [np.float32(1.5), np.float32(2.5)],
        "grad": torch.ones(3, requires_grad=True) * 2,
    }
    path = os.path.join(tmp_path, "ckpt.npz")
    save_pytree(path, tree)
    restored = load_pytree(path)
    assert set(restored) == {"params", "opt", "steps", "grad"}
    np.testing.assert_array_equal(restored["params"]["pose"], np.arange(3.0))
    assert isinstance(restored["opt"], tuple)
    assert restored["opt"][1] == 5 and restored["opt"][1].dtype == np.int32
    assert isinstance(restored["steps"], list)
    assert restored["steps"][1] == 2.5
    np.testing.assert_array_equal(restored["grad"], [2.0, 2.0, 2.0])


def test_checkpoint_rejects_unknown_nodes(tmp_path):
    class Box:
        def __init__(self, value):
            self.value = value

    path = os.path.join(tmp_path, "bad.npz")
    with pytest.raises(TypeError, match="plain"):
        save_pytree(path, {"opt": Box(torch.zeros(3))})
    with pytest.raises(TypeError, match="plain"):
        save_pytree(path, {"opt": torch.optim.SGD(
            [torch.zeros(2, requires_grad=True)], lr=0.1)})
    with pytest.raises(TypeError, match="keys must be strings"):
        save_pytree(path, {1: torch.zeros(2)})
    assert not os.path.exists(path)


def test_checkpoint_none_leaves(tmp_path):
    tree = {"a": None, "b": torch.arange(4.0), "c": [None, torch.ones(2)]}
    path = os.path.join(tmp_path, "none.npz")
    save_pytree(path, tree)
    restored = load_pytree(path)
    assert restored["a"] is None
    np.testing.assert_array_equal(restored["b"], np.arange(4.0))
    assert restored["c"][0] is None
    np.testing.assert_array_equal(restored["c"][1], np.ones(2))


def test_demo5_checkpoint_loads_like_dirt_tpu():
    got = load_pytree(str(DEMO5_CKPT))
    want = jckpt.load_pytree(str(DEMO5_CKPT))
    _assert_trees_equal(got, want)
    assert got["params"]["bump"].shape == (5329,) and got["step"].ndim == 0


def _mixed_tree(make):
    """The same tree with leaves made by ``make`` (numpy -> leaf)."""
    rng = np.random.RandomState(3)
    return {
        "zeta": make(rng.rand(4, 3).astype(np.float32)),
        "alpha": [make(np.arange(5, dtype=np.int32)), None,
                  (make(rng.rand(2).astype(np.float32)),
                   make(np.float32(7.5)))],
        "mid": {"b": make(np.int32(3)), "a": None},
    }


def test_port_checkpoint_loads_in_dirt_tpu(tmp_path):
    path = os.path.join(tmp_path, "port.npz")
    save_pytree(path, _mixed_tree(torch.as_tensor))
    want = _mixed_tree(np.asarray)
    _assert_trees_equal(jckpt.load_pytree(path), jckpt.load_pytree(
        _save_with_dirt_tpu(tmp_path, want)))
    _assert_trees_equal(load_pytree(path), jckpt.load_pytree(path))


def _save_with_dirt_tpu(tmp_path, tree):
    path = os.path.join(tmp_path, "jax.npz")
    jckpt.save_pytree(path, tree)
    return path


def test_dirt_tpu_checkpoint_loads_in_port(tmp_path):
    path = _save_with_dirt_tpu(tmp_path, _mixed_tree(jnp.asarray))
    _assert_trees_equal(load_pytree(path), jckpt.load_pytree(path))
    # The two files are the same arrays under the same names.
    mine = os.path.join(tmp_path, "port.npz")
    save_pytree(mine, _mixed_tree(torch.as_tensor))
    with np.load(path) as a, np.load(mine) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])
            assert a[name].dtype == b[name].dtype


# --- metrics and images --------------------------------------------------------


def test_metrics_logger_csv(tmp_path):
    path = os.path.join(tmp_path, "m.csv")
    logger = MetricsLogger(path, print_every=100)
    for i in range(5):
        logger.log(i, loss=torch.tensor(1.0 / (i + 1)), mpix_s=10.0 * i)
    logger.close()
    lines = open(path).read().strip().splitlines()
    assert lines[0] == "step,wall_s,loss,mpix_s"
    assert len(lines) == 6
    last = lines[-1].split(",")
    assert last[0] == "4" and float(last[2]) == np.float32(0.2)
    with pytest.raises(ValueError, match="new metric keys"):
        logger = MetricsLogger(path)
        logger.log(0, loss=1.0)
        logger.log(1, loss=1.0, other=2.0)
    logger.close()


def test_metrics_rows_match_dirt_tpu(tmp_path):
    rows = []
    for module, name in ((jmetrics, "j.csv"), (None, "t.csv")):
        path = os.path.join(tmp_path, name)
        logger = (module.MetricsLogger if module else MetricsLogger)(path)
        for i in range(3):
            logger.log(i, loss=0.5 ** i, psnr=20.0 + i)
        logger.close()
        lines = open(path).read().splitlines()
        # Every column but the wall clock.
        rows.append([[c for k, c in enumerate(ln.split(",")) if k != 1]
                     for ln in lines])
    assert rows[0] == rows[1]


@pytest.mark.parametrize("shape", [(5, 7, 3), (6, 4), (3, 9, 1)])
def test_save_ppm_matches_dirt_tpu(tmp_path, shape):
    image = np.random.RandomState(0).uniform(-0.2, 1.2, shape).astype(
        np.float32)
    mine = os.path.join(tmp_path, "t.ppm")
    theirs = os.path.join(tmp_path, "j.ppm")
    save_ppm(mine, torch.as_tensor(image))
    jimage.save_ppm(theirs, image)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    np.testing.assert_array_equal(load_ppm(mine), jimage.load_ppm(theirs))
    np.testing.assert_array_equal(to_uint8(torch.as_tensor(image)),
                                  jimage.to_uint8(image))
    back = load_ppm(mine)
    assert back.dtype == np.float32
    np.testing.assert_allclose(back.reshape(np.clip(image, 0, 1).shape),
                               np.clip(image, 0, 1), atol=0.5 / 255 + 1e-6)


def test_save_ppm_rejects_other_shapes(tmp_path):
    with pytest.raises(ValueError, match="unsupported image shape"):
        save_ppm(os.path.join(tmp_path, "x.ppm"), torch.zeros(4, 4, 2))


# --- benchtime -----------------------------------------------------------------


def test_device_time_on_the_cpu():
    a = torch.rand(64, 64)
    calls = []

    def fn(x):
        calls.append(1)
        return x @ x

    t_min, t_med = benchtime.device_time_stats(fn, (a,), warmup=2,
                                               samples=5)
    assert len(calls) == 7
    assert np.isfinite([t_min, t_med]).all() and 0 < t_min <= t_med
    assert benchtime.device_time(fn, (a,), warmup=0, samples=1) > 0


def test_timed_returns_the_result_and_its_time():
    out, seconds = benchtime.timed("cpu", lambda x: x + 1, torch.zeros(3))
    assert torch.equal(out, torch.ones(3)) and seconds > 0
    with pytest.raises(ValueError, match="no timer for device meta"):
        benchtime.timed("meta", lambda: None)


def test_device_time_raises_on_an_invalid_sample(monkeypatch):
    """A clock that does not move gives a 0 s sample: it raises, it is not
    clamped to a tiny positive time."""
    monkeypatch.setattr(benchtime.time, "perf_counter", lambda: 12.5)
    with pytest.raises(ValueError, match="invalid time sample"):
        benchtime.device_time(lambda x: x + 1, (torch.zeros(3),))


def test_device_time_needs_a_tensor_and_a_timer():
    with pytest.raises(ValueError, match="needs a tensor"):
        benchtime.device_time(lambda n: n, (3,))
    with pytest.raises(ValueError, match="no timer for device meta"):
        benchtime.device_time(lambda x: x, (torch.zeros(2, device="meta"),),
                              warmup=0)
    with pytest.raises(ValueError, match="at least 1"):
        benchtime.device_time(lambda x: x, (torch.zeros(2),), samples=0)


# --- configstore ---------------------------------------------------------------


def _small_scene():
    verts, _, faces = sphere_scene()
    return torch.tensor(verts), torch.tensor(faces).long()


def test_configstore_round_trip(tmp_path):
    path = tmp_path / "configs_torch.json"
    assert configstore.load_config("a", path) is None
    first = RasterConfig(engine="packed", budget=512, expand_cap=9)
    second = RasterConfig(streaming=True, bin_cap=64)
    configstore.save_config("a", first, path)
    configstore.save_config("b", second, path)
    assert configstore.load_config("a", path) == first
    assert configstore.load_config("b", path) == second
    configstore.save_config("a", second, path)
    assert configstore.load_config("a", path) == second
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("content", [
    '{"format": 1, "a": {"tile_h": 8}}',                 # fields missing
    '{"format": 1, "a": {"bogus": 1}}',                  # unknown field
    '{"format": 0, "a": null}',                          # another format
    'not json',
])
def test_configstore_reads_a_mismatched_entry_as_missing(tmp_path, content):
    path = tmp_path / "configs_torch.json"
    path.write_text(content.replace('"format": 1',
                                    f'"format": {configstore.FORMAT}'))
    assert configstore.load_config("a", path) is None
    configstore.save_config("a", RasterConfig(), path)
    assert configstore.load_config("a", path) == RasterConfig()


def test_default_store_is_the_ports_own():
    assert configstore.DEFAULT_PATH.name == "configs_torch.json"
    assert configstore.DEFAULT_PATH.parent.name == "bench_cache"


def test_cached_config_keeps_a_valid_entry(tmp_path, monkeypatch):
    verts, faces = _small_scene()
    path = tmp_path / "configs_torch.json"
    honest = suggest_raster_config(verts, faces, 128, 128, clip=False)
    configstore.save_config("sphere", honest, path)

    def no_suggest(*args, **kwargs):
        raise AssertionError("a valid stored entry must not be recounted")

    import dirt_tpu_torch.rasterise_ops as ops
    monkeypatch.setattr(ops, "suggest_raster_config", no_suggest)
    assert configstore.cached_config("sphere", verts, faces, 128, 128,
                                     path=path) == honest


@pytest.mark.parametrize("fields", [
    dict(engine="dense", bin_cap=1),
    dict(engine="packed", expand_cap=1),
    dict(engine="packed", budget=8),            # refused outright
])
def test_cached_config_replaces_a_stale_entry(tmp_path, fields):
    verts, faces = _small_scene()
    path = tmp_path / "configs_torch.json"
    stale = RasterConfig(**fields)
    if "budget" in fields:
        with pytest.raises(ValueError, match="budget"):
            configstore.overflows(verts, faces, 128, 128, stale)
    else:
        assert configstore.overflows(verts, faces, 128, 128, stale)
    configstore.save_config("sphere", stale, path)
    fresh = configstore.cached_config(
        "sphere", verts, faces, 128, 128,
        config=RasterConfig(engine=fields["engine"]), path=path)
    assert fresh != stale and fresh.engine == fields["engine"]
    assert not configstore.overflows(verts, faces, 128, 128, fresh)
    assert configstore.load_config("sphere", path) == fresh
    assert fresh == suggest_raster_config(
        verts, faces, 128, 128, config=RasterConfig(engine=fields["engine"]),
        clip=False)


@pytest.mark.parametrize("stored_fields,asked", [
    (dict(engine="dense"), dict(engine="packed")),
    (dict(streaming=True), {}),
    (dict(engine="dense"), dict(engine="dense", streaming=True)),
])
def test_cached_config_replaces_an_entry_of_other_fixed_fields(
        tmp_path, stored_fields, asked):
    verts, faces = _small_scene()
    path = tmp_path / "configs_torch.json"
    stored = suggest_raster_config(verts, faces, 128, 128,
                                   config=RasterConfig(**stored_fields),
                                   clip=False)
    assert not configstore.overflows(verts, faces, 128, 128, stored)
    configstore.save_config("sphere", stored, path)
    want = suggest_raster_config(verts, faces, 128, 128,
                                 config=RasterConfig(**asked), clip=False)
    got = configstore.cached_config("sphere", verts, faces, 128, 128,
                                    config=RasterConfig(**asked), path=path)
    assert got == want != stored
    assert configstore.load_config("sphere", path) == want
    assert configstore.matches(got, RasterConfig(**asked))
    assert not configstore.matches(stored, RasterConfig(**asked))
