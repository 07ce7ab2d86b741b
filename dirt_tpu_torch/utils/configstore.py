"""Persistent store of count-then-allocate RasterConfigs, keyed by scene.

Counterpart of ``dirt_tpu/utils/configstore.py`` for the port's
``RasterConfig``, in a file of its own, ``bench_cache/configs_torch.json``
(not committed). Honest caps need a ``suggest_raster_config`` pass per
scene (exact counts, synchronising with the host); its result is
deterministic for a deterministic scene, so a bench stores it under a key
naming the scene and later runs only re-validate it:
:func:`cached_config` renders the scene once with the stored caps and keeps
them if the overflow flag stays clear. A stale entry (the scene changed
under its key) trips the flag; an entry that does not match the config's
fields, or a file of another ``FORMAT``, reads as missing; and an entry
whose fixed fields differ from the caller's (another engine under the same
key, say: :func:`matches`) is not the caller's. Each way the caps are
suggested anew, checked by one render, and replace it.
Caps that the renderer refuses for the scene (``ValueError``, such as a
packed budget smaller than the tile count) are stale too.

Like the reference's, this store is bookkeeping for the bench, not part of
the rendering API.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch

from dirt_tpu_torch.ops.raster import RasterConfig

DEFAULT_PATH = (Path(__file__).resolve().parents[2] / "bench_cache"
                / "configs_torch.json")

# The fields suggest_raster_config never fills in: a stored entry must
# carry the caller's value of each, None included.
_KEPT = ("engine", "streaming", "tile_w")

# Bump when RasterConfig's fields or suggest_raster_config's semantics
# change in a way that invalidates stored caps wholesale.
FORMAT = 1


def _load_all(path: Path) -> dict:
    try:
        data = json.loads(Path(path).read_text())
    except FileNotFoundError:
        return {"format": FORMAT}
    except ValueError:                      # not JSON: start afresh
        return {"format": FORMAT}
    if not isinstance(data, dict) or data.get("format") != FORMAT:
        return {"format": FORMAT}
    return data


def load_config(key: str, path=None) -> RasterConfig | None:
    """The stored RasterConfig for ``key``, or None when there is none or
    it does not match the config's fields."""
    entry = _load_all(path or DEFAULT_PATH).get(key)
    if not isinstance(entry, dict) or set(entry) != set(RasterConfig._fields):
        return None
    return RasterConfig(**entry)


def save_config(key: str, config: RasterConfig, path=None) -> None:
    """Store ``config`` under ``key`` (written to a temporary file, then
    renamed over the store)."""
    path = Path(path or DEFAULT_PATH)
    data = _load_all(path)
    data[key] = dict(config._asdict())
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(data, indent=1, sort_keys=True))
    os.replace(tmp, path)


def matches(stored: RasterConfig, config: RasterConfig) -> bool:
    """Whether ``stored`` could be suggest_raster_config's answer to
    ``config``: equal in the fields it keeps and in every other field the
    caller set (not None)."""
    return all(getattr(stored, name) == value
               for name, value in config._asdict().items()
               if value is not None or name in _KEPT)


def overflows(vertices, faces, height: int, width: int,
              config: RasterConfig, clip: bool = False) -> bool:
    """Whether one render of the scene under ``config`` raises the
    overflow flag (a static cap dropped faces)."""
    from dirt_tpu_torch.rasterise_ops import rasterise_with_aux

    device = vertices.device
    background = torch.zeros((height, width, 3), device=device)
    colors = torch.zeros((vertices.shape[0], 3), device=device)
    return bool(rasterise_with_aux(background, vertices, colors, faces,
                                   config=config, clip=clip)[3])


def cached_config(key: str, vertices, faces, height: int, width: int,
                  config: RasterConfig | None = None, clip: bool = False,
                  path=None) -> RasterConfig:
    """Honest caps for the scene stored under ``key``: the stored config if
    it :func:`matches` ``config`` and one render under it keeps the
    overflow flag clear, else ``suggest_raster_config``'s (from
    ``config``'s fixed fields), checked the same way and stored. Raises if
    the suggested caps overflow."""
    from dirt_tpu_torch.rasterise_ops import suggest_raster_config

    vertices = vertices.detach()
    stored = load_config(key, path)
    if stored is not None and matches(stored, config or RasterConfig()):
        try:
            stale = overflows(vertices, faces, height, width, stored, clip)
        except ValueError:          # caps that cannot fit this scene at all
            stale = True
        if not stale:
            return stored
    suggested = suggest_raster_config(vertices, faces, height, width,
                                      config=config, clip=clip)
    if overflows(vertices, faces, height, width, suggested, clip):
        raise RuntimeError(f"suggested caps overflow the scene {key!r}: "
                           f"{suggested}")
    save_config(key, suggested, path)
    return suggested
