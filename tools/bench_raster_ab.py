#!/usr/bin/env python3
"""The layout swap (K4) and the streaming forward (K7) on one CUDA card,
against another tree's, in one process.

    python3 tools/bench_raster_ab.py [--parent DIR] [--runs N]

Times ``ops.raster_fwd.raster_forward_csr`` (raster_fwd_csr.cu) on the
99,904-face sphere at 1024 x 1024 with 3 and 9 channels (the faces the
default API's own render hands the raster op) and on the 10,224-face bench
sphere under ``RasterConfig(streaming=True)``, and
``ops.raster_fwd.flat_subtile_swap`` (subtile_swap.cu) on the five
per-pixel fields the sharded packed halo backward hands it (one slab of
``rasterise_sharded``, the bench sphere at 3 and 9 channels: 12 and 24
planes of 1024 x 1024), as ``chip_smoke.py`` phases 10 and 12 capture
them. For each shape and variant it prints

* the check: K7's fid and zbuf equal to the plain (un-culled) version's on
  the whole padded arrays and pixels within ``chip_smoke.TOL``, and every
  output bit-equal across variants; K4 bit-equal to its plain version;
* K7's faces tested per pixel without the cull and with it
  (``chip_smoke.csr_tests_per_pixel``, this tree's cull boxes) and the
  bound of ``chip_smoke.py``;
* single-call time: the median of synchronised calls of the wrapper (CUDA
  events), allocation and launches included;
* device time: the device kernels of one call, from a ``torch.profiler``
  window of ``--runs`` calls;
* back-to-back time: ``--runs`` calls queued without a synchronise, per call,
  and the host's time to queue one call;
* for K4 the same figures for one strided ``contiguous()`` copy of the
  stacked planes (the PyTorch call that computes the same permutation).

With ``--parent DIR`` (another tree of this repository, unpacked with ``git
archive``) that tree's two sources are built beside this tree's and timed
through that tree's own wrapper code: its ``ops/raster_fwd.py``, loaded as a
module of its own whose ``_build.load`` returns the libraries built from
that tree, so its own ``_swap_fn`` and ``_csr_fn`` type their entry points.
The two are timed in turns (new, old, old, new).
Prints the card's name and power limit on every line; exits non-zero
without a CUDA device.
"""

import argparse
import functools
import importlib.util
import statistics
import sys
import types
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

NAMES = ("subtile_swap", "raster_fwd_csr")


def _parent_module(root):
    """The other tree's ``ops/raster_fwd.py`` as a module of its own whose
    ``_build.load(name)`` builds ``csrc/<name>.cu`` of that tree: its
    wrappers, host code and all, around its kernels."""
    from bench_scatter import build_lib

    path = Path(root) / "dirt_tpu_torch" / "ops" / "raster_fwd.py"
    spec = importlib.util.spec_from_file_location("parent_raster_fwd", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    libs = {}

    def load(name):
        if name not in libs:
            libs[name] = build_lib(root, name, "parent")
        return libs[name]

    module._build = types.SimpleNamespace(load=load)
    for name in NAMES:
        load(name)
    return module


def _time(tag, card, variants, runs, kernel_key):
    """Time every variant in turns; print single-call, device and
    back-to-back figures per variant. ``kernel_key`` picks the device
    kernels that belong to a hand-written kernel by name."""
    import chip_smoke
    from bench_scatter import short_name

    order = [k for k in variants if k != "strided copy"]
    order = order + order[::-1] + [k for k in variants if k not in order]
    single, queued, host = {}, {}, {}
    for label in order:
        single.setdefault(label, []).append(
            chip_smoke._median_ms(variants[label], runs))
        q, h = chip_smoke._queued_ms(variants[label], runs)
        queued.setdefault(label, []).append(q)
        host.setdefault(label, []).append(h)
    for label, fn in variants.items():
        device = chip_smoke._device_ms(fn, runs)
        mine = sum(ms for n, ms in device.items() if kernel_key in n)
        parts = ", ".join(f"{short_name(n)} {ms:.4f}"
                          for n, ms in sorted(device.items(),
                                              key=lambda kv: -kv[1]))
        print(f"[{tag}] {label}: single call "
              f"{' / '.join(f'{v:.4f}' for v in single[label])} ms (medians "
              f"of {runs}); device {sum(device.values()):.4f} ms per call "
              f"({parts}; the {kernel_key} kernel {mine:.4f}); back to back "
              f"{' / '.join(f'{v:.4f}' for v in queued[label])} ms per call, "
              f"host {statistics.mean(host[label]):.4f} ms to queue one "
              f"({card})")


def _bench_csr(tag, inputs, card, runs, parent):
    import chip_smoke
    from dirt_tpu_torch.ops import raster, raster_fwd

    face_verts, face_attrs, background, config = inputs
    table, bins, bg_chw, cfg = raster.prepare_csr(face_verts, face_attrs,
                                                  background, config)
    if bool(bins.overflow):
        raise RuntimeError(f"[{tag}] binning overflowed under {cfg}")
    _, hp, wp = bg_chw.shape
    channels = face_attrs.shape[-1]
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    lists = (table, bins.entry_face, bins.start_block, bins.counts, bg_chw)
    variants = {"new": functools.partial(raster_fwd.raster_forward_csr,
                                         *lists, **geom)}
    if parent is not None:
        variants["old"] = functools.partial(parent.raster_forward_csr,
                                            *lists, **geom)
    want = raster_fwd.raster_forward_csr_plain(*lists, **geom)
    cull = raster_fwd.csr_cull_boxes(table, hp, wp)
    before, after = chip_smoke.csr_tests_per_pixel(
        bins, cull, cfg.tile_h, cfg.tile_w, hp, wp)
    _, rows32 = chip_smoke.csr_tests_per_pixel(
        bins, cull, cfg.tile_h, cfg.tile_w, hp, wp, warp=(1, 32))
    box = bins.bbox.long()
    box_px = int((torch.clamp(box[:, 1] - box[:, 0] + 1, min=0)
                  * torch.clamp(box[:, 3] - box[:, 2] + 1, min=0)).sum())
    covered = int((want[1] >= 0).sum())
    listed = int(bins.counts.sum())
    bound = chip_smoke._bound(
        4 * table.numel() + 4 * (listed + 2 * bins.counts.numel())
        + 4 * hp * wp * (2 * channels + 2),
        box_px * chip_smoke.TEST_FLOPS
        + covered * chip_smoke._attr_flops(channels))
    print(f"[{tag}] table {tuple(table.shape)}, listed {listed}, largest "
          f"tile {int(bins.counts.max())}, tiles {cfg.tile_h}x{cfg.tile_w}, "
          f"padded {hp}x{wp}: faces tested per pixel without the cull "
          f"{before:.2f}, culled {after:.2f} (warps of 4 x 8 pixels; of 1 x "
          f"32: {rows32:.2f}); bound {bound['bound_ms']:.4f} "
          f"ms by {bound['bound_by']} ({card})")
    first = None
    for label, fn in variants.items():
        got = fn()
        torch.cuda.synchronize()
        fid_bad = int((got[1] != want[1]).sum())
        z_bad = int((got[2] != want[2]).sum())
        pix_bad = int((~torch.isclose(got[0], want[0],
                                      **chip_smoke.TOL)).sum())
        first = first or got
        same = all(torch.equal(a, b) for a, b in zip(got, first))
        print(f"[{tag}] {label}: fid mismatches {fid_bad}, zbuf mismatches "
              f"{z_bad}, pixels outside allclose {pix_bad} (padded arrays), "
              f"all outputs equal to the first variant's {same}")
        if fid_bad or z_bad or pix_bad or not same:
            raise RuntimeError(f"[{tag}] {label} raster_fwd_csr is wrong")
    _time(tag, card, variants, runs, "raster_fwd_csr")


def _swap_arrays(step):
    """The arrays one run of ``step()`` hands ``flat_subtile_swap``."""
    from dirt_tpu_torch.ops import raster_fwd

    seen = []
    inner = raster_fwd.flat_subtile_swap

    def record(arrays):
        seen.append(list(arrays))
        return inner(arrays)

    with mock.patch.object(raster_fwd, "flat_subtile_swap", record):
        step()
    (arrays,) = seen
    return arrays


def _bench_swap(tag, arrays, card, runs, parent):
    import chip_smoke
    from dirt_tpu_torch.ops import raster_fwd

    hp, wp = arrays[0].shape[-2:]
    stacked = torch.cat([a.view(torch.int32).reshape(-1, hp, wp)
                         for a in arrays])
    view = stacked.reshape(-1, hp // 8, 8, wp // 128, 8, 16).transpose(-4, -2)
    variants = {"new": lambda: raster_fwd.flat_subtile_swap(arrays)}
    if parent is not None:
        variants["old"] = lambda: parent.flat_subtile_swap(arrays)
    variants["strided copy"] = view.contiguous
    bound = chip_smoke._bound(2 * 4 * stacked.numel(), 0)
    print(f"[{tag}] {len(arrays)} arrays, {stacked.shape[0]} planes of "
          f"{hp}x{wp}: bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']} ({card})")
    want = [raster_fwd.flat_subtile_swap_plain(a).view(torch.int32)
            for a in arrays]
    for label, fn in variants.items():
        if label == "strided copy":
            continue
        got = fn()
        torch.cuda.synchronize()
        bad = sum(int((g.view(torch.int32) != w).sum())
                  for g, w in zip(got, want))
        print(f"[{tag}] {label}: words differing from the plain version "
              f"{bad} of {stacked.numel()}")
        if bad:
            raise RuntimeError(f"[{tag}] {label} subtile_swap is wrong")
    _time(tag, card, variants, runs, "subtile_swap")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="another tree of the repository "
                        "whose K4 and K7 are timed beside this one's")
    parser.add_argument("--runs", type=int, default=20)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_raster_ab: torch.cuda.is_available() is False")
    import chip_smoke
    import dirt_tpu_torch
    from dirt_tpu_torch.ops import _build
    from dirt_tpu_torch.parallel.group import LocalGroup
    from dirt_tpu_torch.parallel.sharding import rasterise_sharded

    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card)
    _build.build(NAMES)
    for name in NAMES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build {name}] {line.strip()}")
    parent = _parent_module(opts.parent) if opts.parent else None

    size = chip_smoke.SIZE
    _, clip, colors, faces, background, weights = chip_smoke._bench_scene(
        device)
    big_loss, (big_bg, big_clip, big_colors), (big_faces, big_cfg) = \
        chip_smoke.big_sphere_step(device)
    with torch.no_grad():
        big3 = chip_smoke._raster_inputs(
            lambda: big_loss(big_bg, big_clip, big_colors))
        big9 = chip_smoke._raster_inputs(
            lambda: dirt_tpu_torch.rasterise(
                torch.zeros((size, size, 9), device=device), big_clip,
                chip_smoke._rand(3, big_clip.shape[0], 9, device=device),
                big_faces, config=big_cfg))
        stream_cfg = dirt_tpu_torch.suggest_raster_config(
            clip, faces, size, size,
            config=dirt_tpu_torch.RasterConfig(streaming=True), clip=False)
        bench = chip_smoke._raster_inputs(
            lambda: dirt_tpu_torch.rasterise(background, clip, colors, faces,
                                             config=stream_cfg, clip=False))
    n_big = big_faces.shape[0]
    for tag, inputs in ((f"K7 {n_big}-face sphere {size}^2 C=3", big3),
                        (f"K7 {n_big}-face sphere {size}^2 C=9", big9),
                        (f"K7 bench sphere {size}^2 streaming=True", bench)):
        _bench_csr(tag, inputs, card, opts.runs, parent)
    del big3, big9, bench

    packed_cfg = dirt_tpu_torch.suggest_raster_config(
        clip, faces, size, size, clip=False)
    colors9 = chip_smoke._rand(3, clip.shape[0], 9, device=device)
    for c, cols, bg, w in (
            (3, colors, background, weights),
            (9, colors9, torch.zeros((size, size, 9), device=device),
             chip_smoke._rand(4, size, size, 9, device=device))):
        arrays = _swap_arrays(lambda: chip_smoke._grads(
            lambda bg, v, c, f, config, clip: rasterise_sharded(
                bg, v, c, f, LocalGroup(1), config=config, with_aux=True),
            bg, clip, cols, faces, w, packed_cfg, False))
        _bench_swap(f"K4 sharded packed halo fields {size}^2 C={c}", arrays,
                    card, opts.runs, parent)


if __name__ == "__main__":
    main()
