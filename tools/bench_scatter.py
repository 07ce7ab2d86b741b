#!/usr/bin/env python3
"""The two face-scatter kernels on one CUDA card, timed apart from the host.

    python3 tools/bench_scatter.py [--parent DIR] [--define ...] [--runs N]

Times ``ops.scatter.scatter_to_faces`` (scatter_faces.cu) and
``scatter_to_faces_csr`` (scatter_faces_csr.cu) on what the row-sharded
backward hands them (captured from one run of ``rasterise_sharded`` with one
slab): the bench sphere at 1024 x 1024
under the dense and the streaming engine with 3, 9 and 16 channels (21, 39
and 60 cotangent columns) and the 99,904-face sphere on its CSR bins. For
each shape it prints

* the check of the card tests (rows against the plain version, value by
  value against the sum of the terms' magnitudes, a second run bit-equal)
  and the number of owned pixels that lie outside their face's
  box (the scan is trimmed to the box, so this must be 0);
* the share of list slots that are live (dense: ``sum(counts) / (T * cap)``;
  CSR: listed pairs over padded rows);
* single-call time: the median of synchronised calls of the wrapper (CUDA
  events), allocation and launches included;
* device time: the sum of the device kernels of one call by name, from a
  ``torch.profiler`` window of ``--runs`` calls (each pass apart, and what
  clears the output where something does);
* back-to-back time: ``--runs`` calls queued without a synchronise, per
  call (the larger of the host's and the device's time per call), and the
  host's time to queue one call;
* the same four figures for one float32 ``index_add_`` of the owned pixels'
  rows (PyTorch's own scatter, which sums with atomics) and the bound by
  bytes (``card_common.bound``).

With ``--define NAME=VALUE,...`` (may be repeated) this tree's two sources
are also built with those ``-D`` flags, the tuning constants of
``csrc/scatter_rows.cuh`` (``SCATTER_WARPS``, ``SCATTER_COLS``), and timed
through the package's wrappers. With ``--parent DIR`` (another tree of this
repository, unpacked with ``git archive``) the two scatter sources of that
tree are built beside this tree's and timed in the same process through a
copy of that tree's wrapper (``torch.zeros`` output, scratch, one C call).
The variants are timed in turns (new, tuned, old, old, tuned, new). Prints
the card's name and power limit beside every figure; exits non-zero without
a CUDA device.
"""

import argparse
import contextlib
import ctypes
import functools
import statistics
import sys
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import card_common  # noqa: E402
from card_common import build_lib, short_name  # noqa: E402

ENTRY = {"scatter_faces": "dirt_scatter_faces",
         "scatter_faces_csr": "dirt_scatter_faces_csr"}


def _build_other(root, name, label, defines=()):
    """A scatter kernel of the tree at ``root`` (``build_lib``); returns its
    C entry point, typed from that tree's source: ``takes_cull`` is set if
    it takes the cull boxes beside the binning boxes (trees from the
    cull-box repair of the backward on), ``takes_out_rows`` if it takes the
    output's row count (trees whose pass 2 writes every output row)."""
    text = (Path(root) / "dirt_tpu_torch" / "csrc" / f"{name}.cu").read_text()
    fn = getattr(build_lib(root, name, label, defines), ENTRY[name])
    fn.restype = ctypes.c_int
    fn.takes_cull = "const int* cull" in text
    fn.takes_out_rows = "int out_rows" in text
    n_ptr = (7 if name == "scatter_faces" else 8) + fn.takes_cull
    fn.argtypes = ([ctypes.c_void_p] * n_ptr
                   + [ctypes.c_int] * (7 + fn.takes_out_rows)
                   + [ctypes.c_void_p])
    return fn


def _patched(fns):
    """Context in which the package's wrappers call the entry points
    ``fns`` ({kernel name: function}) in place of their own."""
    from dirt_tpu_torch.ops import scatter

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        scatter, "_kernel_fn", lambda: fns["scatter_faces"]))
    stack.enter_context(mock.patch.object(
        scatter, "_csr_fn", lambda: fns["scatter_faces_csr"]))
    return stack


def _old_wrapper(fn, name, args, kwargs):
    """The parent tree's wrapper around its C entry point: the same checks, a
    cleared output, the scratch, one call on the current stream."""
    from dirt_tpu_torch.ops import scatter
    from dirt_tpu_torch.ops.raster_fwd import check_tensor

    cot, fid, *lists, n_out = args
    tile_h, tile_w, bbox = kwargs["tile_h"], kwargs["tile_w"], kwargs["bbox"]
    cull = kwargs["cull"]
    boxes = (bbox, cull) if fn.takes_cull else (bbox,)
    device = fid.device
    dense = name == "scatter_faces"
    num_faces = n_out - 1 if dense else n_out

    def call():
        k_cols, hp, wp, total = scatter._check_image(
            cot, fid, bbox, cull, num_faces, tile_h, tile_w)
        for tensor in lists:
            check_tensor("list", tensor, torch.int32, tuple(tensor.shape),
                         device)
        rows = -(-n_out // 8) * 8 if dense else n_out
        out = torch.zeros((rows, k_cols), dtype=torch.float32, device=device)
        slots = lists[0].numel()
        partial = torch.empty((slots, k_cols), dtype=torch.float32,
                              device=device)
        last = lists[0].shape[1] if dense else slots
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in [*lists, *boxes]),
                 fid.data_ptr(), cot.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), k_cols, hp, wp, tile_h, tile_w, last,
                 num_faces, *([rows] if fn.takes_out_rows else []), stream)
        if err != 0:
            raise RuntimeError(f"parent {name}: CUDA error {err}")
        return out

    return call


def _bench(tag, name, step, card, runs, old_fns, tuned):
    from dirt_tpu_torch.ops import scatter

    wrapper = {"scatter_faces": "scatter_to_faces",
               "scatter_faces_csr": "scatter_to_faces_csr"}[name]
    ((args, kwargs),) = card_common.calls(scatter, wrapper, step)
    cot, fid, *lists, n_out = args
    bbox = kwargs["bbox"]
    k_cols = cot.shape[0]
    kernel_fn = getattr(scatter, wrapper)
    plain_fn = getattr(scatter, wrapper + "_plain")

    def new():
        return kernel_fn(*args, **kwargs)

    own_px = (fid.reshape(-1) >= 0).nonzero().squeeze(1)
    owner = fid.reshape(-1)[own_px].long()
    pixel_rows = cot.reshape(k_cols, -1).T[own_px].contiguous()
    rows_p = plain_fn(cot, fid, n_out)

    def library():
        return torch.zeros(rows_p.shape, device=cot.device
                           ).index_add_(0, owner, pixel_rows)

    # Owned pixels outside their face's binning box and cull box.
    px, py = own_px % fid.shape[1], own_px // fid.shape[1]

    def outside_of(boxes):
        box = boxes[owner].long()
        return int(((px < box[:, 0]) | (px > box[:, 1]) | (py < box[:, 2])
                    | (py > box[:, 3])).sum())

    outside_bin, outside = outside_of(bbox), outside_of(kwargs["cull"])
    counts = lists[-1]
    listed = int(counts.sum())
    slots = lists[0].numel()
    owned = int(own_px.numel())
    nbytes = (4 * owned * k_cols + 4 * fid.numel() + 4 * rows_p.numel()
              + 4 * (listed + (len(lists) - 1) * counts.numel()))
    bound = card_common.bound(nbytes, owned * k_cols)
    mass = plain_fn(cot.abs(), fid, n_out)
    scale = rows_p.abs().amax(dim=0, keepdim=True)
    print(f"[{tag}] {name} cot {tuple(cot.shape)} lists "
          f"{tuple(lists[0].shape)}: listed {listed} of {slots} slots (live "
          f"share {listed / slots:.4f}), owned {owned} px, owned pixels "
          f"outside their face's binning box {outside_bin}, outside its "
          f"cull box {outside}, bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}")

    variants = {"new": new}
    inside = {label: functools.partial(_patched, fns)
              for label, fns in tuned.items()}
    variants.update({label: new for label in tuned})
    if old_fns:
        variants["old"] = _old_wrapper(old_fns[name], name, args, kwargs)

    def within(label):
        return inside.get(label, contextlib.nullcontext)()

    for label, fn in variants.items():
        with within(label):
            rows_k = fn()
            again = fn()
        diff = (rows_k - rows_p).abs()
        rows_bad = int((diff > card_common.TOL_ROWS * scale + 1e-6).sum())
        value_bad = int((diff > card_common.TOL_ROWS * mass + 1e-9).sum())
        same = torch.equal(rows_k, again)
        print(f"[{tag}] {label}: values outside the row limit {rows_bad}, "
              f"outside the per-value limit {value_bad}, max |diff| "
              f"{float(diff.max()):.3g}, second run equal {same}")
        if rows_bad or value_bad or not same or outside:
            raise RuntimeError(f"[{tag}] {label} {name} is wrong")
    variants["index_add_"] = library
    order = [k for k in variants if k != "index_add_"]
    order = order + order[::-1] + ["index_add_"]
    single, queued, host = {}, {}, {}
    for label in order:
        fn = variants[label]
        with within(label):
            single.setdefault(label, []).append(
                card_common.median_ms(fn, runs))
            q, h = card_common.queued_ms(fn, runs)
        queued.setdefault(label, []).append(q)
        host.setdefault(label, []).append(h)
    for label, fn in variants.items():
        with within(label):
            device = card_common.device_ms(fn, runs)
        parts = ", ".join(f"{short_name(n)} {ms:.4f}"
                          for n, ms in sorted(device.items(),
                                              key=lambda kv: -kv[1]))
        print(f"[{tag}] {label}: single call "
              f"{' / '.join(f'{v:.4f}' for v in single[label])} ms (medians "
              f"of {runs}); device {sum(device.values()):.4f} ms per call "
              f"({parts}); back to back "
              f"{' / '.join(f'{v:.4f}' for v in queued[label])} ms per call, "
              f"host {statistics.mean(host[label]):.4f} ms to queue one "
              f"({card})")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="another tree of the repository "
                        "whose scatter kernels are timed beside this one's")
    parser.add_argument("--define", action="append", default=[],
                        metavar="NAME=VALUE[,NAME=VALUE]",
                        help="also time this tree's kernels built with "
                        "these -D flags (csrc/scatter_rows.cuh's tuning "
                        "constants); may be given several times")
    parser.add_argument("--runs", type=int, default=20)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_scatter: torch.cuda.is_available() is False")
    import dirt_tpu_torch
    from dirt_tpu_torch.ops import _build
    from dirt_tpu_torch.parallel.group import LocalGroup
    from dirt_tpu_torch.parallel.sharding import rasterise_sharded
    from dirt_tpu_torch.utils.benchtime import card_line

    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    names = ("scatter_faces", "scatter_faces_csr")
    _build.build(names)
    for name in names:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build {name}] {line.strip()}")
    root = Path(__file__).resolve().parents[1]
    old_fns = ({n: _build_other(opts.parent, n, "parent")
                for n in names} if opts.parent else None)
    tuned = {spec: {n: _build_other(root, n, f"tuned{i}", spec.split(","))
                    for n in names}
             for i, spec in enumerate(opts.define)}

    size = card_common.SIZE
    _, clip, colors, faces, background, weights = card_common.bench_scene(
        size, device)

    def one_slab_step(scene, config, w):
        return lambda: card_common.render_grads(
            lambda bg, v, c, f, config, clip: rasterise_sharded(
                bg, v, c, f, LocalGroup(1), config=config, with_aux=True),
            scene[0], scene[1], scene[2], scene[3], w, config, False)

    def suggest(verts, tris, **kwargs):
        return dirt_tpu_torch.suggest_raster_config(
            verts, tris, size, size,
            config=dirt_tpu_torch.RasterConfig(**kwargs), clip=False)

    dense_cfg = suggest(clip, faces, engine="dense")
    stream_cfg = suggest(clip, faces, streaming=True)
    scenes = {3: ((background, clip, colors, faces), weights)}
    for seed, c in ((3, 9), (5, 16)):
        scenes[c] = ((torch.zeros((size, size, c), device=device), clip,
                      card_common.rand(seed, clip.shape[0], c, device=device),
                      faces),
                     card_common.rand(seed + 1, size, size, c, device=device))
    _, (big_bg, big_clip, big_colors), (big_faces, _) = \
        card_common.big_sphere_step(device)
    big_cfg = suggest(big_clip, big_faces, streaming=True)

    for c, (scene, w) in scenes.items():
        _bench(f"bench sphere {size}^2 dense C={c}", "scatter_faces",
               one_slab_step(scene, dense_cfg, w), card, opts.runs, old_fns,
               tuned)
    for c, (scene, w) in scenes.items():
        _bench(f"bench sphere {size}^2 streaming=True C={c}",
               "scatter_faces_csr", one_slab_step(scene, stream_cfg, w), card,
               opts.runs, old_fns, tuned)
    _bench(f"{big_faces.shape[0]}-face sphere {size}^2 csr C=3",
           "scatter_faces_csr",
           one_slab_step((big_bg, big_clip, big_colors, big_faces), big_cfg,
                         weights), card, opts.runs, old_fns, tuned)


if __name__ == "__main__":
    main()
