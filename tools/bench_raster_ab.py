#!/usr/bin/env python3
"""The whole-tile forwards (K5, K7), the fused backwards (K6, K8), the
layout swap (K4), the packed backward (K2), the packed forward (K1) and the
neighbour prologue (K3) on one CUDA card, against another tree's, and the
forward setup (KP) against its plain version, in one process.

    python3 tools/bench_raster_ab.py [--parent DIR[,DIR...]] [--runs N]
        [--kernels K5,K6,K7,K8,K4,K2,K1,K3,KP] [--spheres 224,...]

Times ``ops.raster_fwd.raster_forward_csr`` (raster_fwd_csr.cu) and
``ops.fused_bwd.fused_backward_rows_csr`` (fused_bwd_csr.cu) on the
99,904-face sphere at 1024 x 1024 with 3 and 9 channels (the faces the
default API's own render hands the raster op; ``--spheres`` adds the
default API's ``uv_sphere(n, n)`` of 2 n (n - 1) faces at 3 channels for
each other n listed) and on the 10,224-face bench sphere under
``RasterConfig(streaming=True)`` (K8 on the forward's
outputs, the prologue's planes and the bench's upstream gradients);
``ops.raster_fwd.raster_forward`` (raster_fwd_dense.cu) on the bench sphere
at 1024 x 1024 under ``RasterConfig(engine="dense")``, on config 4's faces
at 512 x 512 and on the flagship step's G-buffer faces at 256 x 256 with 9
channels (both as the paths' own renders hand them to the raster op), and
``ops.fused_bwd.fused_backward_rows`` (fused_bwd.cu) on those three dense
forwards' outputs; and
``ops.raster_fwd.flat_subtile_swap`` (subtile_swap.cu) on the five
per-pixel fields the sharded packed halo backward hands it (one slab of
``rasterise_sharded``, the bench sphere at 3 and 9 channels: 12 and 24
planes of 1024 x 1024), captured from one run; and
``ops.packed_bwd.packed_entry_rows`` (packed_bwd.cu) on what the
packed backward hands it on five shapes: the 1,001,112-face sphere of the
``sphere1m_1024`` config and the bench sphere at 1024 x 1024
with ``clip=False`` and 3 channels (the bench's main path), config 5's
9-channel G-buffer at 1024 x 1024, the bench sphere with 16 channels (two
launches) and one slab of the sharded packed path (``rasterise_sharded``
with one local slab: flat-subtile fields); and
``ops.raster_fwd.raster_forward_packed`` (raster_fwd_packed.cu) on what the
op hands it on five shapes: the 1,001,112-face sphere and the bench sphere
at 1024 x 1024 with ``clip=False`` and 3 channels (the bench's main path),
config 5's
9-channel G-buffer, the bench sphere with 16 channels and one slab of the
sharded packed path; and ``ops.packed_bwd.padded_prologue``
(packed_prologue.cu) on what the single-device backwards hand it on six
shapes: the bench sphere packed with ``clip=False`` and 3 channels, config
5 (9 channels), the bench sphere with 16 channels, the default API's
99,904-face sphere (CSR engine), config 4 at 512 x 512 and the flagship
step at 256 x 256 with 9 channels (dense); and
``ops.triangle_setup.setup_faces`` (setup_fwd.cu) beside
``setup_faces_plain`` on the faces the cells hand the raster op at 1024 x
1024: the 1,001,112-face sphere (clip off, packed), the 99,904-face sphere
(clip on, CSR) and the 10,224-face sphere (clip on, packed) with nine
channels, as the deferred G-buffer has.
For each shape and variant it prints

* the check: K5's and K7's fid and zbuf equal to the plain (un-culled)
  version's on the whole padded arrays and pixels within ``card_common.TOL``,
  and every output bit-equal across variants; K6's and K8's rows within
  ``card_common.TOL_ROWS`` of the column's largest magnitude + 1e-6 of the
  plain version's and equal on a second run (the variants sum in other
  orders, so their rows are compared with the plain version's, not with
  each other's); K4 bit-equal to its plain version; K2 bit-equal to its
  plain version run on the CPU (on the card the plain version's
  ``index_add_`` flushes subnormal sums to zero), to a second run and to
  this tree's rows, and (this tree's) two chunk slices equal to the whole
  range; K1's fid, zbuf and pixels and K3's five outputs bit-equal to
  their plain versions (a tree whose kernel differs is reported and timed,
  not refused, like a tree with a part of K1 cut out to split its time);
  KP's outputs bit-equal to its plain version's, NaN where it is NaN;
* K5's and K7's faces tested per pixel without the cull and with it
  (``card_common.tests_per_pixel``, this tree's cull boxes) and the bounds
  of ``card_common``;
* single-call time: the median of synchronised calls of the wrapper (CUDA
  events), allocation and launches included;
* device time: the device kernels of one call, by kernel (each launch of a
  call: K5's and K7's box launch and walk, K6's and K8's two passes, K2's
  one launch per column group), from a ``torch.profiler`` window of
  ``--runs`` calls (for K3 of an older tree, its copies with it);
* back-to-back time: ``--runs`` calls queued without a synchronise, per call,
  and the host's time to queue one call;
* for K4 the same figures for one strided ``contiguous()`` copy of the
  stacked planes (the PyTorch call that computes the same permutation);
  for K1 and K2 against a tree whose kernels read a gathered copy of the
  face table (``rows``, from before they read it through the entries),
  that tree's kernel on rows gathered beforehand and, apart, the gather
  itself (``table2[entries // 8]``), as that tree's forward ran it.

``--kernels NEEDLES`` instead holds K6, K8, K9 and K10 of both trees against
their plain versions on what the backward hands them on the far-needle
scenes of the card tests, and prints the values outside the card tests'
limits.

With ``--parent DIR`` (another tree of this repository, unpacked with ``git
archive``) that tree's sources are built beside this tree's and timed
through that tree's own wrapper code: its ``ops/raster_fwd.py``,
``ops/fused_bwd.py`` and ``ops/packed_bwd.py``, loaded as modules of their
own whose ``_build.load`` returns the libraries built from that tree, so its
own ``_swap_fn``, ``_csr_fn``, ``_dense_fn`` and ``_bwd_fn`` type their
entry points. The two are timed in turns (new, old, old, new). K1, K2,
K3, K6 and K8 take several trees (``--parent A,B``), each labelled by its
directory's name and timed in turns: a copy of this tree with one tuning
constant edited is how a constant is chosen; a copy with one pass of K2 or
one part of K1 cut out, timed beside the whole kernel, splits its time
(such a tree's outputs are reported, not refused).
Prints the card's name and power limit on every line; exits non-zero
without a CUDA device.
"""

import argparse
import contextlib
import copy
import functools
import importlib.util
import inspect
import statistics
import sys
import types
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "tests"))

import card_common  # noqa: E402


def _parent_module(root, label="parent"):
    """The other tree's ``ops/raster_fwd.py``, ``ops/fused_bwd.py``,
    ``ops/scatter.py`` and ``ops/packed_bwd.py`` as modules of their own
    (attributes of the namespace returned) whose ``_build.load(name)``
    builds ``csrc/<name>.cu`` of that tree at first use (into a library
    named after ``label``): its wrappers, host code and all, around its
    kernels. Each imports the tree's own modules loaded before it (its
    ``packed_bwd`` that tree's ``raster_fwd``), the rest from this tree."""
    import dirt_tpu_torch.ops as ops

    libs = {}

    def load(name):
        if name not in libs:
            libs[name] = card_common.build_lib(root, name, label)
        return libs[name]

    modules = {}
    for name in ("raster_fwd", "fused_bwd", "scatter", "packed_bwd"):
        path = Path(root) / "dirt_tpu_torch" / "ops" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"{label}_{name}", path)
        module = importlib.util.module_from_spec(spec)
        with contextlib.ExitStack() as stack:
            for done, mod in modules.items():
                stack.enter_context(mock.patch.dict(
                    sys.modules, {f"dirt_tpu_torch.ops.{done}": mod}))
                stack.enter_context(
                    mock.patch.object(ops, done, mod, create=True))
            spec.loader.exec_module(module)
        module._build = types.SimpleNamespace(load=load)
        modules[name] = module
    return types.SimpleNamespace(**modules)


def _row_gather(table2, bins):
    """The gather the packed forward ran before its kernels read the face
    table through the entries: every budget row's face row, in budget-row
    order (``[budget_rows, W]``)."""
    return table2[bins.entries.long() // 8].contiguous()


def _packed_forward_of(module, table2, bins, bg_chw, geom):
    """A call of ``module.raster_forward_packed`` (some tree's) on the
    inputs; a tree whose K1 reads the gathered rows gets them, gathered
    here once."""
    fn = module.raster_forward_packed
    if "rows" in inspect.signature(fn).parameters:
        return functools.partial(fn, table2, bins, bg_chw,
                                 rows=_row_gather(table2, bins), **geom)
    return functools.partial(fn, table2, bins, bg_chw, **geom)


def _entry_rows_of(module, prep):
    """A call of ``module.packed_entry_rows`` (some tree's) on ``prep``; a
    tree whose K2 reads the gathered rows (``bins.rows``) gets them,
    gathered here once, on bins that carry them."""
    from dirt_tpu_torch.ops import packed_bwd

    if hasattr(module, "_entry_table_rows"):
        old = copy.copy(prep)
        old.bins = types.SimpleNamespace(
            **prep.bins._asdict(),
            rows=_row_gather(packed_bwd._entry_table(prep), prep.bins))
        return functools.partial(module.packed_entry_rows, old)
    return functools.partial(module.packed_entry_rows, prep)


def _boxes_of(fn, bbox, cull):
    """The box arguments ``fn`` (a fused or scatter wrapper of some tree)
    takes: ``bbox`` and, from the cull-box repair of the backward on,
    ``cull``."""
    params = inspect.signature(fn).parameters
    return dict(bbox=bbox, **({"cull": cull} if "cull" in params else {}))


def _time(tag, card, variants, runs, kernel_key):
    """Time every variant in turns; print single-call, device and
    back-to-back figures per variant. ``kernel_key`` (a name or a tuple of
    names) picks the device kernels that belong to a hand-written kernel by
    name."""
    keys = (kernel_key,) if isinstance(kernel_key, str) else kernel_key

    order = [k for k in variants if k != "strided copy"]
    order = order + order[::-1] + [k for k in variants if k not in order]
    single, queued, host = {}, {}, {}
    for label in order:
        single.setdefault(label, []).append(
            card_common.median_ms(variants[label], runs))
        q, h = card_common.queued_ms(variants[label], runs)
        queued.setdefault(label, []).append(q)
        host.setdefault(label, []).append(h)
    for label, fn in variants.items():
        device = card_common.device_ms(fn, runs)
        mine = sum(ms for n, ms in device.items()
                   if any(k in n for k in keys))
        parts = ", ".join(f"{card_common.short_name(n)} {ms:.4f}"
                          for n, ms in sorted(device.items(),
                                              key=lambda kv: -kv[1]))
        print(f"[{tag}] {label}: single call "
              f"{' / '.join(f'{v:.4f}' for v in single[label])} ms (medians "
              f"of {runs}); device {sum(device.values()):.4f} ms per call "
              f"({parts}; the {' + '.join(keys)} kernels {mine:.4f}); back "
              f"to back "
              f"{' / '.join(f'{v:.4f}' for v in queued[label])} ms per call, "
              f"host {statistics.mean(host[label]):.4f} ms to queue one "
              f"({card})")


def _bench_forward(tag, engine, inputs, card, runs, parent):
    """K5 (``engine`` "dense") or K7 ("csr") on one scene, new and old;
    returns (table, bins, bg_chw, concrete config, the plain version's
    outputs, this tree's cull boxes) for the backward."""
    from dirt_tpu_torch.ops import raster, raster_fwd

    face_verts, face_attrs, background, config = inputs
    if engine == "csr":
        name = "raster_fwd_csr"
        table, bins, bg_chw, cfg = raster.prepare_csr(
            face_verts, face_attrs, background, config)
        lists = (table, bins.entry_face, bins.start_block, bins.counts,
                 bg_chw)
        new, plain = raster_fwd.raster_forward_csr, \
            raster_fwd.raster_forward_csr_plain
        old = parent and parent.raster_fwd.raster_forward_csr
    else:
        name = "raster_fwd_dense"
        table, bins, bg_chw, cfg = raster.prepare_dense(
            face_verts, face_attrs, background, config)
        lists = (table, bins.bins, bins.counts, bg_chw)
        new, plain = raster_fwd.raster_forward, raster_fwd.raster_forward_plain
        old = parent and parent.raster_fwd.raster_forward
    if bool(bins.overflow.any()):
        raise RuntimeError(f"[{tag}] binning overflowed under {cfg}")
    _, hp, wp = bg_chw.shape
    channels = face_attrs.shape[-1]
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    variants = {"new": functools.partial(new, *lists, **geom)}
    if old is not None:
        variants["old"] = functools.partial(old, *lists, **geom)
    want = plain(*lists, **geom)
    cull = raster_fwd.csr_cull_boxes(table, hp, wp)
    if not torch.equal(cull, raster_fwd.csr_cull_boxes_plain(table, hp, wp)):
        raise RuntimeError(f"[{tag}] the cull boxes differ from the plain "
                           "ones")
    before, after = card_common.tests_per_pixel(
        bins, cull, cfg.tile_h, cfg.tile_w, hp, wp)
    _, rows32 = card_common.tests_per_pixel(
        bins, cull, cfg.tile_h, cfg.tile_w, hp, wp, warp=(1, 32))
    box = bins.bbox.long()
    box_px = int((torch.clamp(box[:, 1] - box[:, 0] + 1, min=0)
                  * torch.clamp(box[:, 3] - box[:, 2] + 1, min=0)).sum())
    covered = int((want[1] >= 0).sum())
    listed = int(bins.counts.sum())
    bound = card_common.bound(
        4 * table.numel() + 4 * (listed + (len(lists) - 3)
                                 * bins.counts.numel())
        + 16 * table.shape[0] + 4 * hp * wp * (2 * channels + 2),
        box_px * card_common.TEST_FLOPS
        + covered * card_common.attr_flops(channels))
    print(f"[{tag}] {name} table {tuple(table.shape)}, listed {listed}, "
          f"largest tile {int(bins.counts.max())}, tiles "
          f"{cfg.tile_h}x{cfg.tile_w}, padded {hp}x{wp}: faces tested per "
          f"pixel without the cull {before:.2f}, culled {after:.2f} (warps of "
          f"4 x 8 pixels; of 1 x 32: {rows32:.2f}); bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} ({card})")
    first = None
    for label, fn in variants.items():
        got = fn()[:3]
        torch.cuda.synchronize()
        fid_bad = int((got[1] != want[1]).sum())
        z_bad = int((got[2] != want[2]).sum())
        pix_bad = int((~torch.isclose(got[0], want[0],
                                      **card_common.TOL)).sum())
        first = first or got
        same = all(torch.equal(a, b) for a, b in zip(got, first))
        print(f"[{tag}] {label}: fid mismatches {fid_bad}, zbuf mismatches "
              f"{z_bad}, pixels outside allclose {pix_bad} (padded arrays), "
              f"all outputs equal to the first variant's {same}")
        if fid_bad or z_bad or pix_bad or not same:
            raise RuntimeError(f"[{tag}] {label} {name} is wrong")
    _time(tag, card, variants, runs, (name, "cull_boxes"))
    return table, bins, bg_chw, cfg, want, cull


def _bench_fused(tag, engine, face_verts, face_attrs, weights, forward,
                 card, runs, parents):
    """K6 (``engine`` "dense") or K8 ("csr") on the outputs of one forward
    (``_bench_forward``'s return), this tree's and each parent's."""
    from dirt_tpu_torch.ops import fused_bwd, packed_bwd
    from dirt_tpu_torch.ops.triangle_setup import setup_planes

    table, bins, bg_chw, cfg, (pix, fid, zbuf), cull = forward
    num_faces = face_verts.shape[0]
    channels, hp, wp = pix.shape
    fields = packed_bwd.padded_prologue(fid, zbuf, pix.permute(1, 2, 0),
                                        weights, cfg.tile_h, cfg.tile_w)
    geo = setup_planes(face_verts, face_attrs)[0].contiguous()
    if engine == "csr":
        name, wrapper, n_rows = ("fused_bwd_csr", "fused_backward_rows_csr",
                                 num_faces)
        args = (geo, bins.entry_face, bins.start_block, bins.counts,
                *fields, n_rows)
        want = fused_bwd.fused_backward_rows_csr_plain(geo, *fields, n_rows)
    else:
        name, wrapper, n_rows = ("fused_bwd", "fused_backward_rows",
                                 num_faces + 1)
        args = (geo, bins.bins, bins.counts, *fields, n_rows)
        want = fused_bwd.fused_backward_rows_plain(geo, *fields, n_rows)
    geom = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    new = getattr(fused_bwd, wrapper)
    variants = {"new": functools.partial(
        new, *args, **_boxes_of(new, bins.bbox, cull), **geom)}
    for label, parent in parents.items():
        old = getattr(parent.fused_bwd, wrapper)
        variants[label] = functools.partial(
            old, *args, **_boxes_of(old, bins.bbox, cull), **geom)
    covered = int((fid >= 0).sum())
    listed = int(bins.counts.sum())
    lists = len(args) - len(fields) - 2
    bound = card_common.bound(
        4 * 17 * num_faces + 4 * (listed + (lists - 1) * bins.counts.numel())
        + 4 * hp * wp * (6 + 2 * channels)
        + 4 * want.numel(), covered * card_common.core_flops(channels))
    print(f"[{tag}] {name} rows {tuple(want.shape)}, listed {listed} of "
          f"{args[1].numel()} slots, covered {covered} px: bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} ({card})")
    scale = want.abs().amax(dim=0, keepdim=True)
    for label, fn in variants.items():
        got = fn()
        again = fn()
        torch.cuda.synchronize()
        bad = int(((got - want).abs() > card_common.TOL_ROWS * scale
                   + 1e-6).sum())
        same = torch.equal(got, again)
        print(f"[{tag}] {label}: values outside the row limit {bad}, max "
              f"|diff| {float((got - want).abs().max()):.3g}, second run "
              f"equal {same}, sha256 of the rows {card_common.digest(got)}")
        if bad or not same:
            raise RuntimeError(f"[{tag}] {label} {name} is wrong")
    _time(tag, card, variants, runs, name + "_")


def _bench_packed(tag, prep, card, runs, parents):
    """K2 on the inputs one run of the packed backward hands
    ``packed_entry_rows`` (``prep``), this tree's and each parent's. Every
    variant's rows are held bit for bit against the plain version run on
    the CPU (on the card the plain version's index_add_ sums with atomicAdd,
    which flushes subnormal sums to zero: those differences are counted
    apart), against a second run of itself, and against this tree's rows;
    a parent that differs is reported and timed all the same (a tree with a
    pass cut out, timed to split the kernel's time, gives other rows).
    Returns the failures of this tree's kernel (an empty list when it
    passes)."""
    from dirt_tpu_torch.ops import packed_bwd

    table = packed_bwd._entry_table(prep)
    want = packed_bwd.packed_entry_rows_plain(prep, table, 0,
                                              prep.budget_chunks)
    # The plain version on the CPU as well, whose sums keep subnormals.
    bins_cpu = type(prep.bins)(*(None if v is None else v.cpu()
                                 for v in prep.bins))
    prep_cpu = packed_bwd._PackedBwdPrep(
        *(t.cpu() for t in (prep.fid_p, prep.bits, prep.sval, prep.pix_cf,
                            prep.grad_cf)),
        bins_cpu, prep.geo.cpu(), prep.att.cpu(), prep.channels, prep.k_cols,
        prep.tile_h, prep.tile_w, flat=prep.flat)
    want_cpu = packed_bwd.packed_entry_rows_plain(
        prep_cpu, table.cpu(), 0, prep.budget_chunks).to(want.device)
    channels, hp, wp = prep.pix_cf.shape
    bins = prep.bins
    live = card_common.packed_live(bins, prep.tile_h)
    covered = int((prep.fid_p >= 0).sum())
    bound = card_common.packed_backward_bound(bins, prep.tile_h, prep.fid_p,
                                              want.numel(), channels)
    passes = -(-prep.k_cols // packed_bwd.columns_per_pass(prep.fid_p.device))
    print(f"[{tag}] packed_bwd rows {tuple(want.shape)}, "
          f"{'flat-subtile' if prep.flat else 'image'} layout, live "
          f"iterations {live}, covered {covered} px, {passes} launch(es) of "
          f"at most {packed_bwd.columns_per_pass(prep.fid_p.device)} "
          f"columns: bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']} ({card})")
    variants = {"new": functools.partial(packed_bwd.packed_entry_rows, prep)}
    for label, parent in parents.items():
        variants[label] = _entry_rows_of(parent.packed_bwd, prep)
    failures = []
    first = None
    tiny = torch.finfo(torch.float32).tiny
    for label, fn in variants.items():
        got = fn()
        again = fn()
        torch.cuda.synchronize()
        # On the card the plain version's index_add_ sums with atomicAdd,
        # which flushes subnormal sums to zero; the kernel keeps them, so
        # the two can differ by less than the smallest normal float.
        bits_differ = got.view(torch.int32) != want.view(torch.int32)
        below = bits_differ & ((got - want).abs() < tiny)
        differ_cpu = int((got.view(torch.int32)
                          != want_cpu.view(torch.int32)).sum())
        same = torch.equal(got, again)
        first = got if first is None else first
        line = (f"[{tag}] {label}: values whose bits differ from the plain "
                f"version's on the CPU {differ_cpu} of {want.numel()}, from "
                f"its on the card {int(bits_differ.sum())} ("
                f"{int(below.sum())} of them by less than the smallest "
                f"normal float; max |diff| "
                f"{float((got - want).abs().max()):.3g}), second run equal "
                f"{same}, equal to this tree's rows {torch.equal(got, first)}")
        if label == "new":
            mid = prep.budget_chunks // 2
            halves = torch.cat([packed_bwd.packed_entry_rows(prep, 0, mid),
                                packed_bwd.packed_entry_rows(prep, mid)])
            composed = torch.equal(halves, got)
            line += f", chunk slices [0, {mid}) + [{mid}, end) equal {composed}"
            if differ_cpu or not same or not composed:
                failures.append(tag)
        print(line)
    _time(tag, card, variants, runs, "packed_bwd")
    if any(hasattr(p.packed_bwd, "_entry_table_rows")
           for p in parents.values()):
        _time(tag, card, {"the older trees' row gather": functools.partial(
            _row_gather, table, bins)}, runs, "gather")
    return failures


def _bench_packed_forward(tag, call, card, runs, parents):
    """K1 on what one run of the op hands ``raster_forward_packed``
    (``call``: (args, kwargs)), this tree's and each parent's; fid, zbuf and
    pixels held bit for bit against the plain version. Returns the
    failures of this tree's kernel."""
    from dirt_tpu_torch.ops import raster_fwd

    (table2, bins, bg_chw), kwargs = call
    geom = dict(tile_h=kwargs["tile_h"], tile_w=kwargs["tile_w"])
    want = raster_fwd.raster_forward_packed_plain(table2, bins, bg_chw,
                                                  **geom)
    covered = int((want[1] >= 0).sum())
    bound = card_common.packed_forward_bound(
        bins, geom["tile_h"], bg_chw.shape[0], want[1])
    print(f"[{tag}] raster_fwd_packed table {tuple(table2.shape)}, "
          f"{bins.entries.shape[0]} budget rows, bg "
          f"{tuple(bg_chw.shape)}, tile_h {geom['tile_h']}, live iterations "
          f"{card_common.packed_live(bins, geom['tile_h'])}, covered "
          f"{covered} px: bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']} ({card})")
    variants = {"new": _packed_forward_of(raster_fwd, table2, bins, bg_chw,
                                          geom)}
    for label, parent in parents.items():
        variants[label] = _packed_forward_of(parent.raster_fwd, table2, bins,
                                             bg_chw, geom)
    failures = []
    for label, fn in variants.items():
        got = fn()
        torch.cuda.synchronize()
        bad = [int((g.view(torch.int32) != w.view(torch.int32)).sum())
               for g, w in zip(got, want)]
        print(f"[{tag}] {label}: values whose bits differ from the plain "
              f"version's: pixels {bad[0]}, fid {bad[1]}, zbuf {bad[2]} "
              f"({card})")
        if label == "new" and any(bad):
            failures.append(tag)
    _time(tag, card, variants, runs, "raster_fwd_packed")
    if any("rows" in inspect.signature(
            p.raster_fwd.raster_forward_packed).parameters
           for p in parents.values()):
        _time(tag, card, {"the older trees' row gather": functools.partial(
            _row_gather, table2, bins)}, runs, "gather")
    return failures


def _bench_prologue(tag, args, card, runs, parents):
    """K3 on what one backward hands ``padded_prologue`` (``args``), this
    tree's and each parent's; the five outputs held bit for bit against
    the plain version. Returns the failures of this tree's kernel."""
    from dirt_tpu_torch.ops import packed_bwd

    fid, _, pixels, grad, tile_h, tile_w = args
    want = packed_bwd.padded_prologue_plain(*args)
    height, width, channels = pixels.shape
    _, hp, wp = want[3].shape
    bound = card_common.prologue_bound(height, width, hp, wp, channels)
    old_bound = card_common.bound(4 * hp * wp * (2 + 2 * channels + 5), 0)
    print(f"[{tag}] packed_prologue {height}x{width} -> {hp}x{wp}, "
          f"{channels} channels, pixels strides {pixels.stride()}, grad "
          f"strides {grad.stride()} {grad.dtype}: bound of the call "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} (of the "
          f"prologue alone on padded fields, 2 + 2C planes read and 5 "
          f"written: {old_bound['bound_ms']:.4f} ms) ({card})")
    variants = {"new": functools.partial(packed_bwd.padded_prologue, *args)}
    for label, parent in parents.items():
        variants[label] = functools.partial(parent.packed_bwd.padded_prologue,
                                            *args)
    failures = []
    names = ("fid_p", "bits", "sval", "pix_cf", "grad_cf")
    for label, fn in variants.items():
        got = fn()
        torch.cuda.synchronize()
        bad = {n: int((g.view(torch.int32) != w.view(torch.int32)).sum())
               for n, g, w in zip(names, got, want)}
        print(f"[{tag}] {label}: values whose bits differ from the plain "
              f"version's {bad} ({card})")
        if label == "new" and any(bad.values()):
            failures.append(tag)
    _time(tag, card, variants, runs, "packed_prologue")
    return failures


def _bench_setup(tag, face_verts, face_attrs, engine, card, runs):
    """KP on what the raster op's forward hands ``setup_faces`` in a cell,
    beside its plain version; every output held bit for bit to the plain
    version's. Returns the failures."""
    from _torch_port_scene import bits_equal
    from dirt_tpu_torch.ops import triangle_setup

    size = card_common.SIZE
    args = (face_verts, face_attrs, size, size, engine)
    variants = {"new": functools.partial(triangle_setup.setup_faces, *args),
                "plain": functools.partial(triangle_setup.setup_faces_plain,
                                           *args)}
    num_faces, channels = face_verts.shape[0], face_attrs.shape[-1]
    # Corners and attributes in; geo, att, valid, the boxes and, packed,
    # the edge columns out; ~70 operations a face and ~10 a channel.
    per_face = 161 + 24 * channels + (36 if engine == "packed" else 0)
    bound = card_common.bound(num_faces * per_face,
                              num_faces * (70 + 10 * channels))
    print(f"[{tag}] setup_fwd {num_faces} faces, C={channels}, {engine} "
          f"layout: bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
          f"({card})")

    def flat(out):
        return [t for v in out if v is not None
                for t in (v if isinstance(v, tuple) else (v,))]

    got, want = (flat(fn()) for fn in variants.values())
    same = len(got) == len(want) and all(
        bits_equal(a, b) for a, b in zip(got, want))
    print(f"[{tag}] new: every output bit-equal to the plain version's "
          f"{same}")
    _time(tag, card, variants, runs, "setup_fwd")
    return [] if same else [tag]


def _packed_calls(step):
    """The prepared inputs one run of ``step()`` hands
    ``packed_entry_rows``."""
    from dirt_tpu_torch.ops import packed_bwd

    return [args[0] for args, _ in card_common.calls(
        packed_bwd, "packed_entry_rows", step)]


def _bench_needles(card, parent):
    """K6, K8, K9 and K10, new and old, on what the backward hands them on
    the far-needle scenes of ``tests/test_torch_cuda.py`` (needles whose
    far corners lie 1e3 to 1e6 pixels off a 128 x 256 image): the fused
    kernels on the op's backward, the scatters on two slabs of
    ``rasterise_sharded``. Prints the values outside the card tests' limits
    (the row limit, and 1e-5 of the sum of the value's terms' magnitudes +
    1e-9, which one dropped pixel exceeds)."""
    from _torch_port_scene import needle_soup
    from dirt_tpu_torch.ops import fused_bwd, raster, scatter
    from dirt_tpu_torch.parallel.group import LocalGroup
    from dirt_tpu_torch.parallel.sharding import rasterise_sharded

    device = torch.device("cuda", 0)
    engines = {"dense": dict(engine="dense", streaming=False),
               "csr": dict(streaming=True)}
    for seed in (0, 1, 5):
        fv, fa = (torch.tensor(a).to(device) for a in needle_soup(
            200, 128, 256, seed, (3.0, 6.0), (-6.0, 0.0)))
        rng = np.random.RandomState(seed)
        bg, w = (torch.tensor(a.astype(np.float32), device=device)
                 for a in (rng.rand(128, 256, 3), rng.randn(128, 256, 3)))
        xs, ys = fv[..., 0].double(), fv[..., 1].double()
        verts = torch.stack([2.0 * xs / 256 - 1.0, 1.0 - 2.0 * ys / 128,
                             fv[..., 2].double(), torch.ones_like(xs)],
                            -1).float().reshape(-1, 4)
        faces = torch.arange(verts.shape[0], device=device).reshape(-1, 3)
        for engine, fields in engines.items():
            config = raster.RasterConfig(tile_h=32, tile_w=128, bin_cap=2048,
                                         expand_cap=64, **fields)
            fused = {"dense": "fused_backward_rows",
                     "csr": "fused_backward_rows_csr"}[engine]
            scat = {"dense": "scatter_to_faces",
                    "csr": "scatter_to_faces_csr"}[engine]

            def op_step():
                v = fv.clone().requires_grad_()
                (raster.rasterize_screen(v, fa, bg, config)[0] * w
                 ).sum().backward()

            def sharded_step():
                v = verts.clone().requires_grad_()
                (rasterise_sharded(bg, v, fa.reshape(-1, 3), faces,
                                   LocalGroup(2), config=config) * w
                 ).sum().backward()

            cases = []
            for args, kwargs in card_common.calls(fused_bwd, fused,
                                                  op_step):
                geo, *_, fid, bits, sval, pix, grad, n_rows = args
                rows = n_rows + 1 if engine == "csr" else n_rows
                want = fused_bwd.fused_backward_rows_plain(
                    geo, fid, bits, sval, pix, grad, rows)
                terms = fused_bwd.pixel_rows_plain(geo, fid, bits, sval,
                                                   pix, grad)
                owned = fid.reshape(-1) >= 0
                mass = torch.zeros(want.shape, dtype=torch.float64,
                                   device=device).index_add_(
                    0, fid.reshape(-1)[owned].long(),
                    terms[owned].abs().double())
                cases.append((fused, fused_bwd, parent and parent.fused_bwd,
                              args, kwargs, want, mass.float()))
            for slab, (args, kwargs) in enumerate(
                    card_common.calls(scatter, scat, sharded_step)):
                cot, fid_p, *_, n_out = args
                plain = getattr(scatter, scat + "_plain")
                cases.append((f"{scat} slab {slab}", scatter,
                              parent and parent.scatter, args, kwargs,
                              plain(cot, fid_p, n_out),
                              plain(cot.abs(), fid_p, n_out)))
            for name, new_mod, old_mod, args, kwargs, want, mass in cases:
                geom = dict(tile_h=kwargs["tile_h"], tile_w=kwargs["tile_w"])
                wrapper = name.split()[0]
                trees = [("new", getattr(new_mod, wrapper))]
                if old_mod is not None:
                    trees.append(("old", getattr(old_mod, wrapper)))
                for label, fn in trees:
                    got = fn(*args, **_boxes_of(fn, kwargs["bbox"],
                                                kwargs["cull"]), **geom)
                    torch.cuda.synchronize()
                    got, ref = got[:want.shape[0]], want[:got.shape[0]]
                    diff = (got - ref).abs()
                    scale = ref.abs().amax(dim=0, keepdim=True)
                    rows_bad = int((diff > card_common.TOL_ROWS * scale
                                    + 1e-6).sum())
                    value_bad = int((diff > card_common.TOL_ROWS
                                     * mass[:got.shape[0]] + 1e-9).sum())
                    print(f"[needles far-needles-{seed} {engine}] {name} "
                          f"{label}: values outside the row limit "
                          f"{rows_bad}, outside the per-value limit "
                          f"{value_bad} of {got.numel()} ({card})")


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
    from dirt_tpu_torch.ops import raster_fwd

    hp, wp = arrays[0].shape[-2:]
    stacked = torch.cat([a.view(torch.int32).reshape(-1, hp, wp)
                         for a in arrays])
    view = stacked.reshape(-1, hp // 8, 8, wp // 128, 8, 16).transpose(-4, -2)
    variants = {"new": lambda: raster_fwd.flat_subtile_swap(arrays)}
    if parent is not None:
        variants["old"] = lambda: parent.raster_fwd.flat_subtile_swap(arrays)
    variants["strided copy"] = view.contiguous
    bound = card_common.bound(2 * 4 * stacked.numel(), 0)
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
                        "whose kernels are timed beside this one's; for K1, "
                        "K2, K3, K6 and K8 several, separated by commas")
    parser.add_argument("--runs", type=int, default=20)
    parser.add_argument("--kernels", default="K5,K6,K7,K8,K4,K2,K1,K3,KP",
                        help="which of K5, K6, K7, K8, K4, K2, K1, K3, KP "
                        "to time (K6 "
                        "runs K5 and K8 runs K7 for their inputs); NEEDLES "
                        "holds K6, K8, K9, K10 of both trees against their "
                        "plain versions on far needles")
    parser.add_argument("--spheres", default="224",
                        help="uv_sphere(n, n) resolutions of the default "
                        "API's CSR scenes for K7 and K8 (224: 99,904 faces, "
                        "at 3 and 9 channels; any other n at 3)")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_raster_ab: torch.cuda.is_available() is False")
    import bench_configs_torch
    import dirt_tpu_torch
    from dirt_tpu_torch import entry
    from dirt_tpu_torch.ops import _build
    from dirt_tpu_torch.ops.triangle_setup import screen_from_clip
    from dirt_tpu_torch.parallel.group import LocalGroup
    from dirt_tpu_torch.parallel.sharding import rasterise_sharded
    from dirt_tpu_torch.utils.benchtime import card_line

    kernels = opts.kernels.split(",")
    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    _build.build(_build.KERNELS)
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build {name}] {line.strip()}")
    roots = opts.parent.split(",") if opts.parent else []
    parents = {("old" if len(roots) == 1 else f"old {Path(root).name}"):
               _parent_module(root, f"parent{i}")
               for i, root in enumerate(roots)}
    parent = next(iter(parents.values()), None)

    size = card_common.SIZE
    _, clip, colors, faces, background, weights = card_common.bench_scene(
        size, device)
    if "K7" in kernels or "K8" in kernels:
        weights9 = card_common.rand(4, size, size, 9, device=device)
        scenes = []
        for n in (int(v) for v in opts.spheres.split(",")):
            big_loss, (big_bg, big_clip, big_colors), (big_faces, big_cfg) = \
                card_common.big_sphere_step(device, n)
            n_big = big_faces.shape[0]
            with torch.no_grad():
                scenes.append((f"{n_big}-face sphere {size}^2 C=3",
                               card_common.raster_inputs(
                                   lambda: big_loss(big_bg, big_clip,
                                                    big_colors)), weights))
                if n == 224:
                    scenes.append((
                        f"{n_big}-face sphere {size}^2 C=9",
                        card_common.raster_inputs(
                            lambda: dirt_tpu_torch.rasterise(
                                torch.zeros((size, size, 9), device=device),
                                big_clip, card_common.rand(
                                    3, big_clip.shape[0], 9, device=device),
                                big_faces, config=big_cfg)), weights9))
        with torch.no_grad():
            stream_cfg = dirt_tpu_torch.suggest_raster_config(
                clip, faces, size, size,
                config=dirt_tpu_torch.RasterConfig(streaming=True),
                clip=False)
            bench = card_common.raster_inputs(
                lambda: dirt_tpu_torch.rasterise(
                    background, clip, colors, faces, config=stream_cfg,
                    clip=False))
        scenes.append((f"bench sphere {size}^2 streaming=True", bench,
                       weights))
        for tag, inputs, w in scenes:
            forward = _bench_forward(f"K7 {tag}", "csr", inputs, card,
                                     opts.runs, parent)
            if "K8" in kernels:
                _bench_fused(f"K8 {tag}", "csr", inputs[0], inputs[1], w,
                             forward, card, opts.runs, parents)
            del forward
        del scenes, bench

    if "K5" in kernels or "K6" in kernels:
        # Three shapes, each with the faces its path's own render hands
        # the raster op, and their upstream gradients.
        dense_cfg = dirt_tpu_torch.suggest_raster_config(
            clip, faces, size, size,
            config=dirt_tpu_torch.RasterConfig(engine="dense"), clip=False)
        face_verts = screen_from_clip(clip, size, size)[faces]
        config4 = bench_configs_torch.config4(device)
        c4_loss, c4_leaves = config4.loss, config4.leaves
        step_fn, (e_verts, e_pose) = entry.entry()
        with torch.no_grad():
            c4 = card_common.raster_inputs(lambda: c4_loss(*c4_leaves))
            flagship = card_common.raster_inputs(
                lambda: step_fn(e_verts, e_pose))
        for tag, inputs, w in (
                (f"bench sphere {size}^2 dense",
                 (face_verts, colors[faces], background, dense_cfg),
                 weights),
                ("config 4 512^2", c4,
                 card_common.rand(1, 512, 512, 3, device=device)),
                ("flagship G-buffer 256^2 C=9", flagship,
                 card_common.rand(5, 256, 256, 9, device=device))):
            forward = _bench_forward(f"K5 {tag}", "dense", inputs, card,
                                     opts.runs, parent)
            if "K6" in kernels:
                _bench_fused(f"K6 {tag}", "dense", inputs[0], inputs[1], w,
                             forward, card, opts.runs, parents)

    if "NEEDLES" in kernels:
        _bench_needles(card, parent)

    if "K1" in kernels or "K2" in kernels:
        # The 1,001,112-face sphere of the sphere1m_1024 config, clip off,
        # under its honest packed caps.
        (_, clip1m, colors1m, faces1m, bg1m, w1m), cfg1m = \
            card_common.scene_and_config(device, size, 708)
        tag1m = f"{faces1m.shape[0]:,}-face sphere {size}^2 packed C=3"

    if "K2" in kernels:
        # The packed backward's five shapes: the 1M sphere, the bench's
        # main path (clip off), config 5's G-buffer, 16 channels (two
        # launches), and one slab of the sharded packed path (flat-subtile
        # fields).
        packed_cfg = dirt_tpu_torch.suggest_raster_config(
            clip, faces, size, size, clip=False)
        config5 = bench_configs_torch.config5(device)
        render5, leaves5 = config5.forward, config5.leaves
        w5 = card_common.rand(1, size, size, 3, device=device)

        def config5_step():
            fresh = [t.detach().clone().requires_grad_() for t in leaves5]
            (render5(*fresh) * w5).sum().backward()

        colors16 = card_common.rand(5, clip.shape[0], 16, device=device)
        scenes16 = (torch.zeros((size, size, 16), device=device), clip,
                    colors16, faces,
                    card_common.rand(6, size, size, 16, device=device))
        shapes = [
            (tag1m, lambda: card_common.render_grads(
                dirt_tpu_torch.rasterise_with_aux, bg1m, clip1m, colors1m,
                faces1m, w1m, cfg1m, False)),
            (f"bench sphere {size}^2 packed clip=False C=3",
             lambda: card_common.render_grads(
                 dirt_tpu_torch.rasterise_with_aux, background, clip, colors,
                 faces, weights, packed_cfg, False)),
            (f"config 5 {size}^2 C=9", config5_step),
            (f"bench sphere {size}^2 packed C=16",
             lambda: card_common.render_grads(
                 dirt_tpu_torch.rasterise_with_aux, *scenes16[:4],
                 scenes16[4], packed_cfg, False)),
            (f"sharded packed slab {size}^2 C=3 (flat layout)",
             lambda: card_common.render_grads(
                 lambda bg, v, c, f, config, clip: rasterise_sharded(
                     bg, v, c, f, LocalGroup(1), config=config,
                     with_aux=True),
                 background, clip, colors, faces, weights, packed_cfg,
                 False)),
        ]
        failures = []
        for tag, step in shapes:
            (prep,) = _packed_calls(step)
            failures += _bench_packed(f"K2 {tag}", prep, card, opts.runs,
                                      parents)
            del prep
        if failures:
            raise RuntimeError(f"K2 is wrong on: {failures}")

    if "K1" in kernels:
        # The packed forward's five shapes, as the op hands them to it.
        from dirt_tpu_torch.ops import raster_fwd

        packed_cfg = dirt_tpu_torch.suggest_raster_config(
            clip, faces, size, size, clip=False)
        config5 = bench_configs_torch.config5(device)
        render5, leaves5 = config5.forward, config5.leaves
        colors16 = card_common.rand(5, clip.shape[0], 16, device=device)
        shapes = [
            (tag1m, lambda: dirt_tpu_torch.rasterise(
                bg1m, clip1m, colors1m, faces1m, config=cfg1m, clip=False)),
            (f"bench sphere {size}^2 packed clip=False C=3",
             lambda: dirt_tpu_torch.rasterise(
                 background, clip, colors, faces, config=packed_cfg,
                 clip=False)),
            (f"config 5 {size}^2 C=9", lambda: render5(*leaves5)),
            (f"bench sphere {size}^2 packed C=16",
             lambda: dirt_tpu_torch.rasterise(
                 torch.zeros((size, size, 16), device=device), clip,
                 colors16, faces, config=packed_cfg, clip=False)),
            (f"sharded packed slab {size}^2 C=3",
             lambda: rasterise_sharded(
                 background, clip, colors, faces, LocalGroup(1),
                 config=packed_cfg)),
        ]
        failures = []
        for tag, run in shapes:
            with torch.no_grad():
                (call,) = card_common.calls(
                    raster_fwd, "raster_forward_packed", run)
            failures += _bench_packed_forward(f"K1 {tag}", call, card,
                                              opts.runs, parents)
            del call
        if failures:
            raise RuntimeError(f"K1 is wrong on: {failures}")

    if "K3" in kernels:
        # What the single-device backwards hand the prologue: packed (the
        # bench's main path and config 5), CSR (the default API's 99,904
        # faces), dense (config 4, the flagship step).
        from dirt_tpu_torch.ops import packed_bwd

        packed_cfg = dirt_tpu_torch.suggest_raster_config(
            clip, faces, size, size, clip=False)
        config5 = bench_configs_torch.config5(device)
        render5, leaves5 = config5.forward, config5.leaves
        w5 = card_common.rand(1, size, size, 3, device=device)

        def grad_step(loss_fn, leaves):
            def step():
                fresh = [t.detach().clone().requires_grad_() for t in leaves]
                loss_fn(*fresh).backward()
            return step

        big_loss, big_leaves, _ = card_common.big_sphere_step(device)
        colors16 = card_common.rand(5, clip.shape[0], 16, device=device)
        shapes = [
            (f"bench sphere {size}^2 packed clip=False C=3",
             lambda: card_common.render_grads(
                 dirt_tpu_torch.rasterise_with_aux, background, clip, colors,
                 faces, weights, packed_cfg, False)),
            (f"config 5 {size}^2 C=9", grad_step(
                lambda v, p: (render5(v, p) * w5).sum(), leaves5)),
            (f"bench sphere {size}^2 packed C=16",
             lambda: card_common.render_grads(
                 dirt_tpu_torch.rasterise_with_aux,
                 torch.zeros((size, size, 16), device=device), clip,
                 colors16, faces,
                 card_common.rand(6, size, size, 16, device=device),
                 packed_cfg, False)),
            (f"default API 99,904 faces {size}^2 csr C=3",
             grad_step(big_loss, big_leaves)),
            ("config 4 512^2 dense C=3",
             grad_step(config4.loss, config4.leaves)),
            ("flagship 256^2 dense C=9", grad_step(*entry.entry())),
        ]
        failures = []
        for tag, step in shapes:
            (call,) = card_common.calls(packed_bwd, "padded_prologue", step)
            failures += _bench_prologue(f"K3 {tag}", call[0], card,
                                        opts.runs, parents)
            del call
        if failures:
            raise RuntimeError(f"K3 is wrong on: {failures}")

    if "KP" in kernels:
        failures = []
        for n, clip_on, channels, engine in ((708, False, 3, "packed"),
                                             (224, True, 3, "csr"),
                                             (72, True, 9, "packed")):
            fv, fa = card_common.sphere_faces(n, clip_on, device)
            if channels != 3:
                fa = card_common.rand(n, *fa.shape[:2], channels,
                                      device=device)
            failures += _bench_setup(
                f"KP {fv.shape[0]} faces clip={clip_on} C={channels}", fv,
                fa, engine, card, opts.runs)
            del fv, fa
        if failures:
            raise RuntimeError(f"KP is wrong on: {failures}")

    if "K4" in kernels:
        packed_cfg = dirt_tpu_torch.suggest_raster_config(
            clip, faces, size, size, clip=False)
        colors9 = card_common.rand(3, clip.shape[0], 9, device=device)
        for c, cols, bg, w in (
                (3, colors, background, weights),
                (9, colors9, torch.zeros((size, size, 9), device=device),
                 card_common.rand(4, size, size, 9, device=device))):
            arrays = _swap_arrays(lambda: card_common.render_grads(
                lambda bg, v, c, f, config, clip: rasterise_sharded(
                    bg, v, c, f, LocalGroup(1), config=config,
                    with_aux=True),
                bg, clip, cols, faces, w, packed_cfg, False))
            _bench_swap(f"K4 sharded packed halo fields {size}^2 C={c}",
                        arrays, card, opts.runs, parent)


if __name__ == "__main__":
    main()
