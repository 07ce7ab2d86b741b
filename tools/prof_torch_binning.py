#!/usr/bin/env python3
"""What the packed binning of dirt_tpu_torch spends, stage by stage and
primitive by primitive, on one CUDA card.

    python3 tools/prof_torch_binning.py [size] [--n-lat N] [--samples S]

Counterpart of ``tools/prof_binning.py``, on the scene and caps of
``tools/prof_torch_stages.py`` (the bench sphere at ``size`` x ``size``,
1024 by default; ``--n-lat 708`` the 1,001,112-face sphere). Prints:

* ``bin_faces_packed`` on the scene's fixed setup outputs, whole and
  through each ``_stage`` hook (11, 12, 13, 1, 2, ..., 7: cumulative, with
  each stage's increment), min and median ms of event-timed synchronised
  calls, and each stage's checksum;
* the primitives at the scene's own sizes (``pool_cap``, ``nsid``, the
  merged length, the live prefix and ``budget_rows`` of the config), in ms
  and ns per element: the merged sort (one combined int64 key,
  ``torch.sort(stable=True)``, the port's choice, with its two gathers;
  the sort alone; a two-key lexicographic sort as two stable sorts), the
  ``[pool, 16]`` row gather beside the port's 13 column gathers, the
  entries gather, scatter-add pool -> nsid and scatter-set F -> pool, on
  random data made from a seed with numpy;
* each of the binning's five running maxima (``binning._cummax``: the
  max-scan kernel of ``ops/scan.py`` on a card) on the very input it gets
  in this scene (captured from one call), and beside each
  ``torch.cummax``, which the binning ran before the kernel; the two must
  give equal values.

With a card, every line also gives the device busy ms a call from a
profiler window (``card_common.profile``). Prints the card's name
and power limit; exits non-zero without a CUDA device. ``run`` returns
the records.
"""

import argparse
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import card_common  # noqa: E402
from card_common import (  # noqa: E402
    PROFILE_STEPS,
    SAMPLES,
    SAMPLES_LARGE,
    Geometry,
    bin_faces,
    scene_and_config,
    setup,
)
from dirt_tpu_torch.ops import binning  # noqa: E402
from dirt_tpu_torch.utils.benchtime import device_time_stats  # noqa: E402

# The ``_stage`` hooks of ``bin_faces_packed`` in pipeline order.
STAGES = ((11, "1a pool face_of / s0_of"), (12, "1b pool ey / ex + fields"),
          (13, "1c pool edge filter"), (1, "1 pool construction"),
          (2, "2 merged sort + rank"), (3, "3 subtile counts"),
          (4, "4 grid prefix math"), (5, "5 pair placement"),
          (6, "6 entries scatter"), (7, "7 pair_rows (bwd inverse)"))
# The five ``_cummax`` calls of ``bin_faces_packed`` in call order: (name,
# the array it scans).
CUMMAX_CALLS = (("face_of", "pool"), ("s0_of", "pool"),
                ("run_start", "merged"), ("x8_run", "merged"),
                ("lim8_run", "merged"))


def stage_checksums(bbox, edges, geom):
    """{stage: checksum} of every ``_stage`` hook on these inputs."""
    return {stage: int(bin_faces(bbox, edges, geom, _stage=stage))
            for stage, _ in STAGES}


def capture_cummax(bbox, edges, geom):
    """The inputs of the five ``_cummax`` calls of one ``bin_faces_packed``
    call, in call order."""
    seen = []
    scan = binning._cummax

    def record(x):
        seen.append(x.clone())
        return scan(x)

    with mock.patch.object(binning, "_cummax", record):
        bin_faces(bbox, edges, geom)
    if len(seen) != len(CUMMAX_CALLS):
        raise RuntimeError(f"bin_faces_packed made {len(seen)} cummax "
                           f"calls, want {len(CUMMAX_CALLS)}")
    return seen


def sizes(geom, num_faces):
    """The binning's array sizes under ``geom``: pool, nsid, merged (pool +
    nsid headers), live (the ``work_cap`` prefix) and rows."""
    tiles_y, tiles_x, strips, groups = binning.packed_grid(
        geom.hp, geom.wp, geom.tile_h, geom.tile_w)
    nsid = tiles_y * tiles_x * strips * groups
    pool = geom.pool_cap or binning.auto_pool_cap(num_faces, geom.expand)
    pool = max(-(-pool // binning.POOL_ALIGN) * binning.POOL_ALIGN,
               binning.POOL_ALIGN)
    merged = pool + nsid
    live = merged
    if geom.work_cap is not None:
        live = min(max(-(-geom.work_cap // 8) * 8,
                       nsid + binning.POOL_ALIGN), merged)
    return dict(pool=pool, nsid=nsid, merged=merged, live=live,
                rows=geom.budget * binning.GROUPS)


def primitives(device, n, num_faces, seed=0):
    """[(name, elements, fn, args)] of the primitives at the sizes ``n``
    (:func:`sizes`), on random data from ``seed``."""
    rng = np.random.RandomState(seed)

    def tensor(a):
        return torch.as_tensor(a, device=device)

    pool, nsid, merged, rows = n["pool"], n["nsid"], n["merged"], n["rows"]
    sid = tensor(rng.randint(0, nsid + 1, merged).astype(np.int64))
    face = tensor(rng.randint(-1, num_faces, merged).astype(np.int64))
    key = sid * (num_faces + 1) + (face + 1)

    def sort_gather(k, s, f):
        order = torch.sort(k, stable=True).indices
        return s[order], f[order]

    def sort_two_keys(s, f):
        by_face = torch.sort(f, stable=True).indices
        order = by_face[torch.sort(s[by_face], stable=True).indices]
        return s[order], f[order]

    table = tensor(rng.rand(num_faces, 16).astype(np.float32))
    columns = [tensor(rng.randint(0, 64, num_faces).astype(np.int64))
               for _ in range(4)] + [
        tensor(rng.rand(num_faces).astype(np.float32)) for _ in range(9)]
    pidx = tensor(rng.randint(0, num_faces, pool).astype(np.int64))
    src = tensor(rng.randint(0, merged, rows).astype(np.int64))
    upd = tensor(rng.randint(0, nsid, pool).astype(np.int64))
    starts = min(num_faces, pool)
    slot0 = tensor(np.sort(rng.choice(pool, starts, replace=False))
                   .astype(np.int64))
    fidx = torch.arange(starts, dtype=torch.int64, device=device)
    return [
        ("merged sort: int64 key, stable, + 2 gathers (the port's)", merged,
         sort_gather, (key, sid, face)),
        ("merged sort: int64 key alone", merged,
         lambda k: torch.sort(k, stable=True).values, (key,)),
        ("merged sort: two keys, two stable sorts + 2 gathers", merged,
         sort_two_keys, (sid, face)),
        ("row gather [pool, 16] f32", pool, lambda t, i: t[i],
         (table, pidx)),
        ("13 column gathers [pool] (the port's)", pool,
         lambda i, *cols: [c[i] for c in cols], (pidx, *columns)),
        ("entries gather [rows]", rows, lambda f, s: f[s], (face, src)),
        ("scatter-add pool -> nsid", pool,
         lambda u: binning._add_drop(nsid, u, device), (upd,)),
        ("scatter-set F -> pool", pool,
         lambda s, f: binning._set_drop(
             torch.full((pool,), -1, dtype=torch.int64, device=device), s,
             f), (slot0, fidx)),
    ]


def run(device, size=1024, n_lat=72, samples=None, config=None,
        profile=PROFILE_STEPS, card=""):
    """Times the binning of the scene stage by stage and its primitives;
    returns {"faces", "size", "sizes", "full", "stages", "checksums",
    "primitives", "cummax"}. Timed records hold min and median ms (and
    when ``profile``, the calls of one profiler window, is not 0 (on a card
    only), device busy ms a call); stage
    records also the increment over the stage before, primitive records
    ns per element; cummax records the name, the size, the time of
    ``binning._cummax`` and beside it that of ``torch.cummax``
    (``library_*``). Raises if ``binning._cummax`` differs from
    ``torch.cummax``."""
    device = torch.device(device)
    scene, config = scene_and_config(device, size, n_lat, config)
    _, clip, colors, faces, _, _ = scene
    num_faces = faces.shape[0]
    if samples is None:
        samples = SAMPLES_LARGE if num_faces > 100_000 else SAMPLES
    geom = Geometry(config, num_faces, size)
    _, _, bbox, edges = setup(clip, colors, faces, size)
    del scene, clip, colors
    n = sizes(geom, num_faces)
    tag = f"binning {num_faces} faces {size}^2"
    print(f"[{tag}] caps {config}; pool {n['pool']}, nsid {n['nsid']}, "
          f"merged {n['merged']}, live prefix {n['live']}, rows {n['rows']};"
          f" {samples} samples a line ({card})")

    def timed(label, fn, args, elements=None):
        t_min, t_med = device_time_stats(fn, args, samples=samples)
        rec = dict(name=label, min_ms=t_min * 1e3, median_ms=t_med * 1e3)
        text = f"min {rec['min_ms']:.4f} ms, median {rec['median_ms']:.4f} ms"
        if elements:
            rec.update(elements=elements,
                       ns_per_element=rec["median_ms"] * 1e6 / elements)
            text += f" ({rec['ns_per_element']:.3f} ns/element of {elements})"
        if profile:
            rec["device_ms"] = card_common.profile(
                label, lambda: fn(*args), card, steps=profile,
                echo=False)["busy_ms"]
            text += f", device busy {rec['device_ms']:.4f} ms a call"
        return rec, text

    anchor = (bbox[0],)
    full, text = timed("full", lambda _: bin_faces(bbox, edges, geom), anchor)
    print(f"[{tag}] full bin_faces_packed: {text} ({card})")
    stages, prev = [], 0.0
    for stage, name in STAGES:
        rec, text = timed(
            name, lambda _, s=stage: bin_faces(bbox, edges, geom, _stage=s),
            anchor)
        rec.update(stage=stage, increment_ms=rec["median_ms"] - prev)
        prev = rec["median_ms"]
        print(f"[{tag}]   thru {name}: {text} (+{rec['increment_ms']:.4f})"
              f" ({card})")
        stages.append(rec)
    checksums = stage_checksums(bbox, edges, geom)
    print(f"[{tag}] stage checksums {checksums}")

    records = []
    for label, elements, fn, args in primitives(device, n, num_faces):
        rec, text = timed(label, fn, args, elements)
        print(f"[{tag}] {label}: {text} ({card})")
        records.append(rec)

    def library(v):
        return torch.cummax(v, 0).values

    scans = []
    for (name, kind), x in zip(CUMMAX_CALLS,
                               capture_cummax(bbox, edges, geom)):
        if not torch.equal(binning._cummax(x), library(x)):
            raise RuntimeError(f"[{tag}] binning._cummax differs from "
                               f"torch.cummax on {name}'s input")
        rec, text = timed(f"cummax {name}", binning._cummax, (x,),
                          x.shape[0])
        other, other_text = timed(f"library {name}", library, (x,),
                                  x.shape[0])
        rec.update(call=name, array=kind,
                   **{f"library_{k}": v for k, v in other.items()
                      if k.endswith("ms") or k == "ns_per_element"})
        print(f"[{tag}] cummax {name} [{kind} {x.shape[0]}]: "
              f"binning._cummax {text}; torch.cummax {other_text} (equal "
              f"values) ({card})")
        scans.append(rec)
        del x
    return dict(faces=num_faces, size=size, sizes=n, full=full,
                stages=stages, checksums=checksums, primitives=records,
                cummax=scans)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("size", type=int, nargs="?", default=1024)
    parser.add_argument("--n-lat", type=int, default=72)
    parser.add_argument("--samples", type=int)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("prof_torch_binning: torch.cuda.is_available() is False")
    from dirt_tpu_torch.ops import _build
    from dirt_tpu_torch.utils.benchtime import card_line

    _build.build(_build.KERNELS)
    card = card_line()
    print(card)
    run("cuda", args.size, args.n_lat, args.samples, card=card)


if __name__ == "__main__":
    main()
