"""Tile binning (PyTorch, static caps): packed-subtile and dense bins.

Counterpart of ``dirt_tpu/ops/binning.py``: the packed half
(``PackedBins`` .. ``bin_faces_packed``) and the dense engine's
``BinningResult`` / ``bin_faces`` and the streaming engine's ``CSRBins`` /
``bin_faces_csr`` (at the end of the module). Sorts, scans and scatters are
plain torch ops, but for the packed binning's five running maxima, which
launch the hand-written max-scan of ``ops/scan.py`` on CUDA tensors; the
layout, the static caps and the overflow flag are exactly the JAX
package's, and the tests hold every integer field to it.

Translation rules kept throughout:

* JAX's ``.at[i].set/add(..., mode="drop")`` drops out-of-range indices,
  where torch's indexing raises: every such scatter sends them to a dump
  slot past the end and cuts it off (no index here is ever negative, so
  JAX's wrap-around of negative indices never applies).
* ``jax.lax.sort`` over tied keys is not promised stable. The merged
  (subtile, face) sort uses one combined int64 key with
  ``torch.sort(stable=True)``; its ties are dead candidates that never
  reach an output. The two sorts the JAX code runs over unique keys
  (per-subtile run ends, and the pool-slot inverse of the placement) are
  scatters here: sorting unique keys and scattering by them give the same
  array.
* ``//`` on operands that can be negative is ``torch.div(...,
  rounding_mode="floor")`` (JAX floors). Index math runs in int64,
  torch's index type; the fields come out int32, like JAX's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dirt_tpu_torch.ops import scan
from dirt_tpu_torch.utils import trace

CHUNK = 128  # CSR chunk granularity: every tile's run starts at a multiple
             # of CHUNK rows, and ``bin_cap`` is rounded to it

# Packed-subtile geometry: jobs are (face, 8x16-pixel subtile) pairs; 8
# lane groups of 16 pixels tile a 128-wide strip row.
SUB_H = 8
SUB_W = 16
GROUPS = 8               # 128-column tile width / SUB_W
PACK_CHUNK = 512         # budget rows per chunk (64 iterations of 8 jobs)
POOL_ALIGN = 4           # pool slots per per-face run block
PACK_ITERS = PACK_CHUNK // GROUPS  # 64 iterations per packed chunk

_I32 = torch.int32
_I64 = torch.int64


class PackedBins(NamedTuple):
    """Lane-packed subtile bins for the packed engine.

    The image is carved into 8x16-pixel subtiles: strip s of tile t covers
    rows 8s..8s+8, and each 128-wide strip row holds 8 lane GROUPS of 16
    columns. An ITERATION processes one strip row: 8 jobs, one
    (face, subtile) pair per group.

    ``entries[8 * i + g]`` is the packed job of iteration ``i``, group
    ``g``: ``face_id * 8 + strip``, with the sentinel face ``F`` on empty
    slots. Iterations are laid out contiguously per tile (strips in
    ascending order, ranks within a (strip, group) run in ascending face
    order, which keeps the z-tie rule), and each tile's run is padded to
    whole PACK_CHUNK-row chunks. ``chunk_tile`` maps every chunk to its
    tile. All fields are int32 (``overflow`` a 0-dim bool) on the device of
    the input bbox.
    """

    entries: torch.Tensor      # [budget_rows] int32, face * 8 + strip
    chunk_tile: torch.Tensor   # [budget_rows // PACK_CHUNK] int32
    start_block: torch.Tensor  # [num_tiles] int32, first chunk of the tile
    n_iters: torch.Tensor      # [num_tiles] int32, real iterations
    overflow: torch.Tensor     # [] bool
    iter_off: torch.Tensor     # [num_tiles * strips] int32: first iteration
                               # (tile-local) of each strip's contiguous run
    strip_iters: torch.Tensor  # [num_tiles * strips] int32: run length
    # [pool_cap] int32, or None: budget row holding the candidate at each
    # pool slot (sentinel ``budget_rows`` where there is none) — the
    # inverse of the entries scatter, for the packed backward.
    pair_rows: torch.Tensor | None = None
    # [F + 1] int32, or None: POOL_ALIGN-slot-block offset of each face's
    # pool run (``pool_offs[F]`` the total), for the packed backward.
    pool_offs: torch.Tensor | None = None
    # [F + 1, table_width] f32, or None: the face table
    # (``raster_fwd.pack_face_table_v2``), attached by
    # ``ops.raster.prepare_packed``. The packed kernels read budget row r's
    # face row where it lies, at ``table[entries[r] >> 3]``.
    table: torch.Tensor | None = None
    # geo [F, 24] and att [F, 3C] f32, or None: the setup's planes,
    # attached by the forward for the backward.
    geo: torch.Tensor | None = None
    att: torch.Tensor | None = None


def num_tiles(height: int, width: int, tile_h: int, tile_w: int):
    return (-(-height // tile_h), -(-width // tile_w))


def packed_grid(height: int, width: int, tile_h: int, tile_w: int):
    """(tiles_y, tiles_x, strips_per_tile, groups) for the packed layout."""
    tiles_y, tiles_x = num_tiles(height, width, tile_h, tile_w)
    return tiles_y, tiles_x, tile_h // SUB_H, tile_w // SUB_W


def auto_packed_budget(num_faces: int, height: int, width: int,
                       tile_h: int, tile_w: int,
                       expand_cap: int | None = None) -> int:
    """Default iteration budget (static row storage = 8 * budget).

    Same heuristic as ``dirt_tpu.ops.binning.auto_packed_budget``: ~F
    iterations plus per-tile chunk padding, bounded by the job count when
    ``expand_cap`` is known; every tile keeps at least one chunk.
    Overflow is flagged; ``suggest_config`` measures the exact need.
    """
    tiles_y, tiles_x, strips, groups = packed_grid(
        height, width, tile_h, tile_w
    )
    total = tiles_y * tiles_x
    nsid = total * strips * groups
    budget = num_faces + nsid // 8 + total * (PACK_ITERS // 2)
    if expand_cap is not None:
        bound = (num_faces * expand_cap) // GROUPS * 2 + total * PACK_ITERS
        if num_faces * expand_cap >= 32 * nsid:
            # Dense regime: a 1.4x margin over the balanced estimate.
            bound = min(
                bound,
                (num_faces * expand_cap) // GROUPS * 7 // 5
                + total * PACK_ITERS,
            )
        budget = min(budget, bound)
    # Floor: every tile needs at least one chunk for its init step.
    budget = max(budget, (total + 2) * PACK_ITERS)
    return -(-budget // PACK_ITERS) * PACK_ITERS


def auto_packed_expand(num_faces: int, nsid: int) -> int:
    """Max subtile jobs per face: tight for dense meshes, generous for
    small F."""
    if num_faces > 4096:
        return 4 if nsid < 4096 else 8
    target = max(32, (8 * nsid) // max(num_faces, 1))
    cap = 32
    while cap < target and cap < nsid:
        cap *= 2
    return min(cap, max(nsid, 32))


def auto_pool_cap(num_faces: int, expand_cap: int) -> int:
    """Default flat-pool slot budget for :func:`bin_faces_packed` (~8
    slots per face, floored for tiny meshes, never more than every face at
    its full expand cap). Overflow is flagged."""
    cap = min(num_faces * expand_cap, max(8 * num_faces, 32768))
    return -(-cap // POOL_ALIGN) * POOL_ALIGN


def _bbox_cols(bbox):
    """(xmin, xmax, ymin, ymax) int64 from a 4-tuple or an [F, 4] tensor."""
    if isinstance(bbox, (tuple, list)):
        return tuple(torch.as_tensor(c).to(_I64) for c in bbox)
    bbox = torch.as_tensor(bbox).to(_I64)
    return bbox[:, 0], bbox[:, 1], bbox[:, 2], bbox[:, 3]


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _exclusive_cumsum(x, dim=0):
    return torch.cumsum(x, dim=dim) - x


def _cummax(x):
    return scan.max_scan(x)


def _drop_index(idx, n):
    """Send out-of-range indices to a dump slot ``n`` (JAX's mode="drop")."""
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _set_drop(out, idx, val):
    """``out.at[idx].set(val, mode="drop")`` for a 1-D ``out``.

    Kept indices must be unique; dropped ones all land on a dump slot that
    is cut off again, so no host sync is needed to filter them.
    """
    n = out.shape[0]
    buf = torch.cat([out, out.new_zeros(1)])
    buf[_drop_index(idx, n)] = val
    return buf[:n]


def _add_drop(n, idx, device):
    """``zeros(n).at[idx].add(1, mode="drop")`` (int64)."""
    buf = torch.zeros((n + 1,), dtype=_I64, device=device)
    buf.index_add_(0, _drop_index(idx, n), torch.ones_like(idx))
    return buf[:n]


def bin_faces_packed(
    bbox, height: int, width: int, tile_h: int, tile_w: int,
    budget_iters: int, expand_cap: int,
    edges=None, pool_cap: int | None = None,
    work_cap: int | None = None, _stage: int = 0,
) -> PackedBins:
    """Lane-packed subtile binning (see :class:`PackedBins`).

    The stages of ``dirt_tpu.ops.binning.bin_faces_packed``, in order:

    1. enumerate (subtile sid, face) candidates into a flat pool of
       POOL_ALIGN-aligned per-face runs, capped at ``expand_cap`` jobs per
       face and ``pool_cap`` slots (both overflow-flagged); with ``edges``
       given, candidates failing the conservative triangle-vs-subtile test
       are dropped;
    2. one merged sort of pairs plus one header record per sid (headers
       sort to the front of each sid's run);
    3. per-subtile counts read off at run ends;
    4. grid prefix math (max over groups -> iterations per strip ->
       per-tile chunk spans, water-filled so every tile keeps >= 1 chunk);
    5. per-pair placement (block-row = strip start + in-run rank);
    6. entries built by one pair scatter onto strip-aware defaults.

    ``work_cap``: the stages after the sort run on the first ``work_cap``
    sorted elements only (dead candidates sort last); an undersized cap
    truncates whole tail pairs and raises ``overflow``.

    ``_stage`` > 0 returns early, after stage N, with an int64 checksum
    scalar (the profiling hook of ``tools/prof_torch_binning.py``): the
    stage numbers and checksum expressions of ``dirt_tpu``'s hook (11, 12,
    13 the parts of stage 1, then 1 to 7), whose int32 sums wrap where
    these do not.
    """
    bxmin, bxmax, bymin, bymax = _bbox_cols(bbox)
    device = bxmin.device
    nf = bxmin.shape[0]
    tiles_y, tiles_x, strips, groups = packed_grid(
        height, width, tile_h, tile_w
    )
    total = tiles_y * tiles_x
    nsid = total * strips * groups
    gy_max_all = tiles_y * strips - 1
    gx_max_all = tiles_x * groups - 1
    budget_rows = budget_iters * GROUPS
    budget_chunks = budget_rows // PACK_CHUNK
    if budget_chunks < total:
        raise ValueError("packed budget must give every tile an init chunk")

    def arange(n):
        return torch.arange(n, dtype=_I64, device=device)

    # --- 1. candidate pool (flat, POOL_ALIGN-aligned per-face runs) ----
    valid = (bxmax >= bxmin) & (bymax >= bymin)
    gxmin = torch.clamp(_fdiv(bxmin, SUB_W), 0, gx_max_all)
    gxmax = torch.clamp(_fdiv(bxmax, SUB_W), 0, gx_max_all)
    gymin = torch.clamp(_fdiv(bymin, SUB_H), 0, gy_max_all)
    gymax = torch.clamp(_fdiv(bymax, SUB_H), 0, gy_max_all)
    span_x = torch.where(valid, gxmax - gxmin + 1, 0)
    span_y = torch.where(valid, gymax - gymin + 1, 0)
    n_jobs = span_x * span_y                          # 0 where not valid
    # A face over expand_cap overflows; the most any face asks for is also
    # the expand cap's fill.
    max_jobs = (torch.amax(n_jobs) if nf else
                torch.zeros((), dtype=_I64, device=device))
    njobs_c = torch.clamp(n_jobs, max=expand_cap)

    if pool_cap is None:
        pool_cap = auto_pool_cap(nf, expand_cap)
    al = POOL_ALIGN
    pool_cap = max(-(-pool_cap // al) * al, al)
    pool_blocks = pool_cap // al

    blocks = -_fdiv(-njobs_c, al)                     # [F], slot blocks
    boff = _exclusive_cumsum(blocks)                  # exclusive, blocks
    used_blocks = torch.sum(blocks)
    pool_overflow = used_blocks > pool_blocks

    start_ok = (blocks > 0) & (boff < pool_blocks)
    fidx = arange(nf)
    slot0 = torch.where(start_ok, boff * al, pool_cap)
    neg_pool = torch.full((pool_cap,), -1, dtype=_I64, device=device)
    face_of = _cummax(_set_drop(neg_pool, slot0, fidx))
    s0_of = _cummax(_set_drop(neg_pool, slot0, slot0))
    if _stage == 11:
        return torch.sum(face_of) + torch.sum(s0_of)

    fc = torch.clamp(face_of, 0, max(nf - 1, 0))
    f_gxmin, f_gymin = gxmin[fc], gymin[fc]
    f_sx = torch.clamp(span_x, min=1)[fc]
    f_njobs = njobs_c[fc]

    p_iota = arange(pool_cap)
    e = p_iota - s0_of                                # candidate rank
    # Exact integer floor division (the JAX code reaches the same value
    # through an f32 quotient plus a one-step fixup).
    ey = _fdiv(e, f_sx)
    ex = e - ey * f_sx
    gy = f_gymin + ey
    gx = f_gxmin + ex
    pair_ok = (face_of >= 0) & (e < f_njobs)
    if _stage == 12:
        return torch.sum(gy) + torch.sum(gx) + torch.sum(pair_ok)
    if edges is not None:
        # Conservative triangle-vs-subtile test: drop candidates whose
        # 8x16 pixel-center rect lies more than half a pixel outside any
        # edge half-plane (same anchored planes the kernel tests).
        ecols = [torch.as_tensor(c, dtype=torch.float32)[fc] for c in edges]
        x0, y0, a0, b0, a1, b1, a2, b2, c0 = ecols
        rx0 = gx.to(torch.float32) * SUB_W + 0.5 - x0
        ry0 = gy.to(torch.float32) * SUB_H + 0.5 - y0
        a3 = torch.stack([a0, a1, a2])                          # [3, pool]
        b3 = torch.stack([b0, b1, b2])
        c3 = torch.cat([c0[None], torch.zeros_like(a3[:2])])
        emax = (a3 * rx0[None] + b3 * ry0[None] + c3
                + torch.clamp(a3, min=0.0) * (SUB_W - 1)
                + torch.clamp(b3, min=0.0) * (SUB_H - 1))
        slack = 0.5 * torch.sqrt(a3 * a3 + b3 * b3)
        pair_ok = pair_ok & torch.all(emax >= -slack, dim=0)
    if _stage == 13:
        return torch.sum(gy) + torch.sum(gx) + torch.sum(pair_ok)
    t_id = _fdiv(gy, strips) * tiles_x + _fdiv(gx, groups)
    sid_p = torch.where(
        pair_ok,
        (t_id * strips + torch.remainder(gy, strips)) * groups
        + torch.remainder(gx, groups),
        nsid,
    )
    face_p = torch.clamp(face_of, min=0)
    if _stage == 1:
        return torch.sum(sid_p) + torch.sum(face_p)

    # --- 2. merged sort: pairs + headers -------------------------------
    hdr_sid = arange(nsid)
    sid_all = torch.cat([sid_p, hdr_sid])
    face_all = torch.cat([face_p, torch.full_like(hdr_sid, -1)])
    want_pair_rows = pool_cap <= 4 * budget_rows
    # One int64 key for the (sid, face) order; face + 1 >= 0.
    key = sid_all * (nf + 1) + (face_all + 1)
    order = torch.sort(key, stable=True).indices
    sid_s = sid_all[order]
    face_s = face_all[order]
    n_sorted = sid_s.shape[0]

    # Live-prefix slice: every stage below runs on the first c_live sorted
    # elements; sentinel-sid candidates sort to the end.
    if work_cap is not None:
        c_live = min(max(-(-work_cap // 8) * 8, nsid + POOL_ALIGN), n_sorted)
    else:
        c_live = n_sorted
    if c_live < n_sorted:
        work_overflow = sid_s[c_live] < nsid
        sid_s = sid_s[:c_live]
        face_s = face_s[:c_live]
    else:
        work_overflow = torch.zeros((), dtype=torch.bool, device=device)
    n_merged = c_live

    iota = arange(n_merged)
    differs = sid_s[1:] != sid_s[:-1]
    true1 = torch.ones((1,), dtype=torch.bool, device=device)
    is_start = torch.cat([true1, differs])
    run_start = _cummax(torch.where(is_start, iota, 0))
    rank = iota - run_start            # header rank 0, real pairs 1..len
    is_end = torch.cat([differs, true1])
    if _stage == 2:
        return torch.sum(rank) + torch.sum(face_s) + torch.sum(is_end)

    # --- 3. per-subtile counts (run length at each run's end) ----------
    end_key = torch.where(is_end & (sid_s < nsid), sid_s, nsid)
    counts = _set_drop(
        torch.zeros((nsid,), dtype=_I64, device=device), end_key, rank
    ).reshape(total, strips, groups)
    if _stage == 3:
        return torch.sum(counts) + torch.sum(rank)

    # --- 4. grid prefix math --------------------------------------------
    n_iter = torch.amax(counts, dim=2)                       # [T, S]
    iter_off = _exclusive_cumsum(n_iter, dim=1)
    tile_iters = torch.sum(n_iter, dim=1)                    # [T]
    # Every tile owns >= 1 chunk (its init step), even when empty.
    raw_chunks = torch.clamp(-_fdiv(-tile_iters, PACK_ITERS), min=1)
    chunk_ends = torch.cumsum(raw_chunks, dim=0)
    cum_excl = chunk_ends - raw_chunks
    t_idx = arange(total)
    # Water-fill: reserve one chunk per remaining tile so every tile owns
    # at least one chunk even under budget overflow.
    base = torch.minimum(cum_excl, budget_chunks - (total - t_idx))
    end = torch.minimum(base + raw_chunks,
                        budget_chunks - (total - 1 - t_idx))
    end = torch.maximum(end, base + 1)
    chunks_eff = end - base
    n_iters_eff = torch.minimum(tile_iters, PACK_ITERS * chunks_eff)
    start_block = base

    base_rows = base * PACK_CHUNK
    limit_rows = end * PACK_CHUNK
    rowstart = (
        base_rows[:, None, None]
        + GROUPS * iter_off[:, :, None]
        + arange(groups)[None, None, :]
    )                                                        # [T, S, G]
    if _stage == 4:
        return (torch.sum(rowstart) + torch.sum(limit_rows)
                + torch.sum(n_iters_eff) + torch.sum(rank))

    # --- 5. pair placement via per-run cummax ---------------------------
    # Sorted pair p of subtile sid with in-run rank k = rank - 1 lands at
    # block-row x8[sid] + k, lane sid % groups. Both per-run fields are
    # non-decreasing in sid, so a scatter at each run's header slot plus a
    # cummax spreads them over the run.
    r8 = budget_rows // GROUPS
    run_len = counts.reshape(-1) + 1                         # + header
    run_ends = torch.cumsum(run_len, dim=0)
    a_start = run_ends - run_len                             # [nsid]
    limit8_sid = (limit_rows // GROUPS)[:, None, None].expand(
        total, strips, groups).reshape(-1)
    x8_sid = (rowstart[:, :, 0] // GROUPS)[:, :, None].expand(
        total, strips, groups).reshape(-1)
    # Dropped: under work_cap overflow a late sid's header can sit past
    # the live prefix.
    neg_m = torch.full((n_merged,), -1, dtype=_I64, device=device)
    x8_run = _cummax(_set_drop(neg_m, a_start, x8_sid))
    lim8_run = _cummax(_set_drop(neg_m, a_start, limit8_sid))
    j_p = x8_run + rank - 1
    sid_c = torch.clamp(sid_s, max=nsid - 1)
    # Overflow spill guard: rows at/past the tile's chunk allocation are
    # dropped (their jobs are already flagged by the n_iters truncation).
    valid_p = (
        (rank >= 1) & (face_s >= 0) & (sid_s < nsid)
        & (x8_run >= 0) & (j_p < lim8_run)
    )
    row_val = torch.where(
        valid_p, j_p * GROUPS + torch.remainder(sid_c, groups), budget_rows
    )
    if _stage == 5:
        return torch.sum(row_val) + torch.sum(rank)

    # --- 6. entries: strip-aware defaults + one pair scatter ------------
    # Empty rows carry their strip's index so the strip-run arithmetic
    # stays consistent.
    strip_start8 = (rowstart[:, :, 0] // GROUPS).reshape(-1)  # [T*S]
    strip_ok = (n_iter.reshape(-1) > 0) & (
        strip_start8 < (limit_rows // GROUPS)[:, None].expand(
            total, strips).reshape(-1)
    )
    smarks = _add_drop(r8, torch.where(strip_ok, strip_start8, r8), device)
    s_row8 = torch.remainder(torch.cumsum(smarks, dim=0) - 1, strips)

    value = face_s * 8 + torch.remainder(_fdiv(sid_c, groups), strips)
    defaults = (nf * 8 + s_row8)[:, None].expand(r8, GROUPS).reshape(-1)
    entries = _set_drop(defaults, row_val, value)
    if _stage == 6:
        return torch.sum(entries) + torch.sum(rank)

    # --- packed-backward pair backpointers (inverse of the placement) ---
    if want_pair_rows:
        # The merged order's payload: the pool slot of each pair, headers
        # at slots >= pool_cap. Sliced-away candidates hold no budget row.
        row_full = torch.full((n_sorted,), budget_rows, dtype=_I64,
                              device=device)
        row_full[:c_live] = row_val
        q_s = torch.cat([p_iota, pool_cap + hdr_sid])[order]
        inverse = torch.empty_like(row_full)
        inverse[q_s] = row_full
        pair_rows = inverse[:pool_cap].to(_I32)
        pool_offs = torch.cat([boff, used_blocks[None]])
        pool_offs = pool_offs.to(_I32)
    else:
        pair_rows = None
        pool_offs = None
    if _stage == 7:
        chk = torch.sum(entries)
        if pair_rows is not None:
            chk = chk + torch.sum(pair_rows) + torch.sum(pool_offs)
        return chk

    # --- chunk -> tile map via interval marks ---------------------------
    cmarks = _add_drop(
        budget_chunks, torch.clamp(start_block, 0, budget_chunks - 1), device
    )
    chunk_tile = torch.clamp(torch.cumsum(cmarks, dim=0) - 1, 0, total - 1)

    overflow = (
        (max_jobs > expand_cap)
        | torch.any(n_iters_eff < tile_iters)
        | pool_overflow
        | work_overflow
    )
    # What each cap holds of what this call asked of it, for the binning's
    # closing marker (``utils/trace.py``): slot blocks, live sorted
    # elements (run lengths plus headers; with a work cap), a face's jobs,
    # chunks.
    trace.fills(
        pool=(used_blocks, pool_blocks),
        work=None if work_cap is None else (run_ends[-1], c_live),
        expand=(max_jobs, expand_cap),
        budget=(chunk_ends[-1], budget_chunks),
    )
    return PackedBins(
        entries=entries.to(_I32),
        chunk_tile=chunk_tile.to(_I32),
        start_block=start_block.to(_I32),
        n_iters=n_iters_eff.to(_I32),
        overflow=overflow,
        iter_off=iter_off.reshape(-1).to(_I32),
        strip_iters=n_iter.reshape(-1).to(_I32),
        pair_rows=pair_rows,
        pool_offs=pool_offs,
    )


# --- dense whole-tile bins -------------------------------------------------


class BinningResult(NamedTuple):
    """Per-tile face lists of the dense engine (``bin_faces``)."""

    bins: torch.Tensor      # [num_tiles, cap] int32, face index or F (sentinel)
    counts: torch.Tensor    # [num_tiles] int32, clamped to cap
    overflow: torch.Tensor  # [num_tiles] bool, True where count exceeded cap


def bin_faces(bbox, height: int, width: int, tile_h: int, tile_w: int,
              cap: int) -> BinningResult:
    """Bin faces by conservative bbox/tile overlap (dense engine).

    A [num_tiles, F] overlap matrix, each row left-compacted into the first
    ``cap`` overlapping face ids in ascending order (the order the raster
    kernel's depth-tie rule needs); slots past a tile's count hold the
    sentinel ``F``. Supports faces of any screen size.

    Args:
        bbox: [F, 4] int32 (xmin, xmax, ymin, ymax) inclusive pixel indices,
            or the four columns as a tuple; empty boxes have max < min.
    """
    if isinstance(bbox, (tuple, list)):
        bxmin, bxmax, bymin, bymax = (torch.as_tensor(c).to(_I64)
                                      for c in bbox)
    else:
        bxmin, bxmax, bymin, bymax = torch.as_tensor(bbox).to(_I64).unbind(1)
    device = bxmin.device
    nf = bxmin.shape[0]
    tiles_y, tiles_x = num_tiles(height, width, tile_h, tile_w)
    total = tiles_y * tiles_x

    def fdiv(a, b):
        return torch.div(a, b, rounding_mode="floor")

    txmin, txmax = fdiv(bxmin, tile_w), fdiv(bxmax, tile_w)
    tymin, tymax = fdiv(bymin, tile_h), fdiv(bymax, tile_h)
    tile_ids = torch.arange(total, dtype=_I64, device=device)
    tx = (tile_ids % tiles_x)[:, None]
    ty = (tile_ids // tiles_x)[:, None]
    overlap = ((txmin[None, :] <= tx) & (tx <= txmax[None, :])
               & (tymin[None, :] <= ty) & (ty <= tymax[None, :]))  # [T, F]

    raw_counts = overlap.sum(dim=1)
    overflow = raw_counts > cap
    counts = torch.clamp(raw_counts, max=cap).to(_I32)
    # The fullest tile's count over the cap, for the binning's closing
    # marker (``utils/trace.py``).
    trace.fills(bin=(raw_counts.max(), cap))

    # A key positive exactly on overlaps and decreasing in face index: its
    # ``cap`` largest entries per row, in descending key order, are the first
    # ``cap`` overlapping ids in ascending order.
    face_ids = torch.arange(nf, dtype=_I64, device=device)[None, :]
    key = torch.where(overlap, nf - face_ids, 0)
    val, idx = torch.topk(key, cap, dim=1, sorted=True)
    bins = torch.where(val > 0, idx, nf).to(_I32)
    return BinningResult(bins=bins, counts=counts, overflow=overflow)


# --- CSR bins of the streaming engine --------------------------------------


class CSRBins(NamedTuple):
    """Chunk-padded CSR tile bins of the streaming engine.

    ``entry_face[start_block[t] * CHUNK + i]`` for ``i < counts[t]`` are the
    face ids overlapping tile ``t`` in ascending order; slots between
    ``counts[t]`` and the next tile's start hold the sentinel id F. Every
    tile's run begins at a CHUNK-aligned row.
    """

    entry_face: torch.Tensor   # [n_pad] int32, sentinel = F
    start_block: torch.Tensor  # [num_tiles] int32, in units of CHUNK rows
    counts: torch.Tensor       # [num_tiles] int32, clamped to cap
    overflow: torch.Tensor     # [] bool: any tile over cap, or any face over
                               # expand_cap (its tail tiles were dropped)


def csr_pad_bound(num_faces: int, expand_cap: int, num_tiles: int) -> int:
    """Static upper bound on the padded CSR length."""
    pairs = num_faces * expand_cap
    return -(-pairs // CHUNK) * CHUNK + num_tiles * CHUNK


def auto_expand_cap(num_faces: int, num_tiles: int) -> int:
    """Default per-face tile-overlap cap of the streaming engine.

    Expansion work is O(F * E), so large meshes (whose triangles are small
    beside the tile grid) get a tight cap and low-poly scenes one that lets
    a single face span the whole grid. A face spanning more tiles than the
    cap is truncated and flagged through ``overflow``.
    """
    if num_faces > 65536:
        return 8
    target = max(16, (16 * num_tiles) // max(num_faces, 1))
    cap = 16
    while cap < target and cap < num_tiles:
        cap *= 2
    return min(max(cap, 16), max(num_tiles, 16))


def bin_faces_csr(bbox, height: int, width: int, tile_h: int, tile_w: int,
                  cap: int, expand_cap: int) -> CSRBins:
    """Pair-expansion binning into chunk-padded CSR runs (:class:`CSRBins`).

    Every face expands into at most ``expand_cap`` (tile, face) pairs, one
    sort orders them by tile and then face, and each tile's run (cut at
    ``cap``, rounded up to a CHUNK multiple) is written at its CHUNK-aligned
    start. Work is O(F * expand_cap), with no [T, F] matrix.

    The pair's destination is ``start_block[tile] * CHUNK`` plus its rank in
    the tile's sorted run, read off by direct gathers (``dirt_tpu`` reaches
    the same value through running maxima and sums, which suit a TPU).

    Args:
        bbox: [F, 4] int32 (xmin, xmax, ymin, ymax) inclusive pixel indices,
            or the four columns as a tuple; empty boxes have max < min.
        cap: per-tile face cap (overflow-flagged), rounded up to CHUNK.
        expand_cap: most tiles one face may overlap (overflow-flagged).
    """
    bxmin, bxmax, bymin, bymax = _bbox_cols(bbox)
    device = bxmin.device
    nf = bxmin.shape[0]
    tiles_y, tiles_x = num_tiles(height, width, tile_h, tile_w)
    total = tiles_y * tiles_x
    cap = -(-cap // CHUNK) * CHUNK
    n_pad = csr_pad_bound(nf, expand_cap, total)

    txmin, txmax = _fdiv(bxmin, tile_w), _fdiv(bxmax, tile_w)
    tymin, tymax = _fdiv(bymin, tile_h), _fdiv(bymax, tile_h)
    valid = (bxmax >= bxmin) & (bymax >= bymin)
    span_x = torch.where(valid, txmax - txmin + 1, 0)
    span_y = torch.where(valid, tymax - tymin + 1, 0)
    n_e = span_x * span_y

    # Pair e of face f covers tile (tymin + e // span_x, txmin + e % span_x);
    # pairs past n_e (or expand_cap) get the sentinel tile id `total` and
    # sort to the end.
    e = torch.arange(expand_cap, dtype=_I64, device=device)[None, :]
    sx = torch.clamp(span_x, min=1)[:, None]
    ey = _fdiv(e, sx)
    ex = e - ey * sx
    tile = (tymin[:, None] + ey) * tiles_x + (txmin[:, None] + ex)
    pair_valid = e < torch.clamp(n_e, max=expand_cap)[:, None]
    tile = torch.where(pair_valid, tile, total)                  # [F, E]
    face = torch.arange(nf, dtype=_I64, device=device)[:, None]
    # One int64 key for the (tile, face) order; live pairs have unique keys.
    key_s = torch.sort((tile * (nf + 1) + face).reshape(-1)).values
    tile_s = _fdiv(key_s, nf + 1)
    face_s = key_s - tile_s * (nf + 1)

    tile_ids = torch.arange(total, dtype=_I64, device=device)
    starts_raw = torch.searchsorted(tile_s, tile_ids)
    counts_raw = torch.searchsorted(tile_s, tile_ids, right=True) - starts_raw
    # The fullest tile's run and the widest face's pairs: an empty face has
    # no pairs, so the widest is over the valid ones alone.
    max_count = counts_raw.max()
    max_pairs = n_e.max() if nf else torch.zeros((), dtype=_I64,
                                                 device=device)
    overflow = (max_count > cap) | (max_pairs > expand_cap)
    # What each cap holds of what this call asked of it, for the binning's
    # closing marker (``utils/trace.py``).
    trace.fills(tile=(max_count, cap), expand=(max_pairs, expand_cap))
    counts = torch.clamp(counts_raw, max=cap)
    padded = -_fdiv(-counts, CHUNK) * CHUNK
    start_block = _fdiv(_exclusive_cumsum(padded), CHUNK)

    tile_c = torch.clamp(tile_s, max=max(total - 1, 0))
    rank = torch.arange(key_s.shape[0], dtype=_I64, device=device) \
        - starts_raw[tile_c]
    keep = (tile_s < total) & (rank < cap)
    # Dropped pairs all write the sentinel to the dump slot n_pad - 1. No
    # kept pair lands there: the padded runs sum to at most
    # ceil(F * E / CHUNK) * CHUNK + T * (CHUNK - 1) = n_pad - T < n_pad.
    dest = torch.where(keep, start_block[tile_c] * CHUNK + rank, n_pad - 1)
    entry_face = torch.full((n_pad,), nf, dtype=_I64, device=device)
    entry_face[dest] = torch.where(keep, face_s, nf)
    return CSRBins(
        entry_face=entry_face.to(_I32),
        start_block=start_block.to(_I32),
        counts=counts.to(_I32),
        overflow=overflow,
    )
