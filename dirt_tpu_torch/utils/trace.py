"""The port's tracing: stage spans on the device clock, and one counter
registry.

**Spans.** A CUDA-graph replay (``utils/graphstep.GraphedStep``) runs no
Python, so it carries no host spans: the profiler shows one
``cudaGraphLaunch`` and the device operations it started. :func:`span`
bounds a stage on the device instead. Where the stage opens and where it
closes it launches a marker, a one-thread kernel that does nothing
(``csrc/trace_marks.cu``), on the current stream of the tensor it is given;
a capture records the markers into the graph, so every replay carries them
at no host cost. A marker's symbol is ``span_mark<C, O>``: it closes span
``C`` and opens span ``O``, numbered from 1 in :data:`SPANS` (0: none).
Stages that abut share one marker (:func:`switch`). On CPU tensors a span
does nothing.

The raster op's stages, in a replay's order:

- ``clip``: the per-face gather and the near-plane clip
  (``rasterise_ops._clip_space_faces``; none with ``clip=False``);
- ``setup``: triangle setup, boxes and edge columns
  (``triangle_setup.setup_faces``, one kernel on the card), up to the
  binning call (``ops/raster.py``, ``prepare_packed`` / ``prepare_dense``
  / ``prepare_csr``);
- ``binning``: ``bin_faces_packed``, ``bin_faces`` or ``bin_faces_csr``;
- ``raster_fwd``: the face table and the forward kernel (K1, K5 or K7);
- ``raster_bwd``: the whole of ``_RasterizeScreen.backward`` (the plane
  cotangents and ``chain_through_setup``).

And the per-vertex shading before it:

- ``shade``: each call of ``core/lighting.py``'s ``vertex_normals``,
  ``diffuse_directional`` and ``specular_directional`` made where no
  span is open (:func:`outer_span`).

And the texture lookup after it:

- ``texture``: each call of ``core/texture.py``'s ``sample_texture`` made
  where no span is open;
- ``texture_grad``: the texture gradient's scatter in its backward (only
  where the texture needs a gradient).

A step of the raster op launches six markers a forward with ``clip=True``
(four without) and two a backward; each shading call adds two (a lit
render's normals, diffuse and specular terms six, ``entry.deferred_render``'s
normals two), each texture lookup two, and each texture gradient two.
These are the pairs of :data:`MARKS`, the only markers the kernel file
instantiates. :func:`span_ms` reads a stage's device time per
replay from a profiler's device operations, summed over each time the
stage ran in the replay.

**Counters.** :func:`counters` is a snapshot of the registry:

- ``launch.<kernel>``: host launches of each CUDA kernel of ``csrc/``. A
  wrapper counts where it launches, so a capture counts its launches (and
  ``GraphedStep``'s warm-up calls theirs) and a replay counts nothing.
- ``graphstep.captures``, ``graphstep.capture_s`` (warm-up calls plus the
  capture, summed over signatures) and ``graphstep.replays``: a loop whose
  static arguments change every call captures every call.
- ``fill.pool``, ``fill.work``, ``fill.expand``, ``fill.budget``,
  ``fill.tile``, ``fill.bin``: device counters, the largest share of a
  binning cap that any call used since the last :func:`reset` (1 is full;
  above 1 the call overflowed): ``bin_faces_packed``'s pool cap, work cap,
  expand cap (the most jobs of one face) and iteration budget,
  ``bin_faces_csr``'s per-tile cap (the fullest tile's run) and expand cap
  (the most tiles of one face), and ``bin_faces``' per-tile cap (the
  fullest tile's raw count, whose maximum is one reduction of its own).
  The binning's closing marker folds them in, so the fold costs no graph
  node and the fills outlive the graphs that wrote them. Present once a
  call wrote them.

:func:`host_spans` holds ``GraphedStep``'s host stamps of the last
:data:`RING` calls on the profiler's clock (Unix-time ns): entry to the
call, the launch (after the copies into the static inputs) and the return
of ``replay()``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import re
import threading
from typing import NamedTuple

import torch

# The spans' numbers in a marker's symbol: SPANS[k - 1] is span k.
SPANS = ("clip", "setup", "binning", "raster_fwd", "raster_bwd", "shade",
         "texture", "texture_grad")
# (closed, opened) span numbers of each marker launched: the raster op's in
# a step's order, then a shading call's, a texture lookup's and a texture
# gradient's; ``csrc/trace_marks.cu``'s kMarks instantiates these alone.
MARKS = ((0, 1), (1, 0), (0, 2), (2, 3), (3, 4), (4, 0), (0, 5), (5, 0),
         (0, 6), (6, 0), (0, 7), (7, 0), (0, 8), (8, 0))
# The cap fills the binning's closing marker keeps, in the kernel's order.
FILLS = ("pool", "work", "expand", "budget", "tile", "bin")
# GraphedStep calls whose host stamps are kept.
RING = 8192

_MARKER = re.compile(r"span_mark<\s*(\d+)\s*,\s*(\d+)\s*>")
_KERNEL = "trace_marks"


class HostSpan(NamedTuple):
    """Host stamps of one ``GraphedStep`` call, Unix-time ns."""

    entry: int    # the call's entry
    launch: int   # after the copies into the static inputs
    done: int     # the return of ``replay()``


class Registry:
    """Named host counters, the ring of host spans and the devices whose
    fill counters were written. Thread-safe: the backward's kernels count
    from autograd's device threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values = {}
        self._spans = collections.deque(maxlen=RING)
        self._devices = set()

    def count(self, name: str, n=1):
        with self._lock:
            self._values[name] = self._values.get(name, 0) + n

    def maximum(self, name: str, value):
        with self._lock:
            self._values[name] = max(self._values.get(name, value), value)

    def replayed(self, entry: int, launch: int, done: int):
        self._spans.append(HostSpan(entry, launch, done))

    def host_spans(self):
        return list(self._spans)

    def marked(self, device_index: int):
        self._devices.add(device_index)

    def snapshot(self) -> dict:
        # The card's fills are maxima since the last reset: fold them in.
        for name, value in _device_fills(self._devices):
            self.maximum(name, value)
        with self._lock:
            return dict(self._values)

    def reset(self):
        with self._lock:
            self._values.clear()
            self._spans.clear()
        _clear_fills(self._devices)


REGISTRY = Registry()
count = REGISTRY.count
replayed = REGISTRY.replayed
host_spans = REGISTRY.host_spans


def counters() -> dict:
    """A snapshot of the registry: host counters and, outside a capture,
    the device fills (read from every device a marker ran on; this waits
    for the device)."""
    return REGISTRY.snapshot()


def reset():
    """Zero every counter, device fills included, and empty the ring."""
    REGISTRY.reset()


# --- markers ----------------------------------------------------------------


class _Open(threading.local):
    """The spans open on this thread, innermost last, and the fills waiting
    for the next marker."""

    def __init__(self):
        self.stack = []
        self.fills = None


_OPEN = _Open()


def _on_card(tensor) -> bool:
    return tensor.is_cuda


@functools.cache
def _lib():
    from dirt_tpu_torch.ops import _build

    lib = _build.load(_KERNEL)
    lib.dirt_span_mark.restype = ctypes.c_int
    lib.dirt_span_mark.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p]
    for fn in (lib.dirt_trace_fills, lib.dirt_trace_clear):
        fn.restype = ctypes.c_int
    lib.dirt_trace_fills.argtypes = [ctypes.c_void_p]
    lib.dirt_trace_clear.argtypes = []
    return lib


def mark_ids(close: str | None, open_: str | None):
    """The pair of :data:`MARKS` of the marker that closes span ``close``
    and opens ``open_`` (None: none); ValueError for a marker the kernel
    file does not instantiate."""
    ids = (0 if close is None else SPANS.index(close) + 1,
           0 if open_ is None else SPANS.index(open_) + 1)
    if ids not in MARKS:
        raise ValueError(f"no marker closes {close} and opens {open_}")
    return ids


def _mark(close: str | None, open_: str | None, like):
    """Launch the marker that closes ``close`` and opens ``open_`` (a pair
    of :data:`MARKS`) on the current stream of ``like``'s device, with the
    waiting fills."""
    ids = mark_ids(close, open_)
    fills, _OPEN.fills = _OPEN.fills, None
    used = caps = None
    if fills is not None:
        used = (ctypes.c_void_p * len(FILLS))(*(
            None if fill is None else fill[0].data_ptr() for fill in fills))
        caps = (ctypes.c_longlong * len(FILLS))(*(
            0 if fill is None else fill[1] for fill in fills))
    current = torch.cuda.current_device()
    index = current if like.device.index is None else like.device.index
    with (contextlib.nullcontext() if index == current
          else torch.cuda.device(index)):
        stream = torch.cuda.current_stream(index).cuda_stream
        err = _lib().dirt_span_mark(*ids, used, caps, stream)
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err}")
    REGISTRY.marked(index)
    count(f"launch.{_KERNEL}")


@contextlib.contextmanager
def span(name: str, like):
    """Span ``name`` (one of :data:`SPANS`) around the block, on the stream
    of ``like``, a tensor; nothing for a CPU tensor. :func:`switch` inside
    the block moves the span on to the next stage; the block's end closes
    whichever stage is open then. A block that raises launches no closing
    marker (a capture it broke takes no more launches)."""
    if not _on_card(like):
        yield
        return
    _mark(None, name, like)
    _OPEN.stack.append(name)
    try:
        yield
    except BaseException:
        _OPEN.stack.pop()
        raise
    _mark(_OPEN.stack.pop(), None, like)


def outer_span(name: str, like):
    """:func:`span` ``name`` around the block where no span is open on this
    thread, else nothing: a stage called inside another's span leaves that
    span's markers as they pair."""
    if _OPEN.stack:
        return contextlib.nullcontext()
    return span(name, like)


def switch(close: str, open_: str, like):
    """Close span ``close`` and open ``open_`` with one marker, where
    ``close`` is the innermost open span on this thread; else nothing (a
    stage called outside the raster op's spans)."""
    if _OPEN.stack and _OPEN.stack[-1] == close and _on_card(like):
        _mark(close, open_, like)
        _OPEN.stack[-1] = open_


def fills(**used):
    """Hand cap fills to the next marker of this thread: ``name=(count,
    cap)`` for names of :data:`FILLS`, ``count`` an int64 scalar on the
    card, ``cap`` a positive int, or None for a fill not kept. Kept only
    inside an open span on the card (the binning's closing marker takes
    them)."""
    kept = {name: value for name, value in used.items() if value is not None}
    if not _OPEN.stack or not all(_on_card(v[0]) for v in kept.values()):
        return
    _OPEN.fills = tuple(kept.get(name) for name in FILLS)


def _device_fills(devices):
    """(name, share) of each fill the card wrote, on every device a marker
    ran on; nothing during a capture."""
    if not devices or torch.cuda.is_current_stream_capturing():
        return []
    out = []
    for index in sorted(devices):
        buf = (ctypes.c_float * len(FILLS))()
        # The copy waits for the legacy stream alone, and a marker may run
        # on any stream (a replay on a side stream): wait for the device.
        torch.cuda.synchronize(index)
        with torch.cuda.device(index):
            err = _lib().dirt_trace_fills(buf)
        if err != 0:
            raise RuntimeError(f"reading the fills failed: CUDA error {err}")
        out += [(f"fill.{name}", value) for name, value in zip(FILLS, buf)
                if value > 0]
    return out


def _clear_fills(devices):
    for index in sorted(devices):
        # No marker still in flight may fold a share in after the zeroing.
        torch.cuda.synchronize(index)
        with torch.cuda.device(index):
            err = _lib().dirt_trace_clear()
        if err != 0:
            raise RuntimeError(f"clearing the fills failed: CUDA error {err}")


# --- reading a profile -------------------------------------------------------


def marker(op_name: str):
    """(closed span or None, opened span or None) of a marker kernel's
    symbol; None for any other operation."""
    found = _MARKER.search(op_name)
    if found is None:
        return None
    close, open_ = (int(k) for k in found.groups())
    if close > len(SPANS) or open_ > len(SPANS):
        return None
    return (SPANS[close - 1] if close else None,
            SPANS[open_ - 1] if open_ else None)


def span_seconds(ops, name: str):
    """Seconds of span ``name`` among one replay's device operations
    ``(op name, start_ns, end_ns, ...)`` in start order: each opening
    marker paired with the next closing marker, from the end of the one to
    the start of the other, busy and idle together, summed over the pairs
    (a step that runs the raster op twice opens each span twice). None
    without a pair, or unless the markers pair up: a closing marker with no
    span open, an opening one inside an open span or at the end."""
    total, opened, pairs = 0, None, 0
    for op in ops:
        found = marker(op[0])
        if found is None:
            continue
        if found[0] == name:
            if opened is None or op[1] < opened:
                return None
            total, opened, pairs = total + op[1] - opened, None, pairs + 1
        if found[1] == name:
            if opened is not None:
                return None
            opened = op[2]
    if opened is not None or not pairs:
        return None
    return total * 1e-9


def span_ms(ops, launches, name: str):
    """Mean device ms of span ``name`` per graph replay. ``ops``: device
    operations ``(op name, start_ns, end_ns, correlation)``, as a profiler
    records them; ``launches``: {correlation: host call}, where every
    operation of a replay carries its ``cudaGraphLaunch``'s correlation.
    None without a replay, or unless every replay's markers of the span
    pair up (:func:`span_seconds`)."""
    replays = collections.defaultdict(list)
    for op in ops:
        if launches.get(op[3]) == "cudaGraphLaunch":
            replays[op[3]].append(op)
    seconds = [span_seconds(sorted(group, key=lambda op: op[1]), name)
               for group in replays.values()]
    if not seconds or any(s is None for s in seconds):
        return None
    return 1e3 * sum(seconds) / len(seconds)
