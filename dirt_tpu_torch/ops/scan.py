"""Inclusive max-scan of a 1-D int64 array: the packed binning's running
maxima.

``bin_faces_packed`` (``ops/binning.py``) spreads values over runs five
times with a running maximum (``face_of``, ``s0_of``, ``run_start``,
``x8_run``, ``lim8_run``), where ``dirt_tpu`` calls XLA's ``lax.cummax``
(``dirt_tpu/ops/binning.py:514, :515, :626, :701, :702``). No Pallas kernel
stands behind it, so this kernel replaces none: it replaces
``torch.cummax``, which scans a 1-D array as one row in one block (~3 ns
an element on the H100) and writes an index array nobody reads.

* CUDA tensors launch the hand-written kernel ``csrc/max_scan.cu``: one
  pass with decoupled look-back over tiles of :data:`TILE` elements, each
  element read once and written once. Its bound is bytes alone, 16 B an
  element (5.0 M elements: 0.024 ms at 3.35 TB/s); loads and stores are
  16-byte vectors of neighbouring lanes, and a tile waits only for the
  running maximum of the tiles before it, published in two status words
  a tile that the wrapper zeroes on every call (one memset node in a
  CUDA graph, so every replay starts clean). Max is exact and associative
  on integers, so the result equals ``torch.cummax(x, 0).values`` bit for
  bit on any input, whatever order the tiles finish in.
* CPU tensors take :func:`max_scan_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dirt_tpu_torch.ops import _build
from dirt_tpu_torch.utils import trace

_KERNEL = "max_scan"
# Elements a block scans: THREADS x ITEMS of ``csrc/max_scan.cu``, which
# checks the status words it is handed against it.
TILE = 4096


def max_scan(x):
    """``y[i] = max(x[0], ..., x[i])`` of a contiguous 1-D int64 tensor,
    into a new tensor."""
    if x.dtype != torch.int64 or x.ndim != 1 or not x.is_contiguous():
        raise ValueError(
            f"max_scan: want a contiguous 1-D int64 tensor, got "
            f"{'' if x.is_contiguous() else 'non-contiguous '}{x.dtype} "
            f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return max_scan_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"max_scan: no kernel for device {x.device}")
    return _launch(x)


def max_scan_plain(x):
    """Plain PyTorch version of the scan kernel (any device)."""
    return torch.cummax(x, 0).values


@functools.cache
def _kernel_fn():
    fn = _build.load(_KERNEL).dirt_max_scan
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p])
    return fn


def _launch(x):
    # raster_fwd imports binning, which imports this module.
    from dirt_tpu_torch.ops.raster_fwd import on_device

    out = torch.empty_like(x)
    n = x.shape[0]
    if n == 0:
        return out
    # The tile counter, then a flag and a value a tile.
    words = 1 + 2 * -(-n // TILE)
    status = torch.zeros((words,), dtype=torch.int64, device=x.device)
    fn = _kernel_fn()
    with on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), status.data_ptr(), n, words,
                 stream)
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err}")
    trace.count(f"launch.{_KERNEL}")
    return out
