"""The least times of the streaming (CSR) engine's two kernels, counted
from the cell's inputs and the reference's covered pixels alone.

K7 is the forward (``dirt_tpu_torch/csrc/raster_fwd_csr.cu``: the cull
boxes, then the strip walk), K8 the fused backward (``csrc/fused_bwd_csr.cu``:
the partial rows, then their reduction onto the faces). The peaks are
``benchmark/roofline.py``'s; the least time is the larger of the bytes over
the bandwidth and the operations over the float32 rate.

Bytes, each read or written once, 4 B a value (float32, int32 ids), for F
faces (the configuration's), C channels and H x W pixels:

* K7 reads each face's plane row, the coefficients of the planes the
  raster evaluates: three edges, the depth and the perspective denominator
  (3 each) and C attributes (3 each), 15 + 3C values; reads the background,
  C a pixel; writes the pixels (C), the face id and the depth of every
  pixel.
* K8 reads every pixel's face id, depth (the silhouette term's front
  pixel), value and cotangent (C each), and each face's planes that its
  cotangent row is the gradient of (the edges, the denominator and the
  attributes, 12 + 3C values); writes that row, 12 + 3C values.

Operations: K7 one coverage and depth test and the perspective-correct
attributes a covered pixel, K8 the interior and silhouette cotangents of a
covered pixel (``roofline.py``'s counts). None of it follows a kernel's
layout: no cull box, CSR run, padding or table column is counted.
"""

from __future__ import annotations

from benchmark.roofline import (
    F32,
    PEAK_BYTES,
    PEAK_FLOPS,
    TEST_FLOPS,
    attr_flops,
    cotangent_flops,
)
from benchmark.trace import is_program_kernel

# The kernels each launch of the two calls runs, by symbol. The box launch
# (``raster_tile.cuh``) is the dense forward's too; a CSR step runs none.
FWD_KERNELS = frozenset({"cull_boxes_kernel", "raster_fwd_csr_kernel"})
BWD_KERNELS = frozenset({"fused_bwd_csr_partial_kernel",
                         "fused_bwd_csr_reduce_kernel"})


def _sizes(cell):
    config = cell.config
    return config["faces"], config["channels"], config["size"] ** 2


def fwd_work(cell, covered: int):
    """(bytes, float32 operations) of K7 on ``cell``'s scene with
    ``covered`` pixels showing a face."""
    faces, channels, pixels = _sizes(cell)
    nbytes = F32 * (faces * (15 + 3 * channels)
                    + pixels * channels + pixels * (channels + 2))
    return nbytes, covered * (TEST_FLOPS + attr_flops(channels))


def bwd_work(cell, covered: int):
    """(bytes, float32 operations) of K8 on ``cell``'s scene."""
    faces, channels, pixels = _sizes(cell)
    nbytes = F32 * (pixels * (2 + 2 * channels)
                    + 2 * faces * (12 + 3 * channels))
    return nbytes, covered * cotangent_flops(channels)


def least_ms(work) -> float:
    nbytes, flops = work
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS) * 1e3


def kernel_ms(window, kernels) -> float:
    """Device ms a step in the operations whose symbol names one of
    ``kernels``."""
    return window.per_step_ms(1e-9 * sum(
        stop - start for name, start, stop, _ in window.ops
        if is_program_kernel(name, kernels)))


def share(data, kernels, work_of):
    """100 x the least time (``work_of(cell, covered)``) over the device
    ms a step in ``kernels``, from a complete traced window; None where the
    window is not complete or ran none of them."""
    window = data["window"]
    if not window.complete():
        return None
    spent = kernel_ms(window, kernels)
    if spent <= 0:
        return None
    return 100.0 * least_ms(work_of(data["cell"], data["covered"])) / spent
