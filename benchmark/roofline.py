"""The least time of a cell's step, counted from the cell's inputs alone.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores; the
run line carries the card's own power limit beside the share. The least
time is the larger of the bytes over the first and the operations over the
second.

Bytes: each input byte read once and each output byte written once, as the
arrays are stored: the mesh, its attributes and texture, the parameters,
the raster's pixels, face ids and depth, the shaded image where the
pipeline shades; in a fit also the target, the upstream gradient of the
pixels, the parameters' gradients and Adam's two moments read and written.
Operations: those the covered pixels need, a coverage and depth test and
the perspective-correct attributes per covered pixel, and in a fit the
arithmetic of one covered pixel's interior and silhouette cotangents. None
of it follows a kernel's layout, so the same work reads the same whatever
implements it.
"""

from __future__ import annotations

import math

from benchmark.scenes import scene_arrays

PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12
F32 = 4
# One (pixel, face) coverage and depth test.
TEST_FLOPS = 22


def attr_flops(channels: int) -> int:
    """Perspective-correct interpolation of ``channels`` at one pixel."""
    return 6 + 5 * channels


def cotangent_flops(channels: int) -> int:
    """Interior and silhouette cotangents of one covered pixel: the four
    neighbour pairs' crossing tests and edge terms, the denominator and
    each channel's numerator."""
    return 330 + 6 * channels + 12 + 3 * channels


def param_bytes(cell) -> int:
    """Bytes of the parameters a step reads: a fit's trained ones, a
    frame's pose, each at the shape its pipeline gives it in the cell's
    scene (built on the CPU)."""
    scene = cell.pipeline.scene(cell.config, scene_arrays(cell.config), "cpu")
    names = (cell.mix["trained"] if cell.mix["loop"] == "fit" else ["pose"])
    return F32 * sum(math.prod(cell.pipeline.shape(name, scene))
                     for name in names)


def step_work(cell, covered: int):
    """(bytes, float32 operations) of one step of ``cell`` in which
    ``covered`` pixels show a face."""
    config = cell.config
    size, channels = config["size"], config["channels"]
    pixels = size * size
    arrays = scene_arrays(config)
    inputs = sum(arrays[name].nbytes for name in cell.pipeline.INPUTS)
    image = pixels * config.get("image_channels", channels) * F32
    raster_out = pixels * (channels + 2) * F32
    shaded = image if config.get("image_channels", channels) != channels \
        else 0
    params = param_bytes(cell)
    nbytes = inputs + params + raster_out + shaded
    flops = covered * (TEST_FLOPS + attr_flops(channels))
    if cell.mix["loop"] == "fit":
        upstream = pixels * channels * F32
        # The target; the pixels' upstream gradient; the parameters'
        # gradients written, Adam's moments read, moments and parameters
        # written.
        nbytes += image + upstream + 6 * params
        flops += covered * cotangent_flops(channels)
    return nbytes, flops


def least_ms(cell, covered: int) -> float:
    nbytes, flops = step_work(cell, covered)
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS) * 1e3
