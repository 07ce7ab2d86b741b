"""dirt_tpu_torch: the PyTorch/CUDA port of dirt_tpu.

A differentiable triangle rasterizer: z-buffered rasterization with
perspective-correct interpolation of any number of attribute channels.
It keeps ``dirt_tpu``'s module layout and names; ``dirt_tpu`` stays the
reference the port's tests hold it to. The package imports torch and
numpy, never jax.

Ported so far: the packed and the dense engine, forward and backward
(clipping, triangle setup, binning, and five CUDA kernels for sm_90a: the
packed raster, the backward's neighbor prologue, the fused packed
backward, the dense whole-tile raster and the fused dense backward, each
with a plain PyTorch version for CPU tensors), count-then-allocate caps,
and the render stack above them (``core.lighting``, ``core.texture``,
``render.gbuffer``, ``render.deferred``).
"""

from dirt_tpu_torch.ops.raster import RasterConfig
from dirt_tpu_torch.rasterise_ops import (
    rasterise,
    rasterise_batch,
    rasterise_with_aux,
    suggest_raster_config,
)

__all__ = [
    "rasterise",
    "rasterise_batch",
    "rasterise_with_aux",
    "suggest_raster_config",
    "RasterConfig",
]
__version__ = "0.1.0"
