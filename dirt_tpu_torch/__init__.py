"""dirt_tpu_torch: the PyTorch/CUDA port of dirt_tpu.

A differentiable triangle rasterizer: z-buffered rasterization with
perspective-correct interpolation of any number of attribute channels.
It keeps ``dirt_tpu``'s module layout and names; ``dirt_tpu`` stays the
reference the port's tests hold it to. The package imports torch and
numpy, never jax.

Ported so far: the packed engine's forward path (clipping, triangle setup,
packed binning, the packed raster kernel in CUDA for sm_90a with a plain
PyTorch version for CPU tensors) and count-then-allocate caps.
"""

from dirt_tpu_torch.ops.raster import RasterConfig
from dirt_tpu_torch.rasterise_ops import (
    rasterise,
    rasterise_with_aux,
    suggest_raster_config,
)

__all__ = [
    "rasterise",
    "rasterise_with_aux",
    "suggest_raster_config",
    "RasterConfig",
]
__version__ = "0.1.0"
