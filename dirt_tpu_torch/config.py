"""Global configuration for dirt_tpu_torch.

There is no interpreter switch here (``dirt_tpu.config.use_interpret`` has
no counterpart): every kernel wrapper takes its plain PyTorch version for
tensors on the CPU and launches its CUDA kernel, or raises, for tensors on
a CUDA device. Nothing swaps one for the other.
"""

from __future__ import annotations

# Default image-space tile size for the raster kernels. The packed engine
# needs a 128-wide tile (8 lane groups of 16 columns) and at most 8 strips
# of 8 rows; ``RasterConfig.concrete`` picks 64 rows at >= 512 px height.
TILE_H = 32
TILE_W = 128

# Default cap on the number of triangles binned to a single tile (the dense
# and CSR engines' static bins; kept for ``RasterConfig`` parity).
DEFAULT_BIN_CAP = 1024
