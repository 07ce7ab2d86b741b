"""dirt_tpu_torch: the PyTorch/CUDA port of dirt_tpu.

A differentiable triangle rasterizer: z-buffered rasterization with
perspective-correct interpolation of any number of attribute channels.
It keeps ``dirt_tpu``'s module layout and names; ``dirt_tpu`` stays the
reference the port's tests hold it to. The package imports torch and
numpy, never jax.

Ported: the packed, the dense and the streaming (CSR) engine,
forward and backward (clipping, triangle setup, binning, and ten CUDA
kernels for sm_90a: the packed raster, the backward's neighbor prologue,
the fused packed backward, the image <-> flat-subtile layout swap, the
dense whole-tile raster, the fused dense backward, the streaming raster,
the fused streaming backward and the two per-face scatters of the
row-sharded backward, each with a plain PyTorch version for CPU tensors),
count-then-allocate caps, the render stack above
them (``core.lighting``, ``core.texture``, ``render.gbuffer``,
``render.deferred``, ``entry``: the flagship step and the multi-chip dry
run), the row-sharded renderer (``parallel.sharding``,
``parallel.group``, ``parallel.multihost``), its overlapped backward
(``parallel.overlap``) and the face-sharded renderer
(``parallel.face_sharding``), OBJ loading (``io``) and the utilities
(``utils``: device timing, the store of honest caps, PPM images, scalar
logging, checkpoints in ``dirt_tpu``'s file layout). Beside the package:
the benchmark's cells (``benchmark/``), the five-config sheet
(``bench_configs_torch.py``), the demos (``demos/torch_demo*.py``), the
profilers and A/B benches (``tools/prof_torch_*.py``, ``tools/bench_*.py``,
sharing ``tools/card_common.py``) and the card tests (the ``cuda`` marker
of ``tests/test_torch_*.py``). Nothing of ``dirt_tpu`` is left to port.
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
