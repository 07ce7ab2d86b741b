"""Utilities of dirt_tpu_torch: device timing (``benchtime``), the store of
count-then-allocate configs (``configstore``), PPM images (``image``),
scalar logging (``metrics``), checkpoints (``checkpoint``) and a step run as
one CUDA-graph replay (``graphstep``, the counterpart of ``jax.jit``).

Counterparts of ``dirt_tpu/utils/``; ``compilecache`` (XLA's compilation
cache) has none.
"""
