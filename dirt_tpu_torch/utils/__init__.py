"""Utilities of dirt_tpu_torch: device timing (``benchtime``), the store of
count-then-allocate configs (``configstore``), PPM images (``image``),
scalar logging (``metrics``) and checkpoints (``checkpoint``).

Counterparts of ``dirt_tpu/utils/``; ``compilecache`` (XLA's compilation
cache) has none.
"""
