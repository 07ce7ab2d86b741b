"""The plain reference of the benchmark's cells.

Plain PyTorch written from DIRT's semantics (the rules are set out in
``raster.py``), in float64 by default, on whatever device its inputs lie on.
It imports nothing of ``dirt_tpu_torch`` or ``dirt_tpu``: it gets the same
generated inputs as the program and recomputes the camera, the caps-free
raster, the interior and silhouette gradients, the shading and Adam itself.
``prec="tf32"`` computes it instead in float32 with the inputs of every
matrix product rounded to TF32's 10-bit mantissa: the control, which the
comparison must refuse.
"""
