"""The benchmark of dirt_tpu_torch on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root of the repo names the cells. Everything that
belongs to one configuration, traffic mix, loop kind, pipeline, per-layer
metric or cell sits in a file of its own here, found by that name:

* ``configs/<config>.json``: the scene (mesh generator and sizes,
  resolution, channels, camera, pipeline, source, what was assumed);
* ``traffic/<mix>.json``: the loop kind and its parameters;
* ``loops/<kind>.py``: one loop kind (``fit``, ``render``);
* ``pipelines/<pipeline>.py``: how a scene's parameters reach the port's
  public API (the program side), and ``reference/<pipeline>.py``: the same
  scene in plain PyTorch (the reference side);
* ``layers/<metric>.py``: the reader of one per-layer metric;
* ``limits/<cell>.json``: the limits of the numbers that decide ``correct``.

The harness talks to the port only through ``dirt_tpu_torch.rasterise``,
``rasterise_with_aux``, ``suggest_raster_config``,
``dirt_tpu_torch.entry.deferred_render``, ``dirt_tpu_torch.core.lighting``
(the ``lit`` pipeline's shading),
``dirt_tpu_torch.utils.graphstep.GraphedStep`` and
``dirt_tpu_torch.utils.trace`` (the spans and fills that the readers under
``layers/`` read); ``reference/`` imports nothing of the port.

A parameter that only a pipeline's per-pixel shading reads, such as a
texture sampled at the rasterised UVs, needs new files alone: the
reference differentiates the shading exactly and the raster by DIRT's rule
(``reference/steps.py``), and the roofline counts every parameter at the
shape its pipeline gives it (``roofline.py``).
"""
