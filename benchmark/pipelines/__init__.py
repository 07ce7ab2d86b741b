"""Program side of each pipeline: how a scene's parameters reach the port.

A pipeline module gives ``INPUTS`` (the scene arrays it reads), the
shapes of the parameters a mix may set or train (``shape(name, scene)``)
and their values in the configuration's true scene (``true_value(name,
config, scene)``), ``scene(config, arrays, device)`` (the inputs as
float32 tensors on the card), ``clip_vertices(config, scene, params)``
(what ``suggest_raster_config`` counts) and ``render(config, scene,
raster, params)`` -> {"image", "fid", "overflow", "gbuffer"}. The
reference of the same name lies in ``benchmark/reference/``.
"""
