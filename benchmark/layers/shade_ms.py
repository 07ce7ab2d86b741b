"""shade_ms: mean device ms a replay in the port's ``shade`` spans (each
call of ``core/lighting.py``'s ``vertex_normals``, ``diffuse_directional``
and ``specular_directional``), from the end of each opening marker to the
start of its closing marker, busy and idle together, summed over the calls
in the replay; from a complete traced window. The markers are the port's
spans (``dirt_tpu_torch/utils/trace.py``); a program without the ``shade``
span, or a window whose replays' markers do not pair up, reads nothing."""


def read(data):
    window = data["window"]
    if not window.complete():
        return None
    try:
        from dirt_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.span_ms(window.ops, window.launches, "shade")
