"""texture_ms: mean device ms a replay in the port's ``texture`` spans
(each call of ``core/texture.py``'s ``sample_texture``: the bilinear
lookup's four corner gathers and their blend), from the end of each
opening marker to the start of its closing marker, busy and idle together,
summed over the calls in the replay; from a complete traced window. The
markers are the port's spans (``dirt_tpu_torch/utils/trace.py``); a
program without the ``texture`` span, or a window whose replays' markers do
not pair up, reads nothing."""


def read(data):
    window = data["window"]
    if not window.complete():
        return None
    try:
        from dirt_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.span_ms(window.ops, window.launches, "texture")
