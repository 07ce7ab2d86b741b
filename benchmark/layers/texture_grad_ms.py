"""texture_grad_ms: mean device ms a replay in the port's ``texture_grad``
spans (the texture gradient's scatter in ``core/texture.py``'s backward:
one zeroed buffer and the four corners' ``index_add_``), from the end of
each opening marker to the start of its closing marker, busy and idle
together, summed over the calls in the replay; from a complete traced
window. A program without the span, a texture that needs no gradient, or a
window whose replays' markers do not pair up, reads nothing."""


def read(data):
    window = data["window"]
    if not window.complete():
        return None
    try:
        from dirt_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.span_ms(window.ops, window.launches, "texture_grad")
