"""clip_ms: mean device ms a replay in the raster op's ``clip`` stage (the
per-face gather and the near-plane clip), from the end of its opening
marker to the start of its closing marker, busy and idle together, summed
over each time the stage ran in the replay; from a complete traced window.
The markers are the port's stage spans (``dirt_tpu_torch/utils/trace.py``);
a program without them, or a window whose replays' markers do not pair up,
reads nothing."""


def read(data):
    window = data["window"]
    if not window.complete():
        return None
    try:
        from dirt_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.span_ms(window.ops, window.launches, "clip")
