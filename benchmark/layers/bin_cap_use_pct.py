"""bin_cap_use_pct: the largest share of the dense binning's
(``bin_faces``') per-tile cap that any call of the run used (the fullest
tile's raw count over the cap), x 100: the registry's device counter
``fill.bin`` (``dirt_tpu_torch/utils/trace.py``), which the binning's
closing marker keeps. Nothing without a complete window, or where the
counter was never written (a program without it, another engine, or no
card)."""


def read(data):
    if not data["window"].complete():
        return None
    try:
        from dirt_tpu_torch.utils import trace
    except ImportError:
        return None
    share = trace.counters().get("fill.bin")
    return 100.0 * share if share else None
