"""tile_cap_use_pct: the largest share of ``bin_faces_csr``'s per-tile cap
that any call of the run used (the fullest tile's run over the cap), x 100:
the registry's device counter ``fill.tile``
(``dirt_tpu_torch/utils/trace.py``), which the binning's closing marker
keeps. Nothing without a complete window, or where the counter was never
written (a program without it, another engine, or no card)."""


def read(data):
    if not data["window"].complete():
        return None
    try:
        from dirt_tpu_torch.utils import trace
    except ImportError:
        return None
    share = trace.counters().get("fill.tile")
    return 100.0 * share if share else None
