"""pool_use_pct: the largest share of ``bin_faces_packed``'s pool cap that
any call of the run used, x 100: the registry's device counter
``fill.pool`` (``dirt_tpu_torch/utils/trace.py``), which the binning's
closing marker keeps. The rest of the pool is slack that the binning's
``cummax`` calls still walk. Nothing without a complete window, or where
the counter was never written (a program without it, another engine, or
no card)."""


def read(data):
    if not data["window"].complete():
        return None
    try:
        from dirt_tpu_torch.utils import trace
    except ImportError:
        return None
    share = trace.counters().get("fill.pool")
    return 100.0 * share if share else None
