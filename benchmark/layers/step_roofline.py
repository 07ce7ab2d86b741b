"""step_roofline: the step's least time (``benchmark/roofline.py``, from
the cell's inputs and the reference's covered pixels) as a share of the
device's busy time a step, from a complete traced window."""

from benchmark.roofline import least_ms


def read(data):
    window = data["window"]
    busy = window.busy_s()
    if not window.complete() or busy <= 0:
        return None
    return 100.0 * least_ms(data["cell"], data["covered"]) \
        / window.per_step_ms(busy)
