"""torch_op_ms: device ms a step in everything else on the card (PyTorch's,
cub's and cuBLAS's kernels, copies and fills), from a complete traced
window."""


def read(data):
    window = data["window"]
    if not window.complete():
        return None
    return window.per_step_ms(window.seconds(program=False))
